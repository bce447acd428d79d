"""ColumnProfilerRunner: the fluent builder of a profiling run.

Counterpart of ``deequ_tpu/profiles/runner.py``.
"""

from __future__ import annotations

from typing import Optional, Sequence

from deequ_tpu_torch.data.table import Dataset
from deequ_tpu_torch.engine.scan import AnalysisEngine
from deequ_tpu_torch.profiles.profiler import (
    DEFAULT_LOW_CARDINALITY_THRESHOLD,
    ColumnProfiler,
    ColumnProfiles,
)
from deequ_tpu_torch.sketches.kll import KLLParameters


class ColumnProfilerRunner:
    def on_data(self, data: Dataset) -> "ColumnProfilerRunBuilder":
        return ColumnProfilerRunBuilder(data)


class ColumnProfilerRunBuilder:
    def __init__(self, data: Dataset):
        self._data = data
        self._restrict_to_columns: Optional[Sequence[str]] = None
        self._low_cardinality_threshold = DEFAULT_LOW_CARDINALITY_THRESHOLD
        self._kll_profiling = False
        self._kll_parameters: Optional[KLLParameters] = None
        self._engine: Optional[AnalysisEngine] = None

    def restrict_to_columns(self, columns: Sequence[str]) -> "ColumnProfilerRunBuilder":
        self._restrict_to_columns = list(columns)
        return self

    def with_low_cardinality_histogram_threshold(
        self, threshold: int
    ) -> "ColumnProfilerRunBuilder":
        self._low_cardinality_threshold = threshold
        return self

    def with_kll_profiling(
        self, kll_parameters: Optional[KLLParameters] = None
    ) -> "ColumnProfilerRunBuilder":
        self._kll_profiling = True
        self._kll_parameters = kll_parameters
        return self

    def with_engine(self, engine: AnalysisEngine) -> "ColumnProfilerRunBuilder":
        self._engine = engine
        return self

    def run(self) -> ColumnProfiles:
        return ColumnProfiler.profile(
            self._data,
            restrict_to_columns=self._restrict_to_columns,
            low_cardinality_histogram_threshold=self._low_cardinality_threshold,
            kll_profiling=self._kll_profiling,
            kll_parameters=self._kll_parameters,
            engine=self._engine,
        )
