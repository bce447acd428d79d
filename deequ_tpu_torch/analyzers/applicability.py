"""Applicability: can a check, or a list of analyzers, run on a schema?

Counterpart of ``deequ_tpu/analyzers/applicability.py``: a two-row table
of the schema's kinds is synthesized in numpy and every analyzer runs
through the ordinary runner, so precondition failures and planning
failures (a bad predicate, a wrong type) surface as they would on real
data: as failure metrics, reported per constraint or per analyzer.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Dict, Optional, Sequence

import numpy as np

from deequ_tpu_torch.analyzers.base import Analyzer
from deequ_tpu_torch.analyzers.runner import AnalysisRunner
from deequ_tpu_torch.data.table import Dataset, Kind, Schema

if TYPE_CHECKING:  # the checks import the analyzers
    from deequ_tpu_torch.checks.check import Check


def _synthesize_dataset(schema: Schema, num_rows: int = 2) -> Dataset:
    """A tiny table whose columns have the schema's kinds."""
    columns = {}
    for f in schema.fields:
        if f.kind == Kind.INTEGRAL:
            columns[f.name] = np.arange(1, num_rows + 1, dtype=np.int64)
        elif f.kind == Kind.FRACTIONAL:
            columns[f.name] = np.linspace(1.0, 2.0, num_rows).astype(np.float64)
        elif f.kind == Kind.BOOLEAN:
            columns[f.name] = np.arange(num_rows) % 2 == 0
        elif f.kind == Kind.TIMESTAMP:
            columns[f.name] = np.arange(num_rows, dtype=np.int64).astype("datetime64[ms]")
        else:  # STRING / UNKNOWN
            columns[f.name] = [f"v{i}" for i in range(num_rows)]
    return Dataset.from_pydict(columns)


@dataclass
class ApplicabilityResult:
    is_applicable: bool
    # item (constraint repr or analyzer repr) -> None if ok, else reason
    failures: Dict[str, Optional[str]] = field(default_factory=dict)


class Applicability:
    """Evaluates checks and analyzers against a Schema without real data."""

    def is_applicable(self, check: "Check", schema: Schema) -> ApplicabilityResult:
        """Per-constraint applicability of a whole check."""
        data = _synthesize_dataset(schema)
        context = AnalysisRunner.do_analysis_run(data, check.required_analyzers())
        failures: Dict[str, Optional[str]] = {}
        for constraint_result in check.evaluate(context).constraint_results:
            metric = constraint_result.metric
            failures[repr(constraint_result.constraint)] = (
                str(metric.value.exception)
                if metric is not None and metric.value.is_failure
                else None
            )
        return ApplicabilityResult(all(v is None for v in failures.values()), failures)

    def are_applicable(
        self, analyzers: Sequence[Analyzer], schema: Schema
    ) -> ApplicabilityResult:
        """Per-analyzer applicability."""
        data = _synthesize_dataset(schema)
        context = AnalysisRunner.do_analysis_run(data, list(analyzers))
        failures: Dict[str, Optional[str]] = {}
        for analyzer in analyzers:
            metric = context.metric(analyzer)
            if metric is None:
                failures[repr(analyzer)] = "no metric computed"
            elif metric.value.is_failure:
                failures[repr(analyzer)] = str(metric.value.exception)
            else:
                failures[repr(analyzer)] = None
        return ApplicabilityResult(all(v is None for v in failures.values()), failures)
