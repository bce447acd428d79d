"""Column profiling: every column's profile in up to three passes.

Counterpart of ``deequ_tpu/profiles/profiler.py``, with its passes and
gates:

- PASS 1 — one fused scan over every column: Size, Completeness,
  ApproxCountDistinct, DataType (string columns), the speculative
  histograms of columns whose dictionary or integral range is provably
  small, and the numeric stats (Mean/Max/Min/Sum/StdDev and the 99
  percentiles, plus KLL when asked) of the schema's numeric columns;
- PASS 2 — the numeric stats of string columns whose inferred type is
  numeric, over a numeric copy of just those columns;
- PASS 3 — the histograms of the remaining low-cardinality columns
  (approx distinct count at most the threshold, default 120), in one
  scan.

Each pass is ``AnalysisRunner.do_analysis_run``, so it takes the fused
scan, its K1 entries, the KLL sort and the dense grouping counts, and
one packed fetch.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from deequ_tpu_torch.analyzers import (
    AnalysisRunner,
    AnalyzerContext,
    ApproxCountDistinct,
    ApproxQuantiles,
    Completeness,
    DataType,
    Histogram,
    KLLSketch,
    Maximum,
    Mean,
    Minimum,
    Size,
    StandardDeviation,
    Sum,
)
from deequ_tpu_torch.analyzers.datatype import inferred_kind
from deequ_tpu_torch.data.table import ColumnRequest, Dataset, Kind
from deequ_tpu_torch.engine.scan import AnalysisEngine
from deequ_tpu_torch.metrics.distribution import Distribution
from deequ_tpu_torch.metrics.kll import BucketDistribution
from deequ_tpu_torch.sketches.kll import KLLParameters
from deequ_tpu_torch.utils.observe import RunMetadata

DEFAULT_LOW_CARDINALITY_THRESHOLD = 120
_PERCENTILES = tuple(round(q / 100.0, 2) for q in range(1, 100))


@dataclass
class StandardColumnProfile:
    column: str
    completeness: float
    approximate_num_distinct_values: float
    data_type: Kind
    is_data_type_inferred: bool
    type_counts: Dict[str, int] = field(default_factory=dict)
    histogram: Optional[Distribution] = None


@dataclass
class NumericColumnProfile(StandardColumnProfile):
    mean: Optional[float] = None
    maximum: Optional[float] = None
    minimum: Optional[float] = None
    sum: Optional[float] = None
    std_dev: Optional[float] = None
    approx_percentiles: Optional[List[float]] = None
    kll: Optional[BucketDistribution] = None


@dataclass
class ColumnProfiles:
    profiles: Dict[str, StandardColumnProfile]
    num_records: int
    run_metadata: Optional[RunMetadata] = None
    # engine/deadline.ScanInterruption of a profile that a cancel or a
    # deadline stopped: the passes after it were skipped and their
    # fields are None
    interruption: Optional[object] = None

    def __getitem__(self, column: str) -> StandardColumnProfile:
        return self.profiles[column]


def _speculative_histograms(data: Dataset, columns: Sequence[str], threshold: int) -> List[str]:
    """Columns whose histogram rides pass 1: string and boolean columns
    whose dictionary has at most ``threshold`` entries, and integral
    columns whose value range is narrower than it. Which histograms a
    profile keeps is still the approx-distinct gate."""
    out: List[str] = []
    for c in columns:
        kind = data.schema.kind_of(c)
        if kind in (Kind.STRING, Kind.BOOLEAN):
            try:
                size = data.dictionary_size_within(c, threshold)
            except Exception:  # noqa: BLE001 — an odd column waits for pass 3
                size = None
            if size is not None:
                out.append(c)
        elif kind == Kind.INTEGRAL:
            try:
                bounds = data.integral_range(c)
            except Exception:  # noqa: BLE001
                bounds = None
            if bounds is not None and bounds[1] - bounds[0] < threshold:
                out.append(c)
    return out


class ColumnProfiler:
    @staticmethod
    def profile(
        data: Dataset,
        restrict_to_columns: Optional[Sequence[str]] = None,
        low_cardinality_histogram_threshold: int = DEFAULT_LOW_CARDINALITY_THRESHOLD,
        kll_profiling: bool = False,
        kll_parameters: Optional[KLLParameters] = None,
        engine: Optional[AnalysisEngine] = None,
        deadline=None,
        cancel=None,
    ) -> ColumnProfiles:
        """Profile the columns. ``deadline`` (seconds or a ``RunBudget``)
        and ``cancel`` (a ``CancelToken``) bound the WHOLE profile: its
        passes share one envelope (a budget's clock starts at its first
        use), and a pass that is interrupted skips the passes after it,
        with the record on ``profiles.interruption``."""
        engine = engine or AnalysisEngine()
        if deadline is not None:
            from deequ_tpu_torch import config
            from deequ_tpu_torch.engine.deadline import RunBudget

            if not isinstance(deadline, RunBudget):
                deadline = RunBudget(deadline_s=float(deadline),
                                     stall_s=config.options().batch_stall_seconds or None)
        envelope = dict(engine=engine, deadline=deadline, cancel=cancel)
        # on a mesh, the rank's part of the table (engine/mesh.py)
        data = engine.local_view(data)
        columns = list(restrict_to_columns or data.schema.column_names)
        for c in columns:
            if not data.schema.has_column(c):
                raise KeyError(f"unknown column {c!r}")
        params = kll_parameters or KLLParameters()

        def numeric_analyzers(cols: Sequence[str]) -> List:
            # the percentiles and the KLL sketch share (params, where),
            # so the KLL group sorts each column once for both
            out: List = []
            for c in cols:
                out += [
                    Mean(c), Maximum(c), Minimum(c), Sum(c), StandardDeviation(c),
                    ApproxQuantiles(c, _PERCENTILES, params=params),
                ]
                if kll_profiling:
                    out.append(KLLSketch(c, params))
            return out

        # ---- PASS 1: generic stats, histograms and native numeric stats
        pass1_histograms = _speculative_histograms(
            data, columns, low_cardinality_histogram_threshold
        )
        if engine.mesh_context is not None:
            # ranks with dictionaries of their own may judge a column
            # differently: pass 1 speculates where every rank would
            votes = engine.mesh_context.sync("profile-histograms", pass1_histograms)
            pass1_histograms = [c for c in pass1_histograms if all(c in v for v in votes)]
        pass1: List = [Size()]
        for c in columns:
            pass1 += [Completeness(c), ApproxCountDistinct(c)]
            if data.schema.kind_of(c) == Kind.STRING:
                pass1.append(DataType(c))
        pass1 += [Histogram(c) for c in pass1_histograms]
        pass1 += numeric_analyzers([c for c in columns if data.schema.kind_of(c).is_numeric])
        ctx1 = AnalysisRunner.do_analysis_run(data, pass1, **envelope)
        interruption = ctx1.interruption

        num_records = int(ctx1.metric(Size()).value.get_or_else(0.0))
        completeness: Dict[str, float] = {}
        approx_distinct: Dict[str, float] = {}
        kinds: Dict[str, Kind] = {}
        inferred: Dict[str, bool] = {}
        type_counts: Dict[str, Dict[str, int]] = {}
        for c in columns:
            completeness[c] = float(ctx1.metric(Completeness(c)).value.get_or_else(0.0))
            approx_distinct[c] = float(
                ctx1.metric(ApproxCountDistinct(c)).value.get_or_else(0.0)
            )
            schema_kind = data.schema.kind_of(c)
            kinds[c], inferred[c], type_counts[c] = schema_kind, False, {}
            if schema_kind == Kind.STRING:
                metric = ctx1.metric(DataType(c))
                if metric is not None and metric.value.is_success:
                    kinds[c], inferred[c] = inferred_kind(metric), True
                    type_counts[c] = {
                        k: v.absolute for k, v in metric.value.get().values.items()
                    }

        # ---- PASS 2: the numeric stats of promoted string columns
        promoted = [
            c for c in columns
            if data.schema.kind_of(c) == Kind.STRING
            and kinds[c] in (Kind.INTEGRAL, Kind.FRACTIONAL)
        ]
        ctx2 = ctx1
        metadata = ctx1.run_metadata
        if promoted and interruption is None:
            promoted_ctx = AnalysisRunner.do_analysis_run(
                _cast_string_columns(data, promoted), numeric_analyzers(promoted), **envelope
            )
            ctx2 = ctx1 + promoted_ctx
            metadata = ctx2.run_metadata
            interruption = ctx2.interruption

        # ---- PASS 3: the histograms pass 1 did not speculate on
        histogram_columns = [
            c for c in columns
            if approx_distinct[c] <= low_cardinality_histogram_threshold
            and kinds[c] in (Kind.STRING, Kind.BOOLEAN, Kind.INTEGRAL)
        ]
        pass3_columns = [c for c in histogram_columns if c not in pass1_histograms]
        ctx3 = AnalyzerContext({})
        if pass3_columns and interruption is None:
            ctx3 = AnalysisRunner.do_analysis_run(
                data, [Histogram(c) for c in pass3_columns], **envelope
            )
            metadata = RunMetadata.merge_optional(metadata, ctx3.run_metadata)
            interruption = ctx3.interruption

        # ---- assemble
        profiles: Dict[str, StandardColumnProfile] = {}
        for c in columns:
            histogram = None
            if c in histogram_columns:  # the approx-distinct gate
                source = ctx1 if c in pass1_histograms else ctx3
                metric = source.metric(Histogram(c))
                if metric is not None and metric.value.is_success:
                    histogram = metric.value.get()
            base = dict(
                column=c,
                completeness=completeness[c],
                approximate_num_distinct_values=approx_distinct[c],
                data_type=kinds[c],
                is_data_type_inferred=inferred[c],
                type_counts=type_counts[c],
                histogram=histogram,
            )
            if not kinds[c].is_numeric:
                profiles[c] = StandardColumnProfile(**base)
                continue

            def metric_value(analyzer):
                m = ctx2.metric(analyzer)
                if m is None or m.value.is_failure:
                    return None
                return m.value.get()

            quantiles = metric_value(ApproxQuantiles(c, _PERCENTILES, params=params))
            profiles[c] = NumericColumnProfile(
                **base,
                mean=metric_value(Mean(c)),
                maximum=metric_value(Maximum(c)),
                minimum=metric_value(Minimum(c)),
                sum=metric_value(Sum(c)),
                std_dev=metric_value(StandardDeviation(c)),
                approx_percentiles=(
                    None if quantiles is None else [quantiles[str(q)] for q in _PERCENTILES]
                ),
                kll=metric_value(KLLSketch(c, params)) if kll_profiling else None,
            )
        return ColumnProfiles(profiles, num_records, run_metadata=metadata,
                              interruption=interruption)


def _cast_string_columns(data: Dataset, columns: Sequence[str]) -> Dataset:
    """A float64 dataset of numeric-looking string columns: each
    dictionary entry is parsed once on the host and gathered by code; an
    entry that does not parse, and a null, become null."""
    arrays = {}
    for c in columns:
        dictionary = data.dictionary(c)
        parsed = np.full(len(dictionary) + 1, np.nan)
        for i, v in enumerate(dictionary):
            if v is None:
                continue
            try:
                parsed[i] = float(str(v).strip())
            except ValueError:
                pass
        codes = data.materialize(ColumnRequest(c, "codes"))
        values = parsed[np.where(codes < 0, len(dictionary), codes)]
        arrays[c] = np.ma.array(values, mask=np.isnan(values))
    out = Dataset.from_pydict(arrays)
    # a mesh rank's cast rows are still only its own part of the table
    out.mesh_share = data.mesh_share
    out.shared_dictionaries = data.mesh_share is None
    out.global_num_rows = getattr(data, "global_num_rows", data.num_rows)
    return out
