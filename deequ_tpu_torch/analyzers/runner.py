"""AnalysisRunner: the entry point that plans and runs the fused pass.

Counterpart of ``deequ_tpu/analyzers/runner.py``: dedup analyzers, check
preconditions (failures become failure metrics immediately), fuse every
scan-shareable analyzer AND every dense or collector frequency plan of
the grouping analyzers into ONE pass, finalize the spill plans after it
(every sort dispatched before one fetch), answer the schema-only ones
(``compute_directly``) without a scan, and assemble an
``AnalyzerContext``. ``aggregate_with`` (anything with
``load(analyzer)``) merges carried-over states into this run's states,
and ``save_states_with`` (anything with ``persist(analyzer, state)``)
receives them; admission control, metric repositories and the JAX
package's state providers are not part of this package yet. Each run
records its fused pass in ``AnalyzerContext.run_metadata``
(``utils/observe.py``): the wall time up to the pass's fetch, the
grouping planner's events and the scan's phase seconds (a
``scan_phases`` event: upload, scan, host fold).
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

from deequ_tpu_torch.analyzers.base import (
    Analyzer,
    GroupingAnalyzer,
    MetricCalculationException,
    ScanShareableAnalyzer,
    wrap_if_necessary,
)
from deequ_tpu_torch.data.table import Dataset, Schema
from deequ_tpu_torch.engine.scan import AnalysisEngine
from deequ_tpu_torch.metrics.metric import Metric
from deequ_tpu_torch.utils.observe import RunMetadata
from deequ_tpu_torch.utils.trylike import Try


@dataclass
class AnalyzerContext:
    """Map analyzer -> metric, plus the run's per-pass wall times
    (``run_metadata``; None for a context no run produced)."""

    metric_map: Dict[Analyzer, Metric] = field(default_factory=dict)
    run_metadata: Optional[RunMetadata] = None

    @staticmethod
    def empty() -> "AnalyzerContext":
        return AnalyzerContext({})

    def all_metrics(self) -> List[Metric]:
        return list(self.metric_map.values())

    def metric(self, analyzer: Analyzer) -> Optional[Metric]:
        return self.metric_map.get(analyzer)

    def __add__(self, other: "AnalyzerContext") -> "AnalyzerContext":
        """The union of two contexts (``other``'s metric wins for an
        analyzer in both), with both runs' passes."""
        merged = dict(self.metric_map)
        merged.update(other.metric_map)
        return AnalyzerContext(
            merged,
            run_metadata=RunMetadata.merge_optional(self.run_metadata, other.run_metadata),
        )

    def success_metrics_as_records(
        self, for_analyzers: Optional[Sequence[Analyzer]] = None
    ) -> List[Dict[str, Any]]:
        """Flat records (entity, instance, name, value) for successful
        metrics."""
        records = []
        for analyzer, metric in self.metric_map.items():
            if for_analyzers and analyzer not in for_analyzers:
                continue
            for flat in metric.flatten():
                if flat.value.is_success:
                    records.append(
                        {
                            "entity": flat.entity.value,
                            "instance": flat.instance,
                            "name": flat.name,
                            "value": flat.value.get(),
                        }
                    )
        return records

    def success_metrics_as_json(
        self, for_analyzers: Optional[Sequence[Analyzer]] = None
    ) -> str:
        return json.dumps(self.success_metrics_as_records(for_analyzers), indent=2)


def _dedup(analyzers: Sequence[Analyzer]) -> List[Analyzer]:
    seen = set()
    out = []
    for a in analyzers:
        if a not in seen:
            seen.add(a)
            out.append(a)
    return out


def _merge_fn_for(state: Any):
    """States carry their own dataset-independent merge (monoid)."""
    merge = getattr(type(state), "merge", None)
    if merge is None:
        raise MetricCalculationException(
            f"state type {type(state).__name__} has no merge"
        )
    return merge


def _check_preconditions(analyzer: Analyzer, schema: Schema) -> Optional[BaseException]:
    try:
        for precondition in analyzer.preconditions():
            precondition(schema)
        return None
    except Exception as exc:  # noqa: BLE001
        return wrap_if_necessary(exc)


class AnalysisRunner:
    """Static facade mirroring the reference's AnalysisRunner object."""

    @staticmethod
    def on_data(data: Dataset) -> "AnalysisRunBuilder":
        return AnalysisRunBuilder(data)

    @staticmethod
    def do_analysis_run(
        data: Dataset,
        analyzers: Sequence[Analyzer],
        aggregate_with=None,
        save_states_with=None,
        engine: Optional[AnalysisEngine] = None,
    ) -> AnalyzerContext:
        analyzers = _dedup(analyzers)
        if not analyzers:
            return AnalyzerContext.empty()
        engine = engine or AnalysisEngine()

        passed: List[Analyzer] = []
        metrics: Dict[Analyzer, Metric] = {}
        for analyzer in analyzers:
            exc = _check_preconditions(analyzer, data.schema)
            if exc is not None:
                metrics[analyzer] = analyzer.to_failure_metric(exc)
            else:
                passed.append(analyzer)

        scan_shareable = [a for a in passed if isinstance(a, ScanShareableAnalyzer)]
        grouping = [a for a in passed if isinstance(a, GroupingAnalyzer)]
        metadata = RunMetadata()
        if scan_shareable or grouping:
            # the pass ends in its synchronising fetch, so the host clock
            # around it holds the device's time too
            t0, passes = time.perf_counter(), engine.data_passes
            metrics.update(
                _run_fused_pass(
                    data, scan_shareable, grouping, engine, aggregate_with,
                    save_states_with, metadata.events,
                )
            )
            metadata.record(
                "scan", time.perf_counter() - t0, data.num_rows,
                len(scan_shareable) + len(grouping),
            )
            if engine.data_passes > passes and engine.phase_times is not None:
                metadata.events.append({"event": "scan_phases", **engine.phase_times})
        # schema-only analyzers (ColumnCount): answered without a scan; a
        # raising compute_directly becomes the analyzer's failure metric
        for analyzer in passed:
            if not isinstance(analyzer, (ScanShareableAnalyzer, GroupingAnalyzer)):
                metrics[analyzer] = (
                    Try.of(lambda a=analyzer: a.compute_directly(data))
                    .recover(analyzer.to_failure_metric)
                    .get()
                )
        return AnalyzerContext(metrics, run_metadata=metadata)


@dataclass
class FusedPassPlan:
    """The planned (not yet executed) fused pass: the vectorized scan
    units, the grouping plans (dense specs and spill collectors riding
    the scan, deferred plans running after it), the combined ``(adapter,
    ops)`` scan pairs, and the failure metrics planning already
    produced."""

    metrics: Dict[Analyzer, Metric]
    units: List[Any]
    by_plan: Dict[Any, List[Analyzer]] = field(default_factory=dict)
    dense: List[Any] = field(default_factory=list)
    collectors: List[Any] = field(default_factory=list)
    deferred: Dict[Any, Any] = field(default_factory=dict)
    scan_pairs: List[Tuple[Any, Any]] = field(default_factory=list)

    @property
    def empty(self) -> bool:
        return not self.scan_pairs and not self.deferred


def _plan_fused_pass(
    data: Dataset,
    analyzers: List[ScanShareableAnalyzer],
    grouping: List[GroupingAnalyzer],
    engine: AnalysisEngine,
    events: Optional[List[dict]] = None,
) -> FusedPassPlan:
    """Vectorize the scan-shareable analyzers, plan the grouping
    frequency passes, and assemble the scan pairs. Per-analyzer plan
    failures become failure metrics here without aborting the pass; a
    failure of the grouping planner fails the grouping family."""
    from deequ_tpu_torch.analyzers.grouping import (
        FrequencyScanAdapter,
        plan_frequency_passes,
        plans_for,
    )
    from deequ_tpu_torch.engine.vectorize import plan_scan_units

    units, plan_failures = plan_scan_units(data, analyzers)
    metrics: Dict[Analyzer, Metric] = {
        analyzer: analyzer.to_failure_metric(exc)
        for analyzer, exc in plan_failures.items()
    }
    by_plan = plans_for(grouping)
    dense, collectors, deferred = [], [], {}
    if by_plan:
        try:
            dense, collectors, deferred = plan_frequency_passes(
                data, list(by_plan), engine, events
            )
        except Exception as exc:  # noqa: BLE001
            for group in by_plan.values():
                for analyzer in group:
                    metrics[analyzer] = analyzer.to_failure_metric(exc)
            by_plan, dense, collectors, deferred = {}, [], [], {}
    scan_pairs = (
        [(unit, unit.ops) for unit in units]
        + [(FrequencyScanAdapter(spec.requests), spec.ops) for spec in dense]
        + [(FrequencyScanAdapter(spec.requests), spec.ops) for spec in collectors]
    )
    return FusedPassPlan(
        metrics=metrics, units=units, by_plan=by_plan, dense=dense,
        collectors=collectors, deferred=deferred, scan_pairs=scan_pairs,
    )


def _run_fused_pass(
    data: Dataset,
    analyzers: List[ScanShareableAnalyzer],
    grouping: List[GroupingAnalyzer],
    engine: AnalysisEngine,
    aggregate_with,
    save_states_with,
    events: Optional[List[dict]] = None,
) -> Dict[Analyzer, Metric]:
    pass_plan = _plan_fused_pass(data, analyzers, grouping, engine, events)
    if pass_plan.empty:
        return pass_plan.metrics
    return _execute_fused_pass(
        pass_plan, data, engine, aggregate_with, save_states_with
    )


def _execute_fused_pass(
    pass_plan: FusedPassPlan,
    data: Dataset,
    engine: AnalysisEngine,
    aggregate_with,
    save_states_with,
) -> Dict[Analyzer, Metric]:
    """Run the one shared scan, slice each member's state out of its
    unit, merge carried-over states, finalize metrics; then the grouping
    finalize: dense states from the scan, every collector's sort
    dispatched before one fetch, the deferred plans. A failed scan fails
    every unit and dense plan it carried, as metrics, and sends each
    collector to its deferred re-read; a grouping plan's failure fails
    only that plan's analyzers."""
    from deequ_tpu_torch.analyzers.grouping import (
        finalize_collector_states,
        finalize_dense_states,
        finalize_grouping_metrics,
    )

    metrics = pass_plan.metrics
    units = pass_plan.units
    dense = pass_plan.dense
    collectors = pass_plan.collectors
    deferred = dict(pass_plan.deferred)
    states = None
    if pass_plan.scan_pairs:
        try:
            states = engine.run_scan(data, pass_plan.scan_pairs)
        except Exception as exc:  # noqa: BLE001 — failures are metrics
            wrapped = wrap_if_necessary(exc)
            for unit in units:
                for analyzer in unit.members:
                    metrics[analyzer] = analyzer.to_failure_metric(wrapped)
            for spec in dense:
                for analyzer in pass_plan.by_plan.get(spec.plan, []):
                    metrics[analyzer] = analyzer.to_failure_metric(wrapped)
            dense = []
            for spec in collectors:
                deferred[spec.plan] = spec.scan_fallback
            collectors = []

    if states is not None:
        for unit, unit_state in zip(units, states):
            for member_idx, analyzer in enumerate(unit.members):
                try:
                    if unit.extract is not None:
                        state = unit.extract(unit_state, member_idx)
                        merge = _merge_fn_for(state)
                    else:
                        state = unit_state
                        merge = unit.ops.merge
                    if aggregate_with is not None:
                        prior = aggregate_with.load(analyzer)
                        if prior is not None:
                            state = merge(state, prior)
                    if save_states_with is not None:
                        save_states_with.persist(analyzer, state)
                    metrics[analyzer] = analyzer.compute_metric_from_state(state)
                except Exception as exc:  # noqa: BLE001
                    metrics[analyzer] = analyzer.to_failure_metric(exc)

    frequencies: Dict[Any, Any] = {}
    if states is not None:
        offset = len(units)
        for spec, state in zip(dense, states[offset:offset + len(dense)]):
            try:
                frequencies.update(finalize_dense_states([spec], [state]))
            except Exception as exc:  # noqa: BLE001
                frequencies[spec.plan] = exc
        offset += len(dense)
        if collectors:
            frequencies.update(
                finalize_collector_states(
                    collectors, states[offset:offset + len(collectors)], engine,
                    isolate=True,
                )
            )
    for plan, run in deferred.items():
        try:
            frequencies[plan] = run()
        except Exception as exc:  # noqa: BLE001
            frequencies[plan] = exc
    grouped = {
        plan: group for plan, group in pass_plan.by_plan.items() if plan in frequencies
    }
    if grouped:
        metrics.update(
            finalize_grouping_metrics(grouped, frequencies, aggregate_with, save_states_with)
        )
    return metrics


class AnalysisRunBuilder:
    def __init__(self, data: Dataset):
        self._data = data
        self._analyzers: List[Analyzer] = []
        self._engine: Optional[AnalysisEngine] = None
        self._aggregate_with = None
        self._save_states_with = None

    def add_analyzer(self, analyzer: Analyzer) -> "AnalysisRunBuilder":
        self._analyzers.append(analyzer)
        return self

    def add_analyzers(self, analyzers: Sequence[Analyzer]) -> "AnalysisRunBuilder":
        self._analyzers.extend(analyzers)
        return self

    def with_engine(self, engine: AnalysisEngine) -> "AnalysisRunBuilder":
        self._engine = engine
        return self

    def aggregate_with(self, state_loader) -> "AnalysisRunBuilder":
        self._aggregate_with = state_loader
        return self

    def save_states_with(self, state_persister) -> "AnalysisRunBuilder":
        self._save_states_with = state_persister
        return self

    def run(self) -> AnalyzerContext:
        return AnalysisRunner.do_analysis_run(
            self._data,
            self._analyzers,
            aggregate_with=self._aggregate_with,
            save_states_with=self._save_states_with,
            engine=self._engine,
        )
