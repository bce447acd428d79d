"""AnalysisRunner: the entry point that plans and runs the fused pass.

Counterpart of ``deequ_tpu/analyzers/runner.py``: dedup analyzers, check
preconditions (failures become failure metrics immediately), fuse every
scan-shareable analyzer AND every dense or collector frequency plan of
the grouping analyzers into ONE pass, finalize the spill plans after it
(every sort dispatched before one fetch), answer the schema-only ones
(``compute_directly``) without a scan, and assemble an
``AnalyzerContext``. ``aggregate_with`` (anything with
``load(analyzer)``, such as ``io/state_provider.py``'s providers)
merges carried-over states into this run's states, and
``save_states_with`` (anything with ``persist(analyzer, state)``)
receives them. With a metrics repository (``repository/``) a run
reuses the metrics stored under ``reuse_existing_results_for_key``
(scanning only for the rest, or for nothing) and saves its metrics,
appended to those already stored, under
``save_or_append_results_with_key``. ``run_on_aggregated_states``
computes metrics from persisted states alone, with no data.

A run takes ``deadline`` (seconds or a ``RunBudget``) and ``cancel`` (a
``CancelToken``), or ``config.run_deadline_seconds`` and
``batch_stall_seconds``: an interrupt mid-scan still RETURNS a context
with partial metrics and ``context.interruption``, and the deferred
re-reads of an interrupted run do not start. ``config.max_concurrent_
runs`` and ``memory_watermark_bytes`` admit runs in order
(``engine/deadline.py::AdmissionController``); only a run whose
envelope closes while it waits raises. ``context.degradation`` carries
the scans' quarantined batches and retries. A CUDA or kernel error of
the scan that is not memory pressure (``engine/memory.py::
is_device_fault``) propagates: it is a fault of the device or of a
kernel, never a metric. Each run
records its fused pass in ``AnalyzerContext.run_metadata``
(``utils/observe.py``): the wall time up to the pass's fetch, the
grouping planner's events and the scan's phase seconds (a
``scan_phases`` event: upload, scan, host fold).

With a mesh engine (``AnalysisEngine(mesh=...)``, ``engine/mesh.py``)
every rank calls the run with the same arguments: the run plans over the
rank's part of the table (``AnalysisEngine.local_view``), the scan
merges the states once, the grouping plans shuffle or merge by value,
and every rank returns the same metrics. State files and repository
results are written by rank 0 alone (a state whose groups live on the
ranks is gathered by every rank first: ``io/state_provider.py::
MeshStatePersister``). A run's ``scan_phases`` event then names its
placement (``mesh<W>``) and adds the merge's seconds and bytes. A mesh
run takes no deadline or cancel token yet.
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
from deequ_tpu_torch.engine.deadline import ScanInterruption
from deequ_tpu_torch.engine.memory import is_device_fault, oom_probe_of
from deequ_tpu_torch.engine.resilience import ScanDegradation
from deequ_tpu_torch.engine.scan import AnalysisEngine
from deequ_tpu_torch.metrics.metric import Metric
from deequ_tpu_torch.utils.observe import RunMetadata
from deequ_tpu_torch.utils.trylike import Try


@dataclass
class AnalyzerContext:
    """Map analyzer -> metric, plus the run's per-pass wall times
    (``run_metadata``; None for a context no run produced), the scans'
    ``degradation`` (quarantined batches and retries; None for a clean
    run) and the ``interruption`` of a run that a cancel or a deadline
    stopped (its metrics cover the batches scanned before it)."""

    metric_map: Dict[Analyzer, Metric] = field(default_factory=dict)
    run_metadata: Optional[RunMetadata] = None
    degradation: Optional[ScanDegradation] = None
    interruption: Optional[ScanInterruption] = None

    @staticmethod
    def empty() -> "AnalyzerContext":
        return AnalyzerContext({})

    def all_metrics(self) -> List[Metric]:
        return list(self.metric_map.values())

    def metric(self, analyzer: Analyzer) -> Optional[Metric]:
        return self.metric_map.get(analyzer)

    def __add__(self, other: "AnalyzerContext") -> "AnalyzerContext":
        """The union of two contexts (``other``'s metric wins for an
        analyzer in both), with both runs' passes, degradations merged
        and the first interruption."""
        merged = dict(self.metric_map)
        merged.update(other.metric_map)
        return AnalyzerContext(
            merged,
            run_metadata=RunMetadata.merge_optional(self.run_metadata, other.run_metadata),
            degradation=ScanDegradation.merge_optional(self.degradation, other.degradation),
            interruption=ScanInterruption.merge_optional(self.interruption, other.interruption),
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

    def success_metrics_as_dataframe(self, for_analyzers=None):
        """The success metrics as a ``pandas.DataFrame`` of entity,
        instance, name and value (pandas is imported here only)."""
        import pandas as pd

        return pd.DataFrame(
            self.success_metrics_as_records(for_analyzers),
            columns=["entity", "instance", "name", "value"],
        )


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
        metrics_repository=None,
        reuse_existing_results_for_key=None,
        fail_if_results_missing: bool = False,
        save_or_append_results_with_key=None,
        deadline=None,
        cancel=None,
    ) -> AnalyzerContext:
        analyzers = _dedup(analyzers)
        if not analyzers:
            return AnalyzerContext.empty()
        engine = engine or AnalysisEngine()
        from deequ_tpu_torch import config

        if engine.mesh_context is not None:
            opts = config.options()
            if (deadline is not None or cancel is not None or opts.run_deadline_seconds > 0
                    or opts.batch_stall_seconds > 0):
                raise ValueError(
                    "a mesh run takes no deadline, stall bound or cancel token: deadlines "
                    "and cancellation of a mesh scan are not supported yet")
            data = engine.local_view(data)
        from deequ_tpu_torch.engine.deadline import (
            RunBudget,
            admission_controller,
            shutdown_installed,
            shutdown_token,
        )

        opts = config.options()
        # the run's envelope on the engine: the arguments, else what the
        # engine holds (the profiler shares one across its passes), else
        # the config; put back afterwards
        prev_budget, prev_cancel = engine.budget, engine.cancel
        if deadline is not None:
            engine.budget = deadline if isinstance(deadline, RunBudget) else RunBudget(
                deadline_s=float(deadline), stall_s=opts.batch_stall_seconds or None)
        elif engine.budget is None and (opts.run_deadline_seconds > 0
                                        or opts.batch_stall_seconds > 0):
            engine.budget = RunBudget(deadline_s=opts.run_deadline_seconds or None,
                                      stall_s=opts.batch_stall_seconds or None)
        if cancel is not None:
            engine.cancel = cancel
        limit, watermark = opts.max_concurrent_runs, opts.memory_watermark_bytes
        est_bytes = engine.estimated_run_bytes(data) if watermark > 0 else 0
        admitted = False
        try:
            if limit > 0 or (watermark > 0 and est_bytes > 0):
                tokens = [engine.cancel]
                if shutdown_installed():
                    tokens.append(shutdown_token())
                admission_controller().acquire(limit, budget=engine.budget, tokens=tokens,
                                               estimated_bytes=est_bytes,
                                               watermark_bytes=watermark)
                admitted = True
            return AnalysisRunner._do_admitted_run(
                data, analyzers, aggregate_with, save_states_with, engine, metrics_repository,
                reuse_existing_results_for_key, fail_if_results_missing,
                save_or_append_results_with_key,
            )
        finally:
            if admitted:
                admission_controller().release(est_bytes)
            engine.budget, engine.cancel = prev_budget, prev_cancel

    @staticmethod
    def _do_admitted_run(
        data: Dataset,
        analyzers: List[Analyzer],
        aggregate_with,
        save_states_with,
        engine: AnalysisEngine,
        metrics_repository,
        reuse_existing_results_for_key,
        fail_if_results_missing: bool,
        save_or_append_results_with_key,
    ) -> AnalyzerContext:
        # a fresh record for this run; each of its scans merges into it
        engine.reset_degradation()

        # metrics the repository already holds for this key are reused;
        # only the rest are computed
        reused = AnalyzerContext.empty()
        if metrics_repository is not None and reuse_existing_results_for_key is not None:
            existing = metrics_repository.load_by_key(reuse_existing_results_for_key)
            if existing is not None:
                reused = AnalyzerContext({
                    a: m for a, m in existing.analyzer_context.metric_map.items()
                    if a in analyzers
                })
            if fail_if_results_missing and len(reused.metric_map) < len(analyzers):
                missing = [a for a in analyzers if a not in reused.metric_map]
                raise RuntimeError(
                    "Could not find all necessary results in the "
                    f"MetricsRepository, missing: {missing}"
                )

        prepasses = data.prepasses
        passed: List[Analyzer] = []
        metrics: Dict[Analyzer, Metric] = {}
        for analyzer in analyzers:
            if analyzer in reused.metric_map:
                continue
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
                "scan", time.perf_counter() - t0,
                # a mesh rank's pass counts the whole table's rows
                getattr(data, "global_num_rows", data.num_rows),
                len(scan_shareable) + len(grouping),
            )
            if engine.data_passes > passes and engine.phase_times is not None:
                event = {"event": "scan_phases", **engine.phase_times}
                if engine.mesh_context is not None:
                    event["placement"] = engine.placement
                metadata.events.append(event)
        # a parquet source's dictionary pre-passes read the data too
        engine.data_passes += data.prepasses - prepasses
        # schema-only analyzers (ColumnCount): answered without a scan; a
        # raising compute_directly becomes the analyzer's failure metric
        for analyzer in passed:
            if not isinstance(analyzer, (ScanShareableAnalyzer, GroupingAnalyzer)):
                metrics[analyzer] = (
                    Try.of(lambda a=analyzer: a.compute_directly(data))
                    .recover(analyzer.to_failure_metric)
                    .get()
                )
        degradation = engine.last_degradation
        if degradation is not None and not degradation.is_degraded and degradation.retries == 0:
            degradation = None  # a clean run carries no record
        context = reused + AnalyzerContext(metrics, run_metadata=metadata,
                                           degradation=degradation,
                                           interruption=engine.last_interruption)
        on_mesh = engine.mesh_context is not None
        if (metrics_repository is not None and save_or_append_results_with_key is not None
                and (not on_mesh or engine.mesh_context.rank == 0)):
            # every rank holds the same metrics; rank 0 writes them once
            from deequ_tpu_torch.repository.base import AnalysisResult

            current = metrics_repository.load_by_key(save_or_append_results_with_key)
            combined = context if current is None else current.analyzer_context + context
            metrics_repository.save(AnalysisResult(save_or_append_results_with_key, combined))
        return context

    @staticmethod
    def run_on_aggregated_states(
        schema: Schema,
        analyzers: Sequence[Analyzer],
        state_loaders: Sequence[Any],
        save_states_with=None,
    ) -> AnalyzerContext:
        """Metrics from persisted states alone, without the data: each
        analyzer's states from every loader merged (a tree fold, so N
        large frequency states are not re-merged N times), persisted to
        ``save_states_with`` if given, then finalized. An analyzer no
        loader has a state for gets the metric of an empty state; a
        failed precondition, load or merge becomes its failure metric."""
        analyzers = _dedup(analyzers)
        metrics: Dict[Analyzer, Metric] = {}
        for analyzer in analyzers:
            exc = _check_preconditions(analyzer, schema)
            if exc is not None:
                metrics[analyzer] = analyzer.to_failure_metric(exc)
                continue
            try:
                states = [
                    s for loader in state_loaders
                    for s in [loader.load(analyzer)] if s is not None
                ]
                if not states:
                    metrics[analyzer] = analyzer.compute_metric_from_state(None)
                    continue
                merge = _merge_fn_for(states[0])
                while len(states) > 1:
                    states = [
                        merge(states[i], states[i + 1]) if i + 1 < len(states) else states[i]
                        for i in range(0, len(states), 2)
                    ]
                if save_states_with is not None:
                    save_states_with.persist(analyzer, states[0])
                metrics[analyzer] = analyzer.compute_metric_from_state(states[0])
            except Exception as exc:  # noqa: BLE001 — failures are metrics
                metrics[analyzer] = analyzer.to_failure_metric(exc)
        return AnalyzerContext(metrics)


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
    if engine.mesh_context is not None and save_states_with is not None:
        from deequ_tpu_torch.io.state_provider import MeshStatePersister

        save_states_with = MeshStatePersister(save_states_with, engine.mesh_context)
    if pass_plan.empty:
        return pass_plan.metrics
    return _execute_fused_pass(
        pass_plan, data, engine, aggregate_with, save_states_with, events
    )


def _execute_fused_pass(
    pass_plan: FusedPassPlan,
    data: Dataset,
    engine: AnalysisEngine,
    aggregate_with,
    save_states_with,
    events: Optional[List[dict]] = None,
) -> Dict[Analyzer, Metric]:
    """Run the one shared scan, slice each member's state out of its
    unit, merge carried-over states, finalize metrics; then the grouping
    finalize: dense states from the scan, every collector's sort
    dispatched before one fetch, the deferred plans. A failed scan fails
    every unit and dense plan it carried, as metrics, and sends each
    collector to its deferred re-read; a grouping plan's failure fails
    only that plan's analyzers."""
    from deequ_tpu_torch.analyzers.grouping import (
        dense_is_rank_local,
        finalize_collector_states,
        finalize_dense_states,
        finalize_grouping_metrics,
        merge_rank_local,
    )
    from deequ_tpu_torch.engine.mesh import MeshPlanMismatch

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
            if is_device_fault(exc) or isinstance(exc, MeshPlanMismatch):
                # a device or kernel fault fails the run, and so do ranks
                # that planned different scans
                raise
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
        rank_local = dense_is_rank_local(data, engine)
        for spec, state in zip(dense, states[offset:offset + len(dense)]):
            try:
                frequencies.update(finalize_dense_states([spec], [state], rank_local))
            except Exception as exc:  # noqa: BLE001
                frequencies[spec.plan] = exc
        offset += len(dense)
        if collectors:
            frequencies.update(
                finalize_collector_states(
                    collectors, states[offset:offset + len(collectors)], engine,
                    isolate=True, cancel=engine.cancel, oom_probe=oom_probe_of(data),
                    events=events,
                )
            )
    for plan, run in deferred.items():
        interruption = engine.last_interruption
        if interruption is not None:
            # an interrupted run starts no other pass over the source
            frequencies[plan] = MetricCalculationException(
                f"run {interruption.kind} before the deferred frequency pass ran: "
                f"{interruption.reason}")
            continue
        try:
            frequencies[plan] = run()
        except Exception as exc:  # noqa: BLE001
            frequencies[plan] = exc
    # a mesh rank's host group-bys and own-dictionary dense counts, merged
    # with its peers' by value (uniform: every rank reaches this point)
    frequencies = merge_rank_local(frequencies, list(pass_plan.by_plan), engine)
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
        self._repository = None
        self._reuse_key = None
        self._fail_if_results_missing = False
        self._save_key = None
        self._deadline = None
        self._cancel = None

    def add_analyzer(self, analyzer: Analyzer) -> "AnalysisRunBuilder":
        self._analyzers.append(analyzer)
        return self

    def add_analyzers(self, analyzers: Sequence[Analyzer]) -> "AnalysisRunBuilder":
        self._analyzers.extend(analyzers)
        return self

    def with_engine(self, engine: AnalysisEngine) -> "AnalysisRunBuilder":
        self._engine = engine
        return self

    def with_deadline(self, deadline) -> "AnalysisRunBuilder":
        """Bound the run: seconds, or a ``RunBudget``."""
        self._deadline = deadline
        return self

    def with_cancel(self, cancel) -> "AnalysisRunBuilder":
        """A ``CancelToken``: cancelling it stops the scan cleanly, with
        partial metrics and a resumable checkpoint."""
        self._cancel = cancel
        return self

    def aggregate_with(self, state_loader) -> "AnalysisRunBuilder":
        self._aggregate_with = state_loader
        return self

    def save_states_with(self, state_persister) -> "AnalysisRunBuilder":
        self._save_states_with = state_persister
        return self

    def use_repository(self, repository) -> "AnalysisRunBuilder":
        self._repository = repository
        return self

    def reuse_existing_results_for_key(
        self, key, fail_if_results_missing: bool = False
    ) -> "AnalysisRunBuilder":
        self._reuse_key = key
        self._fail_if_results_missing = fail_if_results_missing
        return self

    def save_or_append_result(self, key) -> "AnalysisRunBuilder":
        self._save_key = key
        return self

    def run(self) -> AnalyzerContext:
        return AnalysisRunner.do_analysis_run(
            self._data,
            self._analyzers,
            aggregate_with=self._aggregate_with,
            save_states_with=self._save_states_with,
            engine=self._engine,
            metrics_repository=self._repository,
            reuse_existing_results_for_key=self._reuse_key,
            fail_if_results_missing=self._fail_if_results_missing,
            save_or_append_results_with_key=self._save_key,
            deadline=self._deadline,
            cancel=self._cancel,
        )
