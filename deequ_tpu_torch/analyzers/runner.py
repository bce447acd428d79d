"""AnalysisRunner: the entry point that plans and runs the fused pass.

Counterpart of ``deequ_tpu/analyzers/runner.py``: dedup analyzers, check
preconditions (failures become failure metrics immediately), fuse every
scan-shareable analyzer into ONE pass, and assemble an
``AnalyzerContext``. ``aggregate_with`` (anything with
``load(analyzer)``) merges carried-over states into this run's states,
and ``save_states_with`` (anything with ``persist(analyzer, state)``)
receives them; admission control, metric repositories and the JAX
package's state providers are not part of this package yet.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

from deequ_tpu_torch.analyzers.base import (
    Analyzer,
    MetricCalculationException,
    ScanShareableAnalyzer,
    wrap_if_necessary,
)
from deequ_tpu_torch.data.table import Dataset, Schema
from deequ_tpu_torch.engine.scan import AnalysisEngine
from deequ_tpu_torch.metrics.metric import Metric


@dataclass
class AnalyzerContext:
    """Map analyzer -> metric."""

    metric_map: Dict[Analyzer, Metric] = field(default_factory=dict)

    @staticmethod
    def empty() -> "AnalyzerContext":
        return AnalyzerContext({})

    def all_metrics(self) -> List[Metric]:
        return list(self.metric_map.values())

    def metric(self, analyzer: Analyzer) -> Optional[Metric]:
        return self.metric_map.get(analyzer)

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

        if passed:
            metrics.update(
                _run_fused_pass(
                    data, passed, engine, aggregate_with, save_states_with
                )
            )
        return AnalyzerContext(metrics)


@dataclass
class FusedPassPlan:
    """The planned (not yet executed) fused pass: the vectorized scan
    units and the failure metrics planning already produced."""

    metrics: Dict[Analyzer, Metric]
    units: List[Any]


def _plan_fused_pass(
    data: Dataset, analyzers: List[ScanShareableAnalyzer]
) -> FusedPassPlan:
    """Vectorize the scan-shareable analyzers. Per-analyzer plan
    failures become failure metrics here without aborting the pass."""
    from deequ_tpu_torch.engine.vectorize import plan_scan_units

    units, plan_failures = plan_scan_units(data, analyzers)
    metrics: Dict[Analyzer, Metric] = {
        analyzer: analyzer.to_failure_metric(exc)
        for analyzer, exc in plan_failures.items()
    }
    return FusedPassPlan(metrics=metrics, units=units)


def _run_fused_pass(
    data: Dataset,
    analyzers: List[ScanShareableAnalyzer],
    engine: AnalysisEngine,
    aggregate_with,
    save_states_with,
) -> Dict[Analyzer, Metric]:
    pass_plan = _plan_fused_pass(data, analyzers)
    if not pass_plan.units:
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
    unit, merge carried-over states, and finalize metrics. A failed scan
    fails every analyzer it carried, as metrics."""
    metrics = pass_plan.metrics
    units = pass_plan.units
    try:
        states = engine.run_scan(data, [(unit, unit.ops) for unit in units])
    except Exception as exc:  # noqa: BLE001 — failures are metrics
        wrapped = wrap_if_necessary(exc)
        for unit in units:
            for analyzer in unit.members:
                metrics[analyzer] = analyzer.to_failure_metric(wrapped)
        return metrics

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
