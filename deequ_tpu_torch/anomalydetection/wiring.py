"""Anomaly checks wired into VerificationSuite through a repository.

Counterpart of ``deequ_tpu/anomalydetection/wiring.py``: a Check whose
one constraint loads the metric's history from the repository and asks
the strategy whether this run's value is anomalous. It reads no data
beyond the metric itself.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

from deequ_tpu_torch.analyzers.base import Analyzer
from deequ_tpu_torch.anomalydetection.base import (
    AnomalyDetectionStrategy,
    AnomalyDetector,
    DataPoint,
)
from deequ_tpu_torch.checks.check import Check, CheckLevel
from deequ_tpu_torch.constraints.constraint import AnalysisBasedConstraint, NamedConstraint


@dataclass
class AnomalyCheckConfig:
    level: CheckLevel = CheckLevel.WARNING
    description: str = "Anomaly check"
    with_tag_values: Dict[str, str] = field(default_factory=dict)
    after_date: Optional[int] = None
    before_date: Optional[int] = None


def build_anomaly_check(
    repository,
    strategy: AnomalyDetectionStrategy,
    analyzer: Analyzer,
    config: AnomalyCheckConfig,
    current_key=None,
) -> Check:
    """The anomaly Check of ``analyzer``'s metric. With ``current_key``
    (the key this run saves under) the new point sits at its date, and
    history at or after it is left out; without one it sits one past
    the newest stored date."""

    def assertion(metric_value: float) -> bool:
        loader = repository.load().for_analyzers([analyzer])
        if config.with_tag_values:
            loader = loader.with_tag_values(config.with_tag_values)
        if config.after_date is not None:
            loader = loader.after(config.after_date)
        if config.before_date is not None:
            loader = loader.before(config.before_date)
        now = current_key.dataset_date if current_key is not None else _max_time(loader) + 1
        history = []
        for result in loader.get():
            if current_key is not None and result.result_key.dataset_date >= now:
                continue  # this run's own (or newer) points
            metric = result.analyzer_context.metric(analyzer)
            if metric is not None and metric.value.is_success:
                history.append(
                    DataPoint(result.result_key.dataset_date, float(metric.value.get()))
                )
        detection = AnomalyDetector(strategy).is_new_point_anomalous(
            history, DataPoint(now, float(metric_value))
        )
        return not detection.is_anomalous

    constraint = NamedConstraint(
        AnalysisBasedConstraint(analyzer, assertion),
        f"AnomalyConstraint({analyzer.name}({analyzer.instance}))",
    )
    return Check(config.level, config.description).add_constraint(constraint)


def _max_time(loader) -> int:
    return max((r.result_key.dataset_date for r in loader.get()), default=0)
