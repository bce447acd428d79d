"""Anomaly detection over metric time series.

Reference: ``src/main/scala/com/amazon/deequ/anomalydetection/``
(SURVEY.md §2.5): ``AnomalyDetectionStrategy.detect(Vector[DataPoint])``
+ ``AnomalyDetector.isNewPointAnomalous(history, newPoint)``. Pure
host-side numerics over small series — engine-free by design, exactly as
in the reference (L10 sits on the repository, never on data).

A numpy copy of ``deequ_tpu/anomalydetection/base.py``; the port keeps
its own, as it imports nothing of the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np


@dataclass(frozen=True)
class DataPoint:
    time: int  # epoch millis (ResultKey.dataset_date)
    metric_value: Optional[float]


@dataclass(frozen=True)
class Anomaly:
    value: Optional[float]
    confidence: float
    detail: Optional[str] = None


@dataclass
class DetectionResult:
    anomalies: List[Tuple[int, Anomaly]] = field(default_factory=list)

    @property
    def is_anomalous(self) -> bool:
        return len(self.anomalies) > 0


class AnomalyDetectionStrategy:
    """detect(values, search_interval) -> [(index, Anomaly), ...]"""

    def detect(
        self,
        values: Sequence[float],
        search_interval: Optional[Tuple[int, int]] = None,
    ) -> List[Tuple[int, Anomaly]]:
        raise NotImplementedError


@dataclass
class AnomalyDetector:
    """Orders history by time and asks the strategy about the new point
    (reference: AnomalyDetector.scala)."""

    strategy: AnomalyDetectionStrategy

    def detect_anomalies_in_history(
        self,
        data_points: Sequence[DataPoint],
        search_interval: Optional[Tuple[int, int]] = None,
    ) -> DetectionResult:
        ordered = sorted(
            (p for p in data_points if p.metric_value is not None),
            key=lambda p: p.time,
        )
        values = np.asarray([p.metric_value for p in ordered], dtype=float)
        if search_interval is None:
            search = None
        else:
            lo, hi = search_interval
            search = (
                sum(1 for p in ordered if p.time < lo),
                sum(1 for p in ordered if p.time < hi),
            )
        found = self.strategy.detect(values, search)
        return DetectionResult(
            [(ordered[i].time, a) for i, a in found]
        )

    def is_new_point_anomalous(
        self,
        history: Sequence[DataPoint],
        new_point: DataPoint,
    ) -> DetectionResult:
        if new_point.metric_value is None:
            raise ValueError("new point must carry a metric value")
        history = [p for p in history if p.time < new_point.time]
        all_points = list(history) + [new_point]
        return self.detect_anomalies_in_history(
            all_points, (new_point.time, new_point.time + 1)
        )
