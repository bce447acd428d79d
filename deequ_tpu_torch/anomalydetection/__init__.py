"""Anomaly detection over metric time series (numpy only). The wiring to
a metrics repository (``add_anomaly_check``) waits for the repository."""

from deequ_tpu_torch.anomalydetection.base import (
    Anomaly,
    AnomalyDetectionStrategy,
    AnomalyDetector,
    DataPoint,
    DetectionResult,
)
from deequ_tpu_torch.anomalydetection.seasonal import (
    HoltWinters,
    MetricInterval,
    SeriesSeasonality,
)
from deequ_tpu_torch.anomalydetection.strategies import (
    AbsoluteChangeStrategy,
    BatchNormalStrategy,
    OnlineNormalStrategy,
    RelativeRateOfChangeStrategy,
    SimpleThresholdStrategy,
)

__all__ = [
    "AbsoluteChangeStrategy",
    "Anomaly",
    "AnomalyDetectionStrategy",
    "AnomalyDetector",
    "BatchNormalStrategy",
    "DataPoint",
    "DetectionResult",
    "HoltWinters",
    "MetricInterval",
    "OnlineNormalStrategy",
    "RelativeRateOfChangeStrategy",
    "SeriesSeasonality",
    "SimpleThresholdStrategy",
]
