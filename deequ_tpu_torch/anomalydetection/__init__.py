"""Anomaly detection over metric time series (numpy only), and its
wiring to a metrics repository (``wiring.py``, behind
``VerificationRunBuilder.add_anomaly_check``)."""

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
from deequ_tpu_torch.anomalydetection.wiring import AnomalyCheckConfig

__all__ = [
    "AbsoluteChangeStrategy",
    "Anomaly",
    "AnomalyCheckConfig",
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
