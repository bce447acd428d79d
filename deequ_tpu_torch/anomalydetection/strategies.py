"""Anomaly-detection strategies.

Reference (one file per strategy under ``anomalydetection/``, SURVEY.md
§2.5): SimpleThresholdStrategy, AbsoluteChangeStrategy (nth-order
differences), RelativeRateOfChangeStrategy, BaseChangeStrategy (the
shared diffing base), OnlineNormalStrategy (incremental mean/variance
that can ignore detected anomalies in its estimate),
BatchNormalStrategy. Each is a small numeric algorithm over a series.

A numpy copy of ``deequ_tpu/anomalydetection/strategies.py``; the port keeps
its own, as it imports nothing of the JAX package.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from deequ_tpu_torch.anomalydetection.base import Anomaly, AnomalyDetectionStrategy


def _resolve_interval(
    n: int, search_interval: Optional[Tuple[int, int]]
) -> Tuple[int, int]:
    if search_interval is None:
        return 0, n
    lo, hi = search_interval
    return max(0, lo), min(n, hi)


@dataclass
class SimpleThresholdStrategy(AnomalyDetectionStrategy):
    """Anomalous iff outside [lower_bound, upper_bound]."""

    lower_bound: float = -math.inf
    upper_bound: float = math.inf

    def __post_init__(self):
        if self.lower_bound > self.upper_bound:
            raise ValueError("lower_bound must be <= upper_bound")

    def detect(self, values, search_interval=None):
        values = np.asarray(values, dtype=float)
        lo, hi = _resolve_interval(len(values), search_interval)
        out: List[Tuple[int, Anomaly]] = []
        for i in range(lo, hi):
            v = values[i]
            if v < self.lower_bound or v > self.upper_bound:
                out.append(
                    (
                        i,
                        Anomaly(
                            float(v),
                            1.0,
                            f"[SimpleThresholdStrategy]: {v} not in "
                            f"[{self.lower_bound}, {self.upper_bound}]",
                        ),
                    )
                )
        return out


@dataclass
class _BaseChangeStrategy(AnomalyDetectionStrategy):
    """Shared base for difference/rate strategies (reference:
    BaseChangeStrategy)."""

    max_rate_decrease: float = -math.inf
    max_rate_increase: float = math.inf
    order: int = 1

    def __post_init__(self):
        if self.max_rate_decrease >= self.max_rate_increase:
            raise ValueError(
                "max_rate_decrease must be below max_rate_increase"
            )
        if self.order < 1:
            raise ValueError("order must be >= 1")

    def _transform(self, values: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def detect(self, values, search_interval=None):
        values = np.asarray(values, dtype=float)
        lo, hi = _resolve_interval(len(values), search_interval)
        if len(values) <= self.order:
            return []
        changes = self._transform(values)  # aligned: changes[i] at value i
        out: List[Tuple[int, Anomaly]] = []
        for i in range(max(lo, self.order), hi):
            change = changes[i - self.order]
            if not (self.max_rate_decrease <= change <= self.max_rate_increase):
                out.append(
                    (
                        i,
                        Anomaly(
                            float(values[i]),
                            1.0,
                            f"[{type(self).__name__}]: change {change} not "
                            f"in [{self.max_rate_decrease}, "
                            f"{self.max_rate_increase}]",
                        ),
                    )
                )
        return out


@dataclass
class AbsoluteChangeStrategy(_BaseChangeStrategy):
    """nth-order differences outside the allowed band."""

    def _transform(self, values: np.ndarray) -> np.ndarray:
        return np.diff(values, n=self.order)


@dataclass
class RelativeRateOfChangeStrategy(_BaseChangeStrategy):
    """value[i] / value[i-order] outside the allowed band."""

    def _transform(self, values: np.ndarray) -> np.ndarray:
        denom = values[: len(values) - self.order]
        num = values[self.order :]
        with np.errstate(divide="ignore", invalid="ignore"):
            return num / denom


@dataclass
class OnlineNormalStrategy(AnomalyDetectionStrategy):
    """Incremental (Welford) mean/variance; a point is anomalous if it
    deviates more than factor * stddev; anomalies can be excluded from
    the running estimate (reference: OnlineNormalStrategy)."""

    lower_deviation_factor: Optional[float] = 3.0
    upper_deviation_factor: Optional[float] = 3.0
    ignore_start_percentage: float = 0.1
    ignore_anomalies: bool = True

    def __post_init__(self):
        for f in (self.lower_deviation_factor, self.upper_deviation_factor):
            if f is not None and f < 0:
                raise ValueError("deviation factors must be >= 0")
        if not 0.0 <= self.ignore_start_percentage <= 1.0:
            raise ValueError("ignore_start_percentage must be in [0, 1]")

    def detect(self, values, search_interval=None):
        values = np.asarray(values, dtype=float)
        n = len(values)
        lo, hi = _resolve_interval(n, search_interval)
        warmup = int(math.ceil(n * self.ignore_start_percentage))
        mean, m2, count = 0.0, 0.0, 0
        out: List[Tuple[int, Anomaly]] = []
        for i, v in enumerate(values):
            stddev = math.sqrt(m2 / count) if count > 0 else 0.0
            is_anomaly = False
            if i >= max(warmup, 1) and count > 0:
                upper = (
                    mean + self.upper_deviation_factor * stddev
                    if self.upper_deviation_factor is not None
                    else math.inf
                )
                lower = (
                    mean - self.lower_deviation_factor * stddev
                    if self.lower_deviation_factor is not None
                    else -math.inf
                )
                is_anomaly = v < lower or v > upper
                if is_anomaly and lo <= i < hi:
                    out.append(
                        (
                            i,
                            Anomaly(
                                float(v),
                                1.0,
                                f"[OnlineNormalStrategy]: {v} not in "
                                f"[{lower}, {upper}] (mean={mean}, "
                                f"stdDev={stddev})",
                            ),
                        )
                    )
            if not (is_anomaly and self.ignore_anomalies):
                count += 1
                delta = v - mean
                mean += delta / count
                m2 += delta * (v - mean)
        return out


@dataclass
class BatchNormalStrategy(AnomalyDetectionStrategy):
    """Mean/stddev estimated from the points OUTSIDE the search interval
    (reference: BatchNormalStrategy requires a training split)."""

    lower_deviation_factor: Optional[float] = 3.0
    upper_deviation_factor: Optional[float] = 3.0
    include_interval: bool = False

    def detect(self, values, search_interval=None):
        values = np.asarray(values, dtype=float)
        n = len(values)
        lo, hi = _resolve_interval(n, search_interval)
        if self.include_interval:
            training = values
        else:
            training = np.concatenate([values[:lo], values[hi:]])
        if training.size < 2:
            raise ValueError(
                "BatchNormalStrategy needs at least 2 training points "
                "outside the search interval"
            )
        mean = float(np.mean(training))
        stddev = float(np.std(training))
        upper = (
            mean + self.upper_deviation_factor * stddev
            if self.upper_deviation_factor is not None
            else math.inf
        )
        lower = (
            mean - self.lower_deviation_factor * stddev
            if self.lower_deviation_factor is not None
            else -math.inf
        )
        out: List[Tuple[int, Anomaly]] = []
        for i in range(lo, hi):
            v = values[i]
            if v < lower or v > upper:
                out.append(
                    (
                        i,
                        Anomaly(
                            float(v),
                            1.0,
                            f"[BatchNormalStrategy]: {v} not in "
                            f"[{lower}, {upper}]",
                        ),
                    )
                )
        return out
