"""Holt-Winters seasonal anomaly detection.

Reference: ``anomalydetection/seasonal/HoltWinters.scala`` (SURVEY.md
§2.5): additive triple exponential smoothing, trained on history, then
forecasting the search interval; a point is anomalous when the forecast
error exceeds a bound derived from the training residuals. The reference
tunes (alpha, beta, gamma) with a derivative-free optimizer (BOBYQA);
here a coarse-to-fine grid search over the smoothing parameters plays
that role — same model, same anomaly rule.

A numpy copy of ``deequ_tpu/anomalydetection/seasonal.py``; the port keeps
its own, as it imports nothing of the JAX package.
"""

from __future__ import annotations

import enum
import itertools
import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from deequ_tpu_torch.anomalydetection.base import Anomaly, AnomalyDetectionStrategy
from deequ_tpu_torch.anomalydetection.strategies import _resolve_interval


class MetricInterval(enum.Enum):
    DAILY = "Daily"
    MONTHLY = "Monthly"


class SeriesSeasonality(enum.Enum):
    WEEKLY = "Weekly"
    YEARLY = "Yearly"


def _period(interval: MetricInterval, seasonality: SeriesSeasonality) -> int:
    if (interval, seasonality) == (MetricInterval.DAILY, SeriesSeasonality.WEEKLY):
        return 7
    if (interval, seasonality) == (MetricInterval.MONTHLY, SeriesSeasonality.YEARLY):
        return 12
    if (interval, seasonality) == (MetricInterval.DAILY, SeriesSeasonality.YEARLY):
        return 365
    raise ValueError(
        f"unsupported interval/seasonality combination: "
        f"{interval}/{seasonality}"
    )


class SeasonalityModel(enum.Enum):
    ADDITIVE = "Additive"
    MULTIPLICATIVE = "Multiplicative"


def _holt_winters_additive(
    series: np.ndarray, period: int, alpha: float, beta: float, gamma: float
) -> Tuple[np.ndarray, float, float, np.ndarray]:
    """One smoothing pass; returns (fitted one-step forecasts, final
    level, final trend, final season array)."""
    n = len(series)
    seasons = series[:period] - series[:period].mean()
    level = float(series[:period].mean())
    trend = float(
        (series[period : 2 * period].mean() - series[:period].mean()) / period
    ) if n >= 2 * period else 0.0
    season = seasons.astype(float).copy()
    fitted = np.empty(n)
    for i in range(n):
        s = season[i % period]
        fitted[i] = level + trend + s
        value = series[i]
        new_level = alpha * (value - s) + (1 - alpha) * (level + trend)
        trend = beta * (new_level - level) + (1 - beta) * trend
        season[i % period] = gamma * (value - new_level) + (1 - gamma) * s
        level = new_level
    return fitted, level, trend, season


def _holt_winters_multiplicative(
    series: np.ndarray, period: int, alpha: float, beta: float, gamma: float
) -> Tuple[np.ndarray, float, float, np.ndarray]:
    """Multiplicative-seasonality variant (reference:
    seasonal/HoltWinters MultiplicativeSeasonality): season is a FACTOR
    on the level, appropriate when seasonal swing scales with the
    series magnitude. Requires a positive series."""
    n = len(series)
    base = float(series[:period].mean())
    if base == 0:
        base = 1e-12
    season = (series[:period] / base).astype(float).copy()
    level = base
    trend = float(
        (series[period : 2 * period].mean() - series[:period].mean()) / period
    ) if n >= 2 * period else 0.0
    fitted = np.empty(n)
    for i in range(n):
        s = season[i % period]
        fitted[i] = (level + trend) * s
        value = series[i]
        safe_s = s if s != 0 else 1e-12
        new_level = alpha * (value / safe_s) + (1 - alpha) * (level + trend)
        trend = beta * (new_level - level) + (1 - beta) * trend
        safe_level = new_level if new_level != 0 else 1e-12
        season[i % period] = gamma * (value / safe_level) + (1 - gamma) * s
        level = new_level
    return fitted, level, trend, season


def _forecast(
    level: float,
    trend: float,
    season: np.ndarray,
    start: int,
    steps: int,
    period: int,
    multiplicative: bool = False,
) -> np.ndarray:
    if multiplicative:
        return np.array(
            [
                (level + (h + 1) * trend) * season[(start + h) % period]
                for h in range(steps)
            ]
        )
    return np.array(
        [
            level + (h + 1) * trend + season[(start + h) % period]
            for h in range(steps)
        ]
    )


@dataclass
class HoltWinters(AnomalyDetectionStrategy):
    metric_interval: MetricInterval = MetricInterval.DAILY
    seasonality: SeriesSeasonality = SeriesSeasonality.WEEKLY
    model: SeasonalityModel = SeasonalityModel.ADDITIVE

    def _smooth(self, train, period, a, b, g):
        if self.model == SeasonalityModel.MULTIPLICATIVE:
            return _holt_winters_multiplicative(train, period, a, b, g)
        return _holt_winters_additive(train, period, a, b, g)

    def _fit(
        self, train: np.ndarray, period: int
    ) -> Tuple[Tuple[float, float, float], float]:
        """Coarse-to-fine grid search minimizing in-sample MSE."""
        best = (0.3, 0.1, 0.1)
        best_mse = math.inf
        grid = [0.05, 0.2, 0.4, 0.6, 0.8, 0.95]
        for a, b, g in itertools.product(grid, grid, grid):
            fitted, *_ = self._smooth(train, period, a, b, g)
            mse = float(np.mean((fitted - train) ** 2))
            if mse < best_mse:
                best_mse, best = mse, (a, b, g)
        # refine around the winner
        a0, b0, g0 = best
        fine = lambda c: [max(0.01, c - 0.1), c, min(0.99, c + 0.1)]
        for a, b, g in itertools.product(fine(a0), fine(b0), fine(g0)):
            fitted, *_ = self._smooth(train, period, a, b, g)
            mse = float(np.mean((fitted - train) ** 2))
            if mse < best_mse:
                best_mse, best = mse, (a, b, g)
        return best, best_mse

    def detect(self, values, search_interval=None):
        values = np.asarray(values, dtype=float)
        n = len(values)
        period = _period(self.metric_interval, self.seasonality)
        lo, hi = _resolve_interval(n, search_interval)
        if lo < 2 * period:
            raise ValueError(
                f"Holt-Winters requires at least two full periods "
                f"({2 * period} points) of history before the search "
                f"interval, got {lo}"
            )
        if (
            self.model == SeasonalityModel.MULTIPLICATIVE
            and np.any(values[:lo] <= 0)
        ):
            # only the TRAINING slice is divided by; a zero inside the
            # search interval is a candidate anomaly, not a model error
            raise ValueError(
                "multiplicative Holt-Winters requires a positive "
                "training series"
            )
        train = values[:lo]
        (a, b, g), _ = self._fit(train, period)
        fitted, level, trend, season = self._smooth(train, period, a, b, g)
        residual_sd = float(np.std(train - fitted))
        forecasts = _forecast(
            level, trend, season, lo, hi - lo, period,
            multiplicative=self.model == SeasonalityModel.MULTIPLICATIVE,
        )
        bound = 1.96 * residual_sd
        out: List[Tuple[int, Anomaly]] = []
        for offset, i in enumerate(range(lo, hi)):
            error = values[i] - forecasts[offset]
            if abs(error) > bound:
                out.append(
                    (
                        i,
                        Anomaly(
                            float(values[i]),
                            1.0,
                            f"[HoltWinters]: forecast {forecasts[offset]}, "
                            f"observed {values[i]}, error {error} beyond "
                            f"±{bound}",
                        ),
                    )
                )
        return out
