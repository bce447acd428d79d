"""The anomaly strategies of deequ_tpu_torch against the JAX package.

Both are numpy; the port keeps its own copy. Each strategy, with several
settings, runs over the same seeded series (noise with spikes, drops,
trends, NaN-free and with a search interval) in both packages: the
anomaly indices are equal exactly, each anomaly's value and confidence
within 1e-12 relative, and its detail string exactly. The
``AnomalyDetector`` (history sorting, nulls dropped, the new point) and
Holt-Winters in both seasonal models are held the same way.
"""

import math

import numpy as np
import pytest

from deequ_tpu.anomalydetection import base as rbase
from deequ_tpu.anomalydetection import seasonal as rseason
from deequ_tpu.anomalydetection import strategies as rstrat

from deequ_tpu_torch.anomalydetection import base as tbase
from deequ_tpu_torch.anomalydetection import seasonal as tseason
from deequ_tpu_torch.anomalydetection import strategies as tstrat


def series(seed, n=60, kind="noise"):
    rng = np.random.default_rng(seed)
    x = 100.0 + rng.normal(0, 2, n)
    if kind == "trend":
        x += np.arange(n) * 1.5
    elif kind == "seasonal":
        x = np.tile([1.0, 1.5, 2.0, 1.5, 1.0, 0.5, 0.5], n // 7 + 1)[:n] * 100.0 + rng.normal(0, 1, n)
    x[rng.integers(5, n, 3)] *= rng.choice([0.5, 1.8], 3)
    return list(x)


def assert_found_equal(rf, tf):
    assert [i for i, _ in tf] == [i for i, _ in rf]
    for (_, ra), (_, ta) in zip(rf, tf):
        for field in ("value", "confidence"):
            want, got = getattr(ra, field), getattr(ta, field)
            if want is None or (isinstance(want, float) and math.isnan(want)):
                assert got is None or math.isnan(got), field
            else:
                assert got == pytest.approx(want, rel=1e-12, abs=1e-300), field
        assert ta.detail == ra.detail


STRATEGIES = [
    ("SimpleThresholdStrategy", dict(lower_bound=95.0, upper_bound=105.0)),
    ("SimpleThresholdStrategy", dict(upper_bound=110.0)),
    ("AbsoluteChangeStrategy", dict(max_rate_decrease=-5.0, max_rate_increase=5.0)),
    ("AbsoluteChangeStrategy", dict(max_rate_decrease=-8.0, max_rate_increase=8.0, order=2)),
    ("RelativeRateOfChangeStrategy", dict(max_rate_decrease=0.9, max_rate_increase=1.1)),
    ("RelativeRateOfChangeStrategy", dict(max_rate_increase=1.3, order=2)),
    ("OnlineNormalStrategy", dict()),
    ("OnlineNormalStrategy", dict(lower_deviation_factor=2.0, upper_deviation_factor=None,
                                  ignore_anomalies=False)),
    ("OnlineNormalStrategy", dict(ignore_start_percentage=0.3)),
    ("BatchNormalStrategy", dict()),
    ("BatchNormalStrategy", dict(lower_deviation_factor=None, upper_deviation_factor=1.5,
                                 include_interval=True)),
]


@pytest.mark.parametrize("kind", ["noise", "trend"])
@pytest.mark.parametrize("interval", [None, (20, 60), (40, 45)])
@pytest.mark.parametrize("name, kwargs", STRATEGIES, ids=lambda v: str(v))
def test_strategy_matches_reference(name, kwargs, interval, kind):
    values = series(sum(map(ord, name + kind)), kind=kind)
    if name == "BatchNormalStrategy" and interval is None:
        interval = (30, 60)  # it needs a training prefix
    rf = getattr(rstrat, name)(**kwargs).detect(values, search_interval=interval)
    tf = getattr(tstrat, name)(**kwargs).detect(values, search_interval=interval)
    assert_found_equal(rf, tf)


@pytest.mark.parametrize("model", ["ADDITIVE", "MULTIPLICATIVE"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_holt_winters_matches_reference(model, seed):
    values = series(seed, n=56, kind="seasonal")
    rf = rseason.HoltWinters(
        rseason.MetricInterval.DAILY, rseason.SeriesSeasonality.WEEKLY,
        model=getattr(rseason.SeasonalityModel, model),
    ).detect(values, search_interval=(42, 56))
    tf = tseason.HoltWinters(
        tseason.MetricInterval.DAILY, tseason.SeriesSeasonality.WEEKLY,
        model=getattr(tseason.SeasonalityModel, model),
    ).detect(values, search_interval=(42, 56))
    assert_found_equal(rf, tf)


@pytest.mark.parametrize("bad", [
    ("SimpleThresholdStrategy", dict(lower_bound=2.0, upper_bound=1.0)),
    ("AbsoluteChangeStrategy", dict(order=0)),
    ("OnlineNormalStrategy", dict(lower_deviation_factor=-1.0)),
])
def test_invalid_settings_raise_alike(bad):
    name, kwargs = bad
    with pytest.raises(ValueError) as rexc:
        getattr(rstrat, name)(**kwargs)
    with pytest.raises(ValueError) as texc:
        getattr(tstrat, name)(**kwargs)
    assert str(texc.value) == str(rexc.value)


def test_detector_matches_reference():
    history = [(3, 3.0), (1, 1.0), (2, None), (0, 0.0), (5, 4.0), (4, 3.5)]
    for new in [(6, 13.0), (6, 4.2)]:
        found = []
        for base, strat in ((rbase, rstrat), (tbase, tstrat)):
            detector = base.AnomalyDetector(
                strat.AbsoluteChangeStrategy(max_rate_decrease=-1.5, max_rate_increase=1.5))
            found.append(detector.is_new_point_anomalous(
                [base.DataPoint(t, v) for t, v in history], base.DataPoint(*new)))
        assert found[1].is_anomalous == found[0].is_anomalous
        assert_found_equal(found[0].anomalies, found[1].anomalies)
        rhist = rbase.AnomalyDetector(rstrat.OnlineNormalStrategy()).detect_anomalies_in_history(
            [rbase.DataPoint(t, v) for t, v in enumerate(series(4))])
        thist = tbase.AnomalyDetector(tstrat.OnlineNormalStrategy()).detect_anomalies_in_history(
            [tbase.DataPoint(t, v) for t, v in enumerate(series(4))])
        assert_found_equal(rhist.anomalies, thist.anomalies)
