"""The port's anomaly checks through a metrics repository
(``deequ_tpu_torch/anomalydetection/wiring.py``,
``VerificationRunBuilder.add_anomaly_check``) against the JAX package.

The flows of ``examples/anomaly_detection.py`` (daily Size into an
in-memory repository, then a truncated day) and of
``examples/production_pipeline.py``'s step 5 (a repository behind a
``mem://`` URI, four days of a table whose volume collapses on day 3)
run through both packages on the same seeded data: every run's overall
status and every check result (check, level, status, constraint,
message) are equal. Sizes are exact, so the comparison is exact.
``add_anomaly_check`` without a repository raises in both.
"""

import uuid

import numpy as np
import pytest

import deequ_tpu as R
from deequ_tpu.anomalydetection.wiring import AnomalyCheckConfig as RConfig

import deequ_tpu_torch as T
from deequ_tpu_torch import config as tconfig
from deequ_tpu_torch.anomalydetection.wiring import AnomalyCheckConfig as TConfig


@pytest.fixture(autouse=True)
def _cpu():
    with tconfig.configure(device="cpu"):
        yield


def _rows(result):
    return [(r["check"], r["check_level"], r["check_status"], r["constraint"],
             r["constraint_status"], r["constraint_message"])
            for r in result.check_results_as_records()]


def anomaly_detection_flow(P, sizes=(10_000, 10_200, 9_900, 10_100, 10_050, 3_000)):
    repository = P.InMemoryMetricsRepository()
    rng = np.random.default_rng(2)
    out = []
    for d, n in enumerate(sizes):
        result = (
            P.VerificationSuite()
            .on_data(P.Dataset.from_pydict({"x": rng.normal(0, 1, n)}))
            .use_repository(repository)
            .save_or_append_result(P.ResultKey.of(d))
            .add_anomaly_check(
                P.RelativeRateOfChangeStrategy(max_rate_decrease=0.8, max_rate_increase=1.2),
                P.Size(),
            )
            .run()
        )
        out.append((result.status.value, _rows(result)))
    return out


def test_anomaly_detection_example_flow_equals_the_reference():
    ref = anomaly_detection_flow(R)
    port = anomaly_detection_flow(T)
    assert port == ref
    assert port[-1][0] != "Success"  # the 70% drop is flagged
    assert all(status == "Success" for status, _ in port[:-1])


def _orders(P, day, rows):
    rng = np.random.default_rng(100 + day)
    amount = rng.gamma(2.0, 40.0, rows)
    amount[rng.random(rows) < 0.02] = np.nan
    return P.Dataset.from_pydict({
        "order_id": rng.integers(0, 1 << 40, rows, dtype=np.int64),
        "amount": np.ma.array(amount, mask=np.isnan(amount)),
        "status": [str(s) for s in np.array(["open", "shipped", "done", " DONE "])[
            rng.integers(0, 4, rows)]],
    })


def production_pipeline_flow(P, uri):
    """``production_pipeline.py`` steps 4-5, on in-memory tables: each
    day's checks saved to a repository behind a storage URI, with an
    anomaly check of Size wired in; then step 5's detector over the
    stored history."""
    repo = P.FileSystemMetricsRepository(uri)
    check = (
        P.Check(P.CheckLevel.ERROR, "orders")
        .has_size(lambda s: s > 0)
        .is_complete("order_id")
        .is_unique("order_id")
        .has_completeness("amount", lambda c: c > 0.9)
        .satisfies("LOWER(TRIM(status)) IN ('open', 'shipped', 'done')", "status-domain",
                   lambda f: f == 1.0)
    )
    runs = []
    for day in range(4):
        rows = 1_200 if day < 3 else 300
        result = (
            P.VerificationSuite().on_data(_orders(P, day, rows)).add_check(check)
            .use_repository(repo)
            .save_or_append_result(P.ResultKey.of(day, {"dataset": "orders"}))
            .add_anomaly_check(
                P.RelativeRateOfChangeStrategy(max_rate_decrease=0.5, max_rate_increase=2.0),
                P.Size(),
            )
            .run()
        )
        runs.append((result.status.value, _rows(result)))
    history = sorted(
        (P.DataPoint(r.result_key.dataset_date, r.analyzer_context.metric(P.Size()).value.get())
         for r in repo.load().get()),
        key=lambda p: p.time,
    )
    detector = P.AnomalyDetector(
        P.RelativeRateOfChangeStrategy(max_rate_decrease=0.5, max_rate_increase=2.0))
    verdict = detector.is_new_point_anomalous(history[:-1], history[-1])
    return runs, [(p.time, p.metric_value) for p in history], verdict.is_anomalous


def test_production_pipeline_step_5_equals_the_reference():
    space = uuid.uuid4().hex
    ref = production_pipeline_flow(R, f"mem://{space}-r/warehouse/metrics.json")
    port = production_pipeline_flow(T, f"mem://{space}-t/warehouse/metrics.json")
    assert port == ref
    runs, history, anomalous = port
    assert [s for s, _ in runs] == ["Success", "Success", "Success", "Warning"]
    assert history == [(0, 1200.0), (1, 1200.0), (2, 1200.0), (3, 300.0)]
    assert anomalous


def test_add_anomaly_check_without_a_repository_raises_in_both():
    for P in (R, T):
        builder = P.VerificationSuite().on_data(P.Dataset.from_pydict({"x": [1.0]}))
        with pytest.raises(ValueError, match="use_repository"):
            builder.add_anomaly_check(P.AbsoluteChangeStrategy(max_rate_increase=1.0), P.Size())


def _configured_flow(P, Config):
    """An anomaly check with a configuration: a tag filter, a date
    window, an ERROR level; and one with no save key (the new point sits
    one past the newest stored date)."""
    repo = P.InMemoryMetricsRepository()
    for day, (n, region) in enumerate([(100, "eu"), (1000, "us"), (110, "eu"), (120, "eu"),
                                       (5000, "us"), (90, "eu")]):
        ctx = P.AnalysisRunner.do_analysis_run(
            P.Dataset.from_pydict({"x": list(range(n))}), [P.Size(), P.Mean("x")])
        repo.save(P.AnalysisResult(P.ResultKey.of(day * 10, {"region": region}), ctx))
    out = []
    configs = [
        Config(level=P.CheckLevel.ERROR, description="eu sizes", with_tag_values={"region": "eu"}),
        Config(description="window", after_date=15, before_date=45),
        Config(description="all"),
    ]
    for n in (100, 400):
        for cfg in configs:
            for key in (P.ResultKey.of(60, {"region": "eu"}), None):
                builder = P.VerificationSuite().on_data(
                    P.Dataset.from_pydict({"x": list(range(n))})).use_repository(repo)
                if key is not None:
                    builder = builder.save_or_append_result(key)
                result = builder.add_anomaly_check(
                    P.RelativeRateOfChangeStrategy(max_rate_decrease=0.7, max_rate_increase=1.3),
                    P.Size(), cfg,
                ).add_anomaly_check(
                    P.SimpleThresholdStrategy(lower_bound=0.0, upper_bound=100.0), P.Mean("x"),
                ).run()
                out.append((n, cfg.description, key is None, result.status.value, _rows(result)))
                repo.save(P.AnalysisResult(P.ResultKey.of(60, {"region": "eu"}),
                                           P.AnalyzerContext({})))
    return out


def test_configured_anomaly_checks_equal_the_reference():
    assert _configured_flow(T, TConfig) == _configured_flow(R, RConfig)
