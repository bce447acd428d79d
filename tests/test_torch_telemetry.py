"""The port's telemetry layer (``deequ_tpu_torch/telemetry/``): the
counterparts of ``tests/test_telemetry.py``'s classes (spans, the
disabled path, export, run integration, operational records, the
report tools, tracing), run on CPU torch against the port's own process
default, plus what the torch hooks add: a span's
``torch.profiler.record_function`` range, ``profiler_trace``'s Chrome
trace, and operational records read across the two packages'
repositories.
"""

import json
import threading

import numpy as np
import pytest
import torch

import deequ_tpu as R
from deequ_tpu import telemetry as rtelemetry
from deequ_tpu.telemetry.oprecords import OperationalAnalyzer as ROperationalAnalyzer

import deequ_tpu_torch as T
from deequ_tpu_torch import config as tconfig
from deequ_tpu_torch import telemetry
from deequ_tpu_torch.analyzers.base import MetricCalculationException
from deequ_tpu_torch.egress import RowLevelSink
from deequ_tpu_torch.telemetry import (
    CollectingRunListener,
    MetricsRegistry,
    Telemetry,
    TraceContext,
    get_telemetry,
    merge_summaries,
    profiler_trace,
    read_jsonl,
    summarize_phases,
    summary_from_json,
    summary_to_json,
)
from deequ_tpu_torch.telemetry.oprecords import (
    OPERATIONAL_METRICS,
    OperationalAnalyzer,
    operational_metrics,
    operational_values,
)


@pytest.fixture(autouse=True)
def _cpu():
    with tconfig.configure(device="cpu"):
        yield


def df_numeric(P=T):
    """``tests/fixtures.py::df_numeric`` in package ``P``."""
    return P.Dataset.from_pydict({
        "item": ["1", "2", "3", "4", "5", "6"],
        "att1": [1, 2, 3, 4, 5, 6],
        "att2": [0, 0, 0, 5, 6, 7],
    })


def df_numeric_with_nulls(P=T):
    return P.Dataset.from_pydict({
        "item": ["1", "2", "3", "4", "5", "6"],
        "att1": [1, None, 3, None, 5, 6],
        "att2": [0, 0, None, 5, 6, 7],
    })


class _SpanSink:
    """Every finished span record of the port's process telemetry."""

    def __init__(self):
        self.records = []
        self._tm = get_telemetry()

    def __enter__(self):
        self._tm.add_span_sink(self.records.append)
        return self.records

    def __exit__(self, *exc):
        self._tm.remove_span_sink(self.records.append)


class TestSpans:
    def test_nesting_and_attributes(self):
        tm = Telemetry(enabled=True, annotate=False)
        with tm.run("r") as cap:
            with tm.span("outer", phase="x") as outer:
                with tm.span("inner") as inner:
                    inner.set(rows=10)
                assert outer is not inner
        names = [s["name"] for s in cap.spans]
        assert names == ["inner", "outer", "run:r"]
        inner_rec, outer_rec, root_rec = cap.spans
        assert inner_rec["parent_id"] == outer_rec["span_id"]
        assert outer_rec["parent_id"] == root_rec["span_id"]
        assert inner_rec["attributes"] == {"rows": 10}
        assert outer_rec["attributes"] == {"phase": "x"}

    @pytest.mark.parametrize("annotate", [False, True])
    def test_exception_pops_span_and_propagates(self, annotate):
        """An error inside a span propagates through its annotation (a
        ``record_function`` range when ``annotate``), and the stack is
        left whole."""
        tm = Telemetry(enabled=True, annotate=annotate)
        with pytest.raises(ValueError, match="x"):
            with tm.span("boom"):
                raise ValueError("x")
        assert tm.tracer.current() is None
        with tm.run("r") as cap:
            with tm.span("after"):
                pass
        assert cap.spans[0]["name"] == "after"

    def test_thread_safety_parentage(self):
        tm = Telemetry(enabled=True, annotate=False)
        records, lock = [], threading.Lock()

        def record(sp):
            with lock:
                records.append(sp.as_record())

        def worker(i):
            with tm.tracer.span(f"outer-{i}", on_finish=record):
                with tm.tracer.span(f"inner-{i}", on_finish=record):
                    pass

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert len(records) == 16
        by_id = {r["span_id"]: r for r in records}
        for r in records:
            if r["name"].startswith("inner"):
                parent = by_id[r["parent_id"]]
                assert parent["name"] == r["name"].replace("inner", "outer")
                assert parent["thread"] == r["thread"]
            else:
                assert r["parent_id"] is None

    def test_concurrent_counter_increments(self):
        counter = MetricsRegistry().counter("c")

        def bump():
            for _ in range(1000):
                counter.inc()

        threads = [threading.Thread(target=bump) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert counter.value == 8000

    def test_spans_are_profiler_ranges(self, tmp_path):
        """Inside ``profiler_trace`` a run's spans are
        ``record_function`` ranges named ``deequ_tpu:<name>``, and the
        session writes a Chrome trace holding them."""
        with profiler_trace(str(tmp_path)) as prof:
            T.AnalysisRunner.do_analysis_run(df_numeric(), [T.Size(), T.Mean("att1")])
        names = {e.name for e in prof.events()}
        assert {"deequ_tpu:run:analysis", "deequ_tpu:pass:scan"} <= names
        with open(tmp_path / "trace.json") as fh:
            trace = json.load(fh)
        traced = {e.get("name") for e in trace["traceEvents"]}
        assert "deequ_tpu:pass:scan" in traced

    @pytest.mark.parametrize("device, traced", [("cuda", True), (None, True), ("cpu", False)])
    def test_profiler_trace_follows_the_configured_device(self, tmp_path, monkeypatch,
                                                          device, traced):
        """``profiler_trace`` asks for CUDA activity when the configured
        device is CUDA (None means "cuda"), even around the process's
        first card run, before CUDA is initialised; and a span pushes
        its NVTX range then too."""
        requested, pushed = [], []

        class Session:
            def __init__(self, activities):
                requested.extend(activities)

            def __enter__(self):
                return self

            def __exit__(self, *exc):
                return False

            def export_chrome_trace(self, path):
                with open(path, "w") as fh:
                    fh.write('{"traceEvents": []}')

        cpu, cuda = torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA
        monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
        monkeypatch.setattr(torch.backends.cuda, "is_built", lambda: True)
        monkeypatch.setattr(torch.cuda.nvtx, "range_push", pushed.append)
        monkeypatch.setattr(torch.cuda.nvtx, "range_pop", lambda: None)
        monkeypatch.setattr(torch.profiler, "supported_activities", lambda: {cpu, cuda})
        monkeypatch.setattr(torch.profiler, "profile", Session)
        with tconfig.configure(device=device):
            with profiler_trace(str(tmp_path)):
                with Telemetry().span("pass:scan"):
                    pass
        assert requested == ([cpu, cuda] if traced else [cpu])
        assert pushed == (["deequ_tpu:pass:scan"] if traced else [])
        assert json.loads((tmp_path / "trace.json").read_text()) == {"traceEvents": []}

    def test_annotation_never_picks_the_path(self):
        """Metrics are bit-equal with annotation on and off, inside a
        profiler session or not."""
        data = T.Dataset.from_pydict({"x": np.random.default_rng(1).normal(size=5000)})
        analyzers = [T.Sum("x"), T.Mean("x"), T.ApproxCountDistinct("x"), T.Minimum("x")]

        def values():
            ctx = T.AnalysisRunner.do_analysis_run(data, analyzers)
            return [ctx.metric(a).value.get() for a in analyzers]

        tm = get_telemetry()
        tm.configure(annotate=False)
        try:
            plain = values()
        finally:
            tm.configure(annotate=True)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            annotated = values()
        assert annotated == plain == values()


class TestDisabled:
    def test_noop_identity(self):
        tm = Telemetry(enabled=False)
        assert tm.span("a") is tm.span("b", attr=1)
        with tm.run("r") as cap:
            with tm.span("x"):
                tm.event("scan_phases", host_wait_s=1.0)
        assert cap.summary(tm.metrics.counters_snapshot()) is None
        assert cap.final is None
        assert cap.spans == [] and cap.events == []
        assert tm.recent() == []

    def test_counters_stay_live_when_disabled(self):
        tm = Telemetry(enabled=False)
        tm.counter("transfer.bytes").inc(123)
        assert tm.metrics.counters_snapshot() == {"transfer.bytes": 123}

    def test_disabled_listeners_not_called(self):
        tm = Telemetry(enabled=False)
        listener = tm.add_listener(CollectingRunListener())
        with tm.run("r"):
            tm.event("e")
        tm.analyzer_computed(object(), object())
        tm.check_evaluated(object(), object())
        assert listener.run_starts == [] and listener.engine_events == []
        assert listener.analyzers_computed == [] and listener.checks_evaluated == []

    def test_disabled_run_still_yields_run_metadata(self):
        """With telemetry off the run records its pass and its
        ``scan_phases`` event itself, and the counters still count."""
        before = get_telemetry().counter("engine.scans").value
        telemetry.configure(enabled=False)
        try:
            ctx = T.AnalysisRunner.do_analysis_run(df_numeric(), [T.Size(), T.Mean("att1")])
        finally:
            telemetry.configure(enabled=True)
        assert ctx.telemetry is None
        assert [p.name for p in ctx.run_metadata.passes] == ["scan"]
        assert ctx.run_metadata.passes[0].wall_s > 0
        assert [e["event"] for e in ctx.run_metadata.events] == ["scan_phases"]
        assert get_telemetry().counter("engine.scans").value == before + 1


class TestExport:
    def _run_summary(self):
        tm = Telemetry(enabled=True, annotate=False)
        with tm.run("serde") as cap:
            tm.counter("transfer.bytes").inc(4096)
            with tm.pass_span("scan", rows=100, num_analyzers=2):
                pass
            tm.event("scan_phases", host_wait_s=0.5, put_s=0.25, mode="x")
        return cap.final

    def test_summary_json_round_trip(self):
        summary = self._run_summary()
        assert summary_from_json(summary_to_json(summary)) == summary

    def test_merge_summaries(self):
        a, b = self._run_summary(), self._run_summary()
        merged = merge_summaries([a, None, b])
        assert merged["wall_s"] == pytest.approx(a["wall_s"] + b["wall_s"])
        assert len(merged["passes"]) == 2
        assert merged["counters"]["transfer.bytes"] == 8192
        assert merge_summaries([None, None]) is None
        assert merge_summaries([a]) is a

    def test_summarize_phases(self):
        phases = summarize_phases(self._run_summary()["events"])
        assert phases["host_wait_s"] == pytest.approx(0.5)
        assert phases["put_s"] == pytest.approx(0.25)
        assert phases["scan_passes"] == 1

    def test_jsonl_artifact(self, tmp_path):
        path = str(tmp_path / "events.jsonl")
        tm = Telemetry(enabled=True, jsonl_path=path, annotate=False)
        with tm.run("art"):
            with tm.span("step"):
                pass
            tm.event("grouping_spill", columns=["c"], path="device-sort")
        records = read_jsonl(path)
        assert [r["type"] for r in records] == ["span", "event", "span", "run_summary"]
        span, event, root, run = records
        assert (root["name"], span["name"], event["event"]) == ("run:art", "step",
                                                                 "grouping_spill")
        assert run["name"] == "art" and run["counters"] == {}
        # the JAX package's reader reads the port's artifact
        assert rtelemetry.read_jsonl(path) == records

    def test_prometheus_exposition(self):
        registry = MetricsRegistry()
        registry.counter("transfer.bytes").inc(10)
        registry.gauge("batch.size").set(2048)
        registry.histogram("pass.wall_s").observe(0.02)
        text = registry.to_prometheus()
        assert "# TYPE deequ_tpu_transfer_bytes counter" in text
        assert "deequ_tpu_transfer_bytes 10" in text
        assert "deequ_tpu_batch_size 2048" in text
        assert 'deequ_tpu_pass_wall_s_bucket{le="+Inf"} 1' in text


class TestRunIntegration:
    def test_context_summary_and_wall_consistency(self):
        ctx = T.AnalysisRunner.do_analysis_run(
            df_numeric(), [T.Size(), T.Mean("att1"), T.Completeness("att2"),
                           T.Uniqueness(["item"])])
        summary = ctx.telemetry
        assert [p["pass"] for p in summary["passes"]] == ["scan"]
        pass_wall = sum(p["wall_s"] for p in summary["passes"])
        assert 0.5 * summary["wall_s"] <= pass_wall <= summary["wall_s"]
        assert [p.wall_s for p in ctx.run_metadata.passes] == [
            p["wall_s"] for p in summary["passes"]]
        counters = summary["counters"]
        assert counters["engine.scans"] >= 1
        assert counters["engine.data_passes"] == 1 and counters["engine.device_fetches"] >= 1
        assert any(e["event"] == "scan_phases" for e in summary["events"])
        assert {"run:analysis", "pass:scan"} <= {s["name"] for s in summary["spans"]}

    def test_scan_phases_buckets_sum_within_the_pass(self):
        ctx = T.AnalysisRunner.do_analysis_run(
            T.Dataset.from_pydict({"x": np.arange(10_000.0)}), [T.Mean("x")])
        (phases,) = [e for e in ctx.telemetry["events"] if e["event"] == "scan_phases"]
        buckets = sum(phases[k] for k in ("host_wait_s", "put_s", "dispatch_s",
                                          "first_step_s", "sync_s"))
        assert phases["mode"] == "resident"
        assert 0 < buckets <= ctx.telemetry["passes"][0]["wall_s"]

    def test_listener_callbacks_across_a_run(self):
        tm = get_telemetry()
        listener = tm.add_listener(CollectingRunListener())
        try:
            T.AnalysisRunner.do_analysis_run(df_numeric(), [T.Size(), T.Mean("att1")])
        finally:
            tm.remove_listener(listener)
        assert len(listener.run_starts) == len(listener.run_ends) == 1
        _run_id, name, summary = listener.run_ends[0]
        assert name == "analysis" and summary is not None
        assert listener.pass_starts == [("scan", 6, 2)]
        pname, wall, rows, n = listener.pass_ends[0]
        assert (pname, rows, n) == ("scan", 6, 2) and wall > 0
        assert {a for a, _m in listener.analyzers_computed} == {T.Size(), T.Mean("att1")}
        assert any(e["event"] == "scan_phases" for e in listener.engine_events)

    def test_broken_listener_never_fails_the_run(self):
        class Broken(CollectingRunListener):
            def on_pass_end(self, *args):
                raise RuntimeError("dashboard down")

        tm = get_telemetry()
        before = tm.counter("telemetry.listener_errors").value
        listener = tm.add_listener(Broken())
        try:
            ctx = T.AnalysisRunner.do_analysis_run(df_numeric(), [T.Size()])
        finally:
            tm.remove_listener(listener)
        assert ctx.metric(T.Size()).value.is_success
        assert tm.counter("telemetry.listener_errors").value > before

    def test_verification_result_carries_telemetry(self):
        tm = get_telemetry()
        listener = tm.add_listener(CollectingRunListener())
        check = T.Check(T.CheckLevel.ERROR, "size").has_size(lambda n: n == 6)
        before = tm.counter("checks.evaluated").value
        try:
            result = T.VerificationSuite().on_data(df_numeric()).add_check(check).run()
        finally:
            tm.remove_listener(listener)
        assert result.telemetry is not None and result.run_metadata is not None
        assert len(listener.checks_evaluated) == 1
        assert listener.checks_evaluated[0][0] is check
        assert tm.counter("checks.evaluated").value == before + 1

    def test_profiler_merges_summaries(self):
        profiles = T.ColumnProfilerRunner().on_data(df_numeric()).run()
        assert profiles.telemetry is not None
        assert [p["pass"] for p in profiles.telemetry["passes"]] == [
            p.name for p in profiles.run_metadata.passes]

    def test_a_resident_rerun_moves_no_bytes_and_fetches_once(self):
        """Columns already on the device: the rerun's ``transfer.bytes``
        is 0, and it makes one fetch, as with telemetry off."""
        data = T.Dataset.from_pydict({"x": np.arange(5000.0), "s": ["a", "b"] * 2500})
        analyzers = [T.Mean("x"), T.Completeness("s"), T.ApproxCountDistinct("s")]
        first = T.AnalysisRunner.do_analysis_run(data, analyzers).telemetry["counters"]
        assert first["transfer.bytes"] > 0
        engine = T.AnalysisEngine()
        rerun = T.AnalysisRunner.do_analysis_run(data, analyzers, engine=engine)
        counters = rerun.telemetry["counters"]
        assert "transfer.bytes" not in counters
        assert counters["engine.device_fetches"] == engine.device_fetches == 1
        telemetry.configure(enabled=False)
        try:
            off_engine = T.AnalysisEngine()
            off = T.AnalysisRunner.do_analysis_run(data, analyzers, engine=off_engine)
        finally:
            telemetry.configure(enabled=True)
        assert off_engine.device_fetches == 1
        assert [off.metric(a).value.get() for a in analyzers] == \
            [rerun.metric(a).value.get() for a in analyzers]


class TestOperationalRecords:
    def test_operational_values_from_summary(self):
        summary = {
            "wall_s": 2.0,
            "passes": [{"pass": "scan", "wall_s": 1.5, "rows": 1000, "num_analyzers": 3}],
            "counters": {"transfer.bytes": 8000, "engine.plan_cache.hits": 1,
                         "grouping.spill.device-sort": 1, "grouping.spill.host": 2},
        }
        values = operational_values(summary)
        assert values["rows"] == 1000
        assert values["rows_per_sec"] == pytest.approx(500.0)
        assert values["bytes_per_row"] == pytest.approx(8.0)
        assert values["spill_events"] == 3
        assert operational_values(None) == {}
        assert set(values) <= set(OPERATIONAL_METRICS)

    def test_repository_round_trip_and_anomaly_series(self, tmp_path):
        repo = T.FileSystemMetricsRepository(str(tmp_path / "metrics.json"))
        for day in (1000, 2000, 3000):
            T.AnalysisRunner.on_data(df_numeric()).add_analyzers([T.Size(), T.Mean("att1")]) \
                .use_repository(repo).save_or_append_result(
                    T.ResultKey.of(day, {"dataset": "numeric"})).run()
        records = repo.load().for_analyzers([OperationalAnalyzer("rows_per_sec")]) \
            .get_success_metrics_as_records()
        assert len(records) == 3
        assert all(r["name"] == "Operational" and r["instance"] == "rows_per_sec"
                   and r["value"] > 0 and r["entity"] == "Dataset" for r in records)
        from deequ_tpu_torch.anomalydetection.base import AnomalyDetector, DataPoint
        from deequ_tpu_torch.anomalydetection.strategies import SimpleThresholdStrategy

        series = [DataPoint(r["dataset_date"], r["value"]) for r in records]
        detector = AnomalyDetector(SimpleThresholdStrategy(lower_bound=0.0))
        assert not detector.is_new_point_anomalous(
            series, DataPoint(4000, series[-1].metric_value)).is_anomalous
        assert detector.is_new_point_anomalous(series, DataPoint(4000, -1.0)).is_anomalous

    def test_returned_context_stays_clean(self):
        repo = T.InMemoryMetricsRepository()
        key = T.ResultKey.of(1, {})
        ctx = T.AnalysisRunner.on_data(df_numeric()).add_analyzers([T.Size()]) \
            .use_repository(repo).save_or_append_result(key).run()
        assert not any(isinstance(a, OperationalAnalyzer) for a in ctx.metric_map)
        saved = repo.load_by_key(key).analyzer_context
        assert any(isinstance(a, OperationalAnalyzer) for a in saved.metric_map)

    def test_operational_analyzer_never_computes(self):
        with pytest.raises(MetricCalculationException):
            OperationalAnalyzer("wall_s").compute_metric_from_state(None)
        assert operational_metrics(None) == {}

    @pytest.mark.parametrize("writer", ["reference", "port"])
    def test_records_load_in_the_other_package(self, tmp_path, writer):
        """A repository file written by either package, operational
        records included, loads in the other with every record."""
        path = str(tmp_path / "metrics.json")
        P, Q = (R, T) if writer == "reference" else (T, R)
        P.AnalysisRunner.on_data(df_numeric(P)).add_analyzers([P.Size(), P.Mean("att1")]) \
            .use_repository(P.FileSystemMetricsRepository(path)) \
            .save_or_append_result(P.ResultKey.of(5, {"k": "v"})).run()
        (written,) = P.FileSystemMetricsRepository(path).load().get()
        (read,) = Q.FileSystemMetricsRepository(path).load().get()
        ops = {a.metric: m.value.get() for a, m in read.analyzer_context.metric_map.items()
               if type(a).__name__ == "OperationalAnalyzer"}
        assert {"wall_s", "rows", "rows_per_sec"} <= set(ops)
        assert {(repr(a), m.value.get()) for a, m in written.analyzer_context.metric_map.items()} \
            == {(repr(a), m.value.get()) for a, m in read.analyzer_context.metric_map.items()}
        rows = OperationalAnalyzer("rows") if Q is T else ROperationalAnalyzer("rows")
        records = Q.FileSystemMetricsRepository(path).load().for_analyzers([rows]) \
            .get_success_metrics_as_records()
        assert [r["value"] for r in records] == [6.0]


class TestTools:
    def test_obs_report_renders_a_port_artifact(self, tmp_path, capsys):
        from tools.obs_report import main as report_main

        path = str(tmp_path / "runs.jsonl")
        telemetry.configure(jsonl_path=path)
        try:
            T.AnalysisRunner.do_analysis_run(df_numeric(), [T.Size(), T.Uniqueness(["att1"])])
        finally:
            telemetry.configure(jsonl_path=None)
        assert report_main([path]) == 0
        out = capsys.readouterr().out
        assert "run " in out and "(analysis)" in out and "scan" in out
        assert "counters (delta over run):" in out and "engine.scans" in out
        assert report_main([path, "--counters"]) == 0

    def test_obs_report_egress_line(self, tmp_path, capsys):
        from tools.obs_report import main as report_main

        path = str(tmp_path / "runs.jsonl")
        telemetry.configure(jsonl_path=path)
        try:
            T.VerificationSuite.do_verification_run(
                df_numeric_with_nulls(), [T.Check(T.CheckLevel.ERROR, "c").is_complete("att1")],
                row_level_sink=RowLevelSink(str(tmp_path / "egress")))
        finally:
            telemetry.configure(jsonl_path=None)
        report_main([path])
        out = capsys.readouterr().out
        assert "egress: " in out and "clean /" in out and "quarantined" in out
        assert "bytes/row out" in out and "encode share" in out


class TestRunTracing:
    def test_trace_context_roundtrip(self):
        ctx = TraceContext.mint("run-7", process="host-a")
        assert ctx.trace_id.startswith("run-7-")
        assert TraceContext.decode(ctx.child(123).encode()) == TraceContext(
            ctx.trace_id, 123, process="host-a")
        assert TraceContext.decode("garbage") is None
        assert TraceContext.decode("t:notanint:p") is None

    def test_a_traced_run_is_one_tree_trace_report_reads(self, tmp_path, capsys):
        """A run under a TraceContext: its spans, the phase spans and
        the persist span form one tree under the trace's root, which
        ``tools/trace_report.py`` decomposes."""
        from tools.trace_report import main as trace_main

        tm = get_telemetry()
        ctx = TraceContext.mint("port-run")
        path = str(tmp_path / "runs.jsonl")
        telemetry.configure(jsonl_path=path)
        try:
            with _SpanSink() as records:
                with tm.trace_scope(ctx):
                    T.AnalysisRunner.on_data(df_numeric()).add_analyzers([T.Size()]) \
                        .use_repository(T.InMemoryMetricsRepository()) \
                        .save_or_append_result(T.ResultKey.of(1)).run()
                tm.emit_span("ticket", 0.5, trace=ctx, span_id=ctx.span_id, parent_id=None)
        finally:
            telemetry.configure(jsonl_path=None)
        spans = [r for r in records if r.get("trace_id") == ctx.trace_id]
        ids = {r["span_id"] for r in spans}
        roots = [r for r in spans if r.get("parent_id") not in ids]
        assert [r["name"] for r in roots] == ["ticket"]
        names = {r["name"] for r in spans}
        assert {"run:analysis", "pass:scan", "phase:scan", "persist"} <= names
        assert trace_main([path]) == 0
        out = capsys.readouterr().out
        assert f"trace {ctx.trace_id}" in out and "persist" in out and "run:analysis" in out


class TestTracingZeroCost:
    def test_trace_scope_is_shared_noop_when_disabled(self):
        tm = Telemetry(enabled=False, annotate=False)
        assert tm.trace_scope(TraceContext.mint("x")) is tm.trace_scope(None)
        assert tm.current_trace() is None

    def test_untraced_run_emits_no_trace_spans(self):
        with _SpanSink() as records:
            T.AnalysisRunner.do_analysis_run(df_numeric(), [T.Size(), T.Mean("att1")])
        names = {r["name"] for r in records}
        assert names == {"run:analysis", "pass:scan"}
        assert all(r.get("trace_id") is None for r in records)


class TestTraceReportTool:
    def _span(self, trace, sid, parent, name, wall, start=0.0, **attrs):
        return {"type": "span", "trace_id": trace, "span_id": sid, "parent_id": parent,
                "name": name, "wall_s": wall, "started_at": start, "thread": "t",
                "attributes": attrs}

    def test_port_records_read_as_the_references(self, tmp_path, capsys):
        """A port artifact of synthetic trace spans, written through the
        port's JSONL writer, renders as ``tools/trace_report.py`` renders
        them."""
        from tools.trace_report import render

        path = str(tmp_path / "t.jsonl")
        tm = Telemetry(enabled=True, jsonl_path=path, annotate=False)
        ctx = TraceContext.mint("A")
        tm.emit_span("queue_wait", 8.0, trace=ctx, parent_id=ctx.span_id, started_at=0.0)
        tm.emit_span("execute", 2.0, trace=ctx, parent_id=ctx.span_id, started_at=8.0)
        tm.emit_span("ticket", 10.0, trace=ctx, span_id=ctx.span_id, parent_id=None,
                     started_at=0.0, run_id="run-a")
        out = render(read_jsonl(path))
        assert f"trace {ctx.trace_id}  run=run-a" in out
        assert "queue_wait           8.000s   80.0%" in out
