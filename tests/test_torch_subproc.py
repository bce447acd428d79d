"""Crash isolation of the port (``deequ_tpu_torch/engine/subproc.py``).

Counterparts of ``tests/test_crash_recovery.py``'s ``TestIsolatedRunner``,
``TestCrashResumeDifferential`` and ``TestCrashLoopBreaker`` and of
``tests/test_telemetry.py``'s spawn-child tracing tests, on the CPU. Every
child crosses a real process boundary (``spawn``) and is given the
parent's ``device="cpu"``:

- a result and an in-band exception cross the pipe; SIGSEGV is
  classified and the crash loop bounded; a hung child is terminated and
  classified; a cancel reaches the child over the control pipe;
- a scan killed by SIGSEGV in a child resumes in the relaunched child
  from its checkpoint, bit-equal to the port's uninterrupted run and
  equal to the JAX package's within ROADMAP's tolerance (1e-12 relative)
  in the resident and streamed modes; the mesh mode waits for the mesh
  engine's checkpoints (ROADMAP 5d);
- the breaker opens on a crash loop, refuses launches without a child,
  and one half-open probe closes it;
- the child runs on the device the parent was configured for; a child of
  a parent with no device runs on ``cuda`` and, without a GPU, raises
  in-band (not as a crash); a result holding CPU tensors crosses from a
  child that exits at once;
- a child's spans re-root under the parent's launching span, and a
  crashed child's streamed spans are kept.

Every child function is module-level (spawn pickles by reference), and
every test reaps its children.
"""

import multiprocessing
import signal

import pytest
import torch

import deequ_tpu as R
from deequ_tpu import config as rconfig

from deequ_tpu_torch import config as tconfig
from deequ_tpu_torch.engine import subproc
from deequ_tpu_torch.engine.deadline import CancelToken, ManualClock
from deequ_tpu_torch.engine.resilience import TransientScanError
from deequ_tpu_torch.engine.subproc import (
    CLOSED,
    HALF_OPEN,
    OPEN,
    BreakerOpen,
    CircuitBreaker,
    CrashLoopError,
    IsolatedRunner,
    ProcessCrashed,
    checkpoint_progress_probe,
    reset_breakers,
)
from deequ_tpu_torch.telemetry import TraceContext, get_telemetry

import test_torch_subproc_children as C

RTOL = 1e-12


@pytest.fixture(autouse=True)
def _reaped_and_reset():
    reset_breakers()
    with tconfig.configure(device="cpu"):
        yield
    assert multiprocessing.active_children() == []
    reset_breakers()


def _counter(name):
    return get_telemetry().counter(name).value


# -- the runner --------------------------------------------------------------


class TestIsolatedRunner:
    def test_result_crosses_the_pipe(self):
        runner = IsolatedRunner(key="ok", use_breaker=False)
        assert runner.run(C.child_ok, {"x": 21}) == {"doubled": 42}

    def test_in_band_exception_passes_through(self):
        crashes = _counter("engine.child_crashes")
        runner = IsolatedRunner(key="raise", use_breaker=False)
        with pytest.raises(ValueError, match="decode exploded"):
            runner.run(C.child_raise, {"message": "decode exploded"})
        assert _counter("engine.child_crashes") == crashes

    def test_sigsegv_classified_and_crash_loop_bounded(self):
        crashes = _counter("engine.child_crashes")
        relaunches = _counter("engine.child_relaunches")
        loops = _counter("engine.crash_loops")
        runner = IsolatedRunner(key="poison", max_relaunches=2, use_breaker=False)
        with pytest.raises(CrashLoopError) as excinfo:
            runner.run(C.child_crash, {"signum": signal.SIGSEGV})
        exc = excinfo.value
        assert exc.launches == 2 and exc.last_signal == "SIGSEGV"
        assert exc.last_exitcode == -signal.SIGSEGV
        assert isinstance(exc.__cause__, ProcessCrashed)
        assert isinstance(exc.__cause__, TransientScanError)
        assert _counter("engine.child_crashes") - crashes == 2
        assert _counter("engine.child_relaunches") - relaunches == 1
        assert _counter("engine.crash_loops") - loops == 1

    def test_timeout_terminates_and_classifies(self):
        runner = IsolatedRunner(key="hung", max_relaunches=1, timeout_s=5.0,
                                use_breaker=False)
        with pytest.raises(CrashLoopError) as excinfo:
            runner.run(C.child_sleep, {"seconds": 600})
        assert excinfo.value.last_signal == "timeout"
        assert excinfo.value.last_exitcode == -signal.SIGTERM

    def test_cancel_reaches_the_child(self):
        token = CancelToken()
        token.cancel("preempted")
        runner = IsolatedRunner(key="cancel", use_breaker=False, cancel_token=token)
        got = runner.run(C.child_wait_cancel, {"seconds": 120})
        assert got == {"cancelled": True, "reason": "preempted"}

    def test_classify_exit(self):
        assert subproc._classify_exit(-9) == ("child killed by SIGKILL (exitcode -9)",
                                              "SIGKILL")
        assert subproc._classify_exit(139)[1] == "SIGSEGV"
        assert subproc._classify_exit(3) == ("child exited with status 3 before replying",
                                             None)
        assert subproc._classify_exit(None)[1] is None


class TestChildDevice:
    def test_child_runs_on_the_parents_device(self):
        got = IsolatedRunner(key="dev", use_breaker=False).run(C.child_device, {})
        assert got == {"option": "cpu", "engine": "cpu", "mean": 7.0 / 3.0}

    def test_unconfigured_child_without_a_gpu_raises_in_band(self):
        crashes = _counter("engine.child_crashes")
        with tconfig.configure(device=None):
            runner = IsolatedRunner(key="nocuda", use_breaker=False)
            with pytest.raises(RuntimeError, match="CUDA device by default"):
                runner.run(C.child_ok, C.NoCuda())
        assert _counter("engine.child_crashes") == crashes

    def test_cpu_tensors_cross_from_a_child_that_exits_at_once(self):
        got = IsolatedRunner(key="tensors", use_breaker=False).run(
            C.child_tensors, {"seed": 5, "n": 1 << 20})
        want = C.child_tensors({"seed": 5, "n": 1 << 20})
        assert torch.equal(got["big"], want["big"])
        assert all(torch.equal(g, w) for g, w in zip(got["ints"], want["ints"]))
        assert got["big"].device.type == "cpu"

    def test_frames_copy_tensor_bytes(self):
        """The pipe's framing is the standard pickler: the frame holds the
        tensor's bytes, not a descriptor of shared memory."""
        parent, child = multiprocessing.Pipe(duplex=False)
        try:
            # small enough for the pipe's buffer: nobody reads it yet
            tensor = torch.arange(1024, dtype=torch.int64)
            subproc._send(child, ("ok", tensor, None))
            raw = parent.recv_bytes()
            assert len(raw) > tensor.numel() * tensor.element_size()
        finally:
            parent.close()
            child.close()


# -- crash, relaunch, resume -------------------------------------------------


def _reference_metrics(data):
    with rconfig.configure(batch_size=104, checkpoint_every_batches=3):
        ctx = R.AnalysisRunner.do_analysis_run(R.Dataset.from_pydict(data), C.analyzers(R))
    return [(str(a), ctx.metric(a).value.get()) for a in C.analyzers(R)]


@pytest.mark.parametrize("mode", ["resident", "streaming", "mesh"])
class TestCrashResumeDifferential:
    def test_crash_then_relaunch_bit_identical(self, mode, tmp_path):
        if mode == "mesh":
            pytest.skip("a mesh engine takes no checkpointer yet, so a mesh scan cannot "
                        "resume after a crash (ROADMAP 5d)")
        data = C.table_data()
        oracle = C.scan_child({"mode": mode, "data": data,
                              "ckpt_path": str(tmp_path / "ref-ckpt")})
        ckpt_path = str(tmp_path / "ckpt")
        resumes = _counter("engine.resumes")
        crashes = _counter("engine.child_crashes")
        crash_resumes = _counter("engine.crash_resumes")
        runner = IsolatedRunner(key=f"scan:{mode}", max_relaunches=3, timeout_s=300.0,
                                progress_probe=checkpoint_progress_probe(ckpt_path),
                                use_breaker=False)
        got = runner.run(C.scan_child, {
            "mode": mode, "data": data, "ckpt_path": ckpt_path,
            # batch 7 of 10 (104-row batches over 1,000 rows), past the
            # checkpoint after batch 6 (every 3 batches)
            "crash_at_batch": 7, "crash_token_path": str(tmp_path / "crash-token"),
        })
        assert got["metrics"] == oracle["metrics"]
        assert oracle["resumed_at"] is None
        # a streamed scan's prefetch may produce batch 7 before the scan
        # reached the checkpoint after batch 6
        assert got["resumed_at"] in ({6} if mode == "resident" else {3, 6})
        assert _counter("engine.child_crashes") - crashes == 1
        assert _counter("engine.crash_resumes") - crash_resumes == 1
        # the relaunched child's own resume counter merged into the parent's
        assert _counter("engine.resumes") - resumes == 1
        ref = dict(_reference_metrics(data))
        for name, value in got["metrics"]:
            assert value == pytest.approx(ref[name], rel=RTOL, abs=0), name


def test_progress_probe_reads_only_port_checkpoints(tmp_path):
    """The probe reads cursors through the checkpointer's own unpickler:
    a blob of the JAX package under the same key prefix tells nothing."""
    import pickle

    from deequ_tpu.engine.deadline import ScanInterruption as RScanInterruption

    from deequ_tpu_torch.io.state_provider import ScanCheckpointer, ScanCursor

    probe = checkpoint_progress_probe(str(tmp_path))
    assert probe() == ()
    ScanCheckpointer(str(tmp_path)).save(ScanCursor(4, 416, "fp", 104), "tok", [], {}, None)
    assert probe() == (("scan-ckpt-tok.pkl", 4),)
    (tmp_path / "scan-ckpt-jax.pkl").write_bytes(pickle.dumps(
        {"cursor": RScanInterruption(kind="x", reason="y", batch_index=1, row_offset=0,
                                     checkpointed=True)}))
    (tmp_path / "scan-ckpt-torn.pkl").write_bytes(b"\x80\x05torn")
    assert probe() == (("scan-ckpt-tok.pkl", 4),)


# -- the breaker -------------------------------------------------------------


class TestCrashLoopBreaker:
    def test_loop_opens_fast_fails_then_half_open_probe_closes(self):
        trips = _counter("engine.breaker_trips")
        clock = ManualClock()
        breaker = CircuitBreaker(cooldown_s=60.0, clock=clock)
        runner = IsolatedRunner(key="plan:poison", max_relaunches=2, breaker=breaker)
        with pytest.raises(CrashLoopError):
            runner.run(C.child_crash, {"signum": signal.SIGSEGV})
        assert breaker.state == OPEN
        assert _counter("engine.breaker_trips") - trips == 1
        crashes = _counter("engine.child_crashes")
        with pytest.raises(BreakerOpen) as excinfo:
            IsolatedRunner(key="plan:poison", breaker=breaker).run(C.child_ok, {"x": 1})
        assert 0.0 < excinfo.value.retry_after_s <= 60.0
        assert excinfo.value.key == "plan:poison"
        assert _counter("engine.child_crashes") == crashes
        clock.advance(61.0)
        probe_runner = IsolatedRunner(key="plan:poison", breaker=breaker)
        assert probe_runner.run(C.child_ok, {"x": 2}) == {"doubled": 4}
        assert breaker.state == CLOSED

    def test_half_open_admits_exactly_one_probe(self):
        clock = ManualClock()
        breaker = CircuitBreaker(cooldown_s=30.0, clock=clock)
        breaker.record_crash_loop("k")
        clock.advance(31.0)
        breaker.admit("k")
        assert breaker.state == HALF_OPEN
        with pytest.raises(BreakerOpen):
            breaker.admit("k")
        breaker.record_success("k")
        assert breaker.state == CLOSED
        breaker.admit("k")

    def test_disabled_by_config(self):
        with tconfig.configure(crash_breaker_cooldown_s=0):
            assert subproc.breaker_for("any-key") is None

    def test_registry_and_states(self):
        with tconfig.configure(crash_breaker_cooldown_s=5):
            breaker = subproc.breaker_for("plan:a")
            assert subproc.breaker_for("plan:a") is breaker
        breaker.record_crash_loop("plan:a")
        assert subproc.breaker_states() == {"plan:a": OPEN}
        reset_breakers()
        assert subproc.breaker_states() == {}

    def test_options_match_the_reference(self):
        for name in ("isolated_execution", "crash_max_relaunches", "crash_breaker_cooldown_s"):
            assert getattr(tconfig.options(), name) == getattr(rconfig.options(), name)


# -- tracing across the spawn boundary ---------------------------------------


class _SpanSink:
    def __init__(self):
        self.records = []
        self._tm = get_telemetry()

    def __enter__(self):
        self._tm.add_span_sink(self.records.append)
        return self.records

    def __exit__(self, *exc):
        self._tm.remove_span_sink(self.records.append)


def _single_tree(records, trace_id):
    spans = [r for r in records if r.get("trace_id") == trace_id]
    assert spans, f"no spans for trace {trace_id}"
    ids = {r["span_id"] for r in spans}
    roots = [r for r in spans if r.get("parent_id") not in ids]
    assert len(roots) == 1, [(r["name"], r["parent_id"]) for r in roots]
    return spans, roots[0]


class TestChildTracing:
    def test_spawn_child_spans_reroot_connected(self):
        tm = get_telemetry()
        ctx = TraceContext.mint("iso-run")
        with _SpanSink() as records:
            with tm.trace_scope(ctx):
                with tm.span("lease_wait"):
                    out = IsolatedRunner(key="trace-ok", use_breaker=False).run(
                        C.traced_child, {"x": 1})
            tm.emit_span("ticket", 0.5, trace=ctx, span_id=ctx.span_id, parent_id=None)
        assert out == {"x": 1}
        spans, root = _single_tree(records, ctx.trace_id)
        assert root["name"] == "ticket"
        by_name = {r["name"]: r for r in spans}
        assert by_name["lease_wait"]["parent_id"] == root["span_id"]
        child = by_name["child_work"]
        assert child["process"] == "child"
        assert by_name["run:isolated_child"]["parent_id"] == by_name["lease_wait"]["span_id"]
        assert child["parent_id"] in {r["span_id"] for r in spans}

    def test_crashed_child_streams_spans_before_death(self):
        tm = get_telemetry()
        ctx = TraceContext.mint("crash-run")
        with _SpanSink() as records:
            with tm.trace_scope(ctx):
                with tm.span("lease_wait"):
                    with pytest.raises(CrashLoopError):
                        IsolatedRunner(key="trace-crash", max_relaunches=1,
                                       use_breaker=False).run(C.traced_crash_child, {})
            tm.emit_span("ticket", 0.5, trace=ctx, span_id=ctx.span_id, parent_id=None)
        spans, _ = _single_tree(records, ctx.trace_id)
        doomed = [r for r in spans if r["name"] == "doomed_stage"]
        assert len(doomed) == 1 and doomed[0]["process"] == "child"

    def test_untraced_launch_ships_no_trace(self):
        """A launch outside a trace gives the child no trace context,
        and the parent's environment is left as it was."""
        import os

        before = dict(os.environ)
        assert IsolatedRunner(key="plain", use_breaker=False).run(C.traced_child, 3) == 3
        assert dict(os.environ) == before
