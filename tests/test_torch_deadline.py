"""Deadlines, cancellation and supervision of the port's scan
(``deequ_tpu_torch/engine/deadline.py``, the supervised scan of
``engine/scan.py`` and ``engine/ingest.py``), against the JAX package's
``tests/test_deadline.py``.

The same seeded data and fault schedules (a hang, a slow batch, a
cancel fired from a batch's hook) go through both packages' fault
harnesses in the resident and the streamed modes (``batch_size`` 104;
``device_cache_bytes`` 1 GiB or 0). A stalled batch is retried, and
quarantined when it keeps stalling, with the JAX package's record; a
cancel or a deadline stops the scan cleanly, returning partial metrics
equal to the JAX package's over the same folded batches (counts exact,
float64 1e-12 relative), with a final checkpoint whose resume is
bit-identical to an uninterrupted run. Every supervised wait runs on an
injected ``ManualClock``: no test here sleeps a second of wall time.
"""

import signal
import threading
import time

import numpy as np
import pytest

import deequ_tpu as R
from deequ_tpu import config as rconfig
from deequ_tpu.engine.deadline import CancelToken as RCancelToken
from deequ_tpu.engine.deadline import ManualClock as RManualClock
from deequ_tpu.engine.deadline import RunBudget as RRunBudget
from deequ_tpu.engine.resilience import RetryPolicy as RRetryPolicy
from deequ_tpu.testing.faults import FaultInjectingDataset as RFaults

import deequ_tpu_torch as T
from deequ_tpu_torch import config as tconfig
from deequ_tpu_torch.analyzers import runner as trunner
from deequ_tpu_torch.engine import scan
from deequ_tpu_torch.engine.deadline import (
    AdmissionController,
    CancelToken,
    DeadlineExceeded,
    ManualClock,
    RunBudget,
    RunCancelled,
    ScanSupervisor,
    admission_controller,
    install_graceful_shutdown,
    reset_shutdown_token,
    shutdown_installed,
    shutdown_token,
)
from deequ_tpu_torch.engine.resilience import RetryPolicy, ScanStalled
from deequ_tpu_torch.interop import states_to_numpy
from deequ_tpu_torch.io.state_provider import ScanCheckpointer, ScanCursor
from deequ_tpu_torch.io.storage import LocalStorage
from deequ_tpu_torch.testing.faults import FaultInjectingDataset

RTOL = 1e-12
FAST = RetryPolicy(max_attempts=3, sleep=lambda _s: None)
RFAST = RRetryPolicy(max_attempts=3, sleep=lambda _s: None)
MODES = {"resident": 1 << 30, "streaming": 0}


@pytest.fixture(autouse=True)
def _no_wall_sleeps(monkeypatch):
    """Supervision tests never wall-sleep: a sleep over a second means a
    fake-clock path fell back to real waiting."""
    real_sleep = time.sleep

    def guarded(seconds):
        assert seconds <= 1.0, f"test slept {seconds}s of real time"
        real_sleep(seconds)

    monkeypatch.setattr(time, "sleep", guarded)
    with tconfig.configure(device="cpu"):
        yield
    assert scan.active_prefetch_workers() == []


def _table_data(n=1000, seed=0):
    rng = np.random.default_rng(seed)
    return {"a": rng.normal(size=n).tolist(), "g": (np.arange(n) % 7).tolist()}


def _analyzers(P):
    return [P.Size(), P.Completeness("a"), P.Mean("a"), P.ApproxQuantile("a", 0.5),
            P.Uniqueness(["g"])]


def _values(ctx, P):
    out = []
    for a in _analyzers(P):
        value = ctx.metric(a).value
        assert value.is_success, (a, value)
        out.append(value.get())
    return out


def _assert_close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g == pytest.approx(w, rel=RTOL, abs=0)


def _record(d):
    if d is None:
        return None
    return (d.batches_quarantined, d.rows_skipped, d.retries, d.error_classes,
            [(f.batch_index, f.rows, f.error_class, f.attempts) for f in d.failures])


def _prefix(data, rows):
    return {k: v[:rows] for k, v in data.items()}


def _port(ds, mode, engine=None, **kw):
    opts = dict(device_cache_bytes=MODES[mode], batch_size=104, scan_retry=FAST)
    opts.update(kw.pop("config", {}))
    with tconfig.configure(**opts):
        return T.AnalysisRunner.do_analysis_run(ds, _analyzers(T), engine=engine, **kw)


def _ref(ds, mode, engine=None, **kw):
    opts = dict(device_cache_bytes=MODES[mode], batch_size=104, scan_retry=RFAST)
    opts.update(kw.pop("config", {}))
    with rconfig.configure(**opts):
        return R.AnalysisRunner.do_analysis_run(ds, _analyzers(R), engine=engine, **kw)


def _stall_budget(P, stall_s=1.0, deadline_s=10_000.0):
    clock = ManualClock() if P is T else RManualClock()
    budget = RunBudget if P is T else RRunBudget
    return budget(deadline_s=deadline_s, stall_s=stall_s, clock=clock)


# -- CancelToken, RunBudget, ScanSupervisor ---------------------------------------------


class TestCancelToken:
    def test_cancel_sets_reason_and_raises(self):
        token = CancelToken()
        assert not token.cancelled and token.reason is None
        token.raise_if_cancelled()
        token.cancel("operator said stop")
        assert token.cancelled and token.reason == "operator said stop"
        with pytest.raises(RunCancelled, match="operator said stop"):
            token.raise_if_cancelled()
        token.cancel("second")
        assert token.reason == "operator said stop"

    def test_parent_cancels_children_transitively(self):
        parent = CancelToken()
        grandchild = parent.child().child()
        parent.cancel("drain")
        assert grandchild.cancelled and grandchild.reason == "drain"

    def test_child_cancel_leaves_parent_active(self):
        parent = CancelToken()
        child = parent.child()
        child.cancel("just me")
        assert child.cancelled and not parent.cancelled

    def test_linking_to_cancelled_parent_cancels_immediately(self):
        parent = CancelToken()
        parent.cancel("already gone")
        child = parent.child()
        assert child.cancelled and child.reason == "already gone"

    def test_wait(self):
        token = CancelToken()
        assert token.wait(timeout=0) is False
        token.cancel()
        assert token.wait(timeout=0) is True

    def test_interrupts_are_base_exceptions_with_the_reference_kinds(self):
        from deequ_tpu.engine import deadline as rdeadline

        for ours, theirs in ((RunCancelled, rdeadline.RunCancelled),
                             (DeadlineExceeded, rdeadline.DeadlineExceeded)):
            assert not issubclass(ours, Exception) and ours.kind == theirs.kind


class TestRunBudget:
    def test_deadline_on_manual_clock(self):
        clock = ManualClock()
        budget = RunBudget(deadline_s=10.0, clock=clock).start()
        assert budget.remaining() == 10.0
        clock.advance(4.0)
        assert budget.elapsed() == 4.0 and budget.remaining() == 6.0
        budget.check()
        clock.advance(7.0)
        assert budget.expired()
        with pytest.raises(DeadlineExceeded, match="10.0s"):
            budget.check()

    def test_start_is_idempotent(self):
        clock = ManualClock()
        budget = RunBudget(deadline_s=10.0, clock=clock).start()
        clock.advance(5.0)
        budget.start()
        assert budget.elapsed() == 5.0

    def test_no_deadline_never_expires(self):
        budget = RunBudget(stall_s=1.0, clock=ManualClock()).start()
        budget.clock.advance(1e9)
        assert budget.remaining() is None and not budget.expired()
        budget.check()

    def test_unstarted_budget_has_zero_elapsed(self):
        assert RunBudget(deadline_s=1.0, clock=ManualClock()).elapsed() == 0.0


class TestScanSupervisor:
    def test_on_wait_raises_after_stall_window(self):
        sup = ScanSupervisor(_stall_budget(T, stall_s=2.0))
        sup.clock.advance(1.0)
        sup.on_wait()
        sup.clock.advance(1.5)
        with pytest.raises(ScanStalled, match="stalled source"):
            sup.on_wait()
        assert sup.stalls == 1
        sup.on_wait()  # the raise re-armed the window

    def test_note_arrival_catches_slow_batch(self):
        sup = ScanSupervisor(_stall_budget(T, stall_s=2.0))
        sup.clock.advance(1.0)
        sup.note_arrival()
        sup.clock.advance(3.0)
        with pytest.raises(ScanStalled, match="stall limit"):
            sup.note_arrival()

    def test_watchdog_check_releases_armed_source(self):
        sup = ScanSupervisor(_stall_budget(T, stall_s=2.0))
        event = sup.arm_source()
        sup.watchdog_check()
        assert not event.is_set()
        sup.clock.advance(3.0)
        sup.watchdog_check()
        assert event.is_set() and sup.stalls == 1
        assert not sup.arm_source().is_set()

    def test_cancel_reported_before_deadline(self):
        token = CancelToken()
        sup = ScanSupervisor(RunBudget(deadline_s=1.0, clock=ManualClock()), [token])
        sup.clock.advance(5.0)
        token.cancel("explicit")
        with pytest.raises(RunCancelled, match="explicit"):
            sup.check()

    def test_watchdog_releases_source_on_cancel(self):
        token = CancelToken()
        sup = ScanSupervisor(None, [token])
        event = sup.arm_source()
        token.cancel()
        sup.watchdog_check()
        assert event.is_set()

    def test_watchdog_thread_is_joined(self):
        sup = ScanSupervisor(_stall_budget(T))
        sup.start_watchdog()
        assert any(t.name == "deequ-tpu-torch-watchdog" for t in threading.enumerate())
        sup.stop_watchdog()
        assert not any(t.name == "deequ-tpu-torch-watchdog" and t.is_alive()
                       for t in threading.enumerate())


# -- admission -----------------------------------------------------------------------------


def _spin_until(predicate, what, timeout_s=5.0):
    deadline = time.monotonic() + timeout_s
    while not predicate():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.001)


class TestAdmissionController:
    def test_fifo_ordering(self):
        ctl = AdmissionController()
        ctl.acquire(1)
        order = []

        def worker(n):
            ctl.acquire(1)
            order.append(n)
            ctl.release()

        t1 = threading.Thread(target=worker, args=(1,))
        t1.start()
        _spin_until(lambda: ctl.snapshot()["queued"] == 1, "t1 queued")
        t2 = threading.Thread(target=worker, args=(2,))
        t2.start()
        _spin_until(lambda: ctl.snapshot()["queued"] == 2, "t2 queued")
        ctl.release()
        t1.join(timeout=5)
        t2.join(timeout=5)
        assert order == [1, 2]
        assert ctl.snapshot() == {"active": 0, "queued": 0, "active_bytes": 0}

    def test_queued_run_expires_under_its_deadline(self):
        ctl = AdmissionController()
        ctl.acquire(1)
        budget = RunBudget(deadline_s=5.0, clock=ManualClock()).start()
        budget.clock.advance(10.0)
        with pytest.raises(DeadlineExceeded, match="queued for admission"):
            ctl.acquire(1, budget=budget)
        assert ctl.snapshot()["queued"] == 0
        ctl.release()

    def test_queued_run_cancellable(self):
        ctl = AdmissionController()
        ctl.acquire(1)
        token = CancelToken()
        token.cancel("gave up waiting")
        with pytest.raises(RunCancelled, match="gave up waiting"):
            ctl.acquire(1, tokens=[token])
        assert ctl.snapshot()["queued"] == 0
        ctl.release()

    def test_acquire_starts_budget_epoch(self):
        ctl = AdmissionController()
        budget = RunBudget(deadline_s=5.0, clock=ManualClock())
        ctl.acquire(4, budget=budget)
        assert budget._started_at is not None
        ctl.release()

    def test_config_knob_end_to_end(self):
        before = admission_controller().queued_total
        with tconfig.configure(max_concurrent_runs=1):
            ctx = T.AnalysisRunner.do_analysis_run(T.Dataset.from_pydict({"x": [1.0, 2.0, 3.0]}),
                                                   [T.Size()])
        assert ctx.metric(T.Size()).value.get() == 3
        assert admission_controller().queued_total == before
        assert admission_controller().snapshot()["active"] == 0

    def test_runs_past_the_limit_queue_in_order(self):
        """Three runs under ``max_concurrent_runs=1``: the first holds
        the slot inside its scan; the others start in the order they
        came."""
        data = T.Dataset.from_pydict(_table_data())
        inside, release = threading.Event(), threading.Event()
        order = []

        def hold():
            inside.set()
            assert release.wait(5)

        def run(name, ds):
            with tconfig.configure(max_concurrent_runs=1, device_cache_bytes=0, batch_size=104):
                T.AnalysisRunner.do_analysis_run(ds, [T.Size()])
            order.append(name)

        first = threading.Thread(target=run, args=(
            "first", FaultInjectingDataset(data, on_batch={0: hold})))
        first.start()
        assert inside.wait(5)
        threads = [first]
        for i, name in enumerate(("second", "third")):
            t = threading.Thread(target=run, args=(name, data))
            t.start()
            threads.append(t)
            _spin_until(lambda i=i: admission_controller().snapshot()["queued"] == i + 1,
                        f"{name} queued")
        release.set()
        for t in threads:
            t.join(10)
        assert order == ["first", "second", "third"]


class TestDurableWrites:
    def test_durable_local_write_round_trips(self, tmp_path):
        storage = LocalStorage(str(tmp_path))
        storage.write_bytes("ckpt.bin", b"payload", durable=True)
        assert storage.read_bytes("ckpt.bin") == b"payload"
        assert storage.list_keys() == ["ckpt.bin"]

    def test_checkpointer_falls_back_on_legacy_storage(self, tmp_path):
        class LegacyStorage:
            def __init__(self):
                self.blobs = {}

            def read_bytes(self, key):
                return self.blobs.get(key)

            def write_bytes(self, key, data):  # no durable keyword
                self.blobs[key] = bytes(data)

        ckpt = ScanCheckpointer(str(tmp_path))
        ckpt._storage = LegacyStorage()
        ckpt.save(ScanCursor(3, 312, "fp", 104), "tok", (), {}, None)
        assert ckpt.load("fp", "tok")["cursor"].batch_index == 3


# -- the supervised scan against the JAX package -----------------------------------------------


@pytest.mark.parametrize("mode", list(MODES))
class TestEngineSupervision:
    def test_stall_retried_then_bit_identical(self, mode):
        data = _table_data()
        clean = _values(_port(T.Dataset.from_pydict(data), mode), T)
        budget = _stall_budget(T)
        ds = FaultInjectingDataset(T.Dataset.from_pydict(data), hang_at_batch={3: 1},
                                   clock=budget.clock)
        ctx = _port(ds, mode, engine=T.AnalysisEngine(budget=budget))
        assert _values(ctx, T) == clean
        assert ("hang", 3) in ds.faults_fired
        assert ctx.degradation is not None and ctx.degradation.retries >= 1
        assert not ctx.degradation.is_degraded and ctx.interruption is None
        rbudget = _stall_budget(R)
        rctx = _ref(RFaults(R.Dataset.from_pydict(data), hang_at_batch={3: 1},
                            clock=rbudget.clock), mode, engine=R.AnalysisEngine(budget=rbudget))
        _assert_close(_values(ctx, T), _values(rctx, R))

    def test_persistent_stall_quarantined_and_run_completes(self, mode):
        budget = _stall_budget(T)
        ds = FaultInjectingDataset(T.Dataset.from_pydict(_table_data()), hang_at_batch={3: 99},
                                   clock=budget.clock)
        ctx = _port(ds, mode, engine=T.AnalysisEngine(budget=budget))
        rbudget = _stall_budget(R)
        rctx = _ref(RFaults(R.Dataset.from_pydict(_table_data()), hang_at_batch={3: 99},
                            clock=rbudget.clock), mode, engine=R.AnalysisEngine(budget=rbudget))
        want = (1, 104, 2, ["ScanStalled"], [(3, 104, "ScanStalled", 3)])
        assert _record(ctx.degradation) == want
        # the JAX package's prefetch thread can stall once more while it
        # is torn down, so its streamed count of retries varies from run
        # to run (2 to 4 seen); every other field is fixed
        got = _record(rctx.degradation)
        assert got[:2] + got[3:] == want[:2] + want[3:] and got[2] >= want[2]
        assert ctx.metric(T.Size()).value.get() == 1000 - 104
        assert not budget.expired() and ctx.interruption is None
        _assert_close(_values(ctx, T), _values(rctx, R))

    def test_cancel_mid_scan_checkpoints_then_resume_bit_identical(self, mode, tmp_path):
        data = _table_data()
        keep_clean, keep_resumed = {}, {}

        class Keep:
            def __init__(self, into):
                self.into = into

            def persist(self, analyzer, state):
                self.into[repr(analyzer)] = {k: np.asarray(v).tobytes()
                                             for k, v in states_to_numpy(state).items()}

        clean = _values(_port(T.Dataset.from_pydict(data), mode,
                              save_states_with=Keep(keep_clean)), T)
        token = CancelToken()
        ds = FaultInjectingDataset(T.Dataset.from_pydict(data),
                                   on_batch={5: lambda: token.cancel("user clicked stop")})
        ckpt = ScanCheckpointer(str(tmp_path))
        ctx = _port(ds, mode, engine=T.AnalysisEngine(checkpointer=ckpt), cancel=token,
                    config=dict(checkpoint_every_batches=100))
        interruption = ctx.interruption
        assert interruption.kind == "cancelled" and "user clicked stop" in interruption.reason
        assert interruption.checkpointed and 0 < interruption.batch_index < 10
        assert interruption.row_offset == interruption.batch_index * 104
        assert ckpt._storage.list_keys("scan-ckpt-")
        # partial metrics are the JAX package's over exactly the folded rows
        folded = interruption.batch_index * 104
        assert ctx.metric(T.Size()).value.get() == folded
        _assert_close(_values(ctx, T),
                      _values(_ref(R.Dataset.from_pydict(_prefix(data, folded)), mode), R))
        resumed = _port(T.Dataset.from_pydict(data), mode,
                        engine=T.AnalysisEngine(checkpointer=ckpt),
                        save_states_with=Keep(keep_resumed),
                        config=dict(checkpoint_every_batches=100))
        assert _values(resumed, T) == clean and keep_resumed == keep_clean
        assert resumed.interruption is None
        assert ckpt._storage.list_keys("scan-ckpt-") == []

    def test_pre_cancelled_run_returns_cleanly(self, mode):
        token = CancelToken()
        token.cancel("cancelled before start")
        ctx = _port(T.Dataset.from_pydict(_table_data()), mode, cancel=token)
        rtoken = RCancelToken()
        rtoken.cancel("cancelled before start")
        rctx = _ref(R.Dataset.from_pydict(_table_data()), mode, cancel=rtoken)
        assert ctx.interruption.to_dict() == rctx.interruption.to_dict()
        assert ctx.interruption.batch_index == 0 and not ctx.interruption.checkpointed
        assert ctx.metric(T.Size()).value.get() == rctx.metric(R.Size()).value.get() == 0


class TestDeadlineMidScan:
    def test_slow_batch_burns_deadline_partial_metrics(self):
        data = _table_data()
        budget = RunBudget(deadline_s=10.0, clock=ManualClock())
        ds = FaultInjectingDataset(T.Dataset.from_pydict(data), slow_batch={2: 50.0},
                                   clock=budget.clock)
        ctx = _port(ds, "resident", engine=T.AnalysisEngine(budget=budget))
        rbudget = RRunBudget(deadline_s=10.0, clock=RManualClock())
        rctx = _ref(RFaults(R.Dataset.from_pydict(data), slow_batch={2: 50.0},
                            clock=rbudget.clock), "resident",
                    engine=R.AnalysisEngine(budget=rbudget))
        assert ctx.interruption.kind == rctx.interruption.kind == "deadline"
        assert ctx.interruption.batch_index == rctx.interruption.batch_index == 2
        assert ctx.metric(T.Size()).value.get() == 2 * 104
        _assert_close(_values(ctx, T), _values(rctx, R))
        _assert_close(_values(ctx, T),
                      _values(_ref(R.Dataset.from_pydict(_prefix(data, 208)), "resident"), R))

    def test_config_deadline_knob(self):
        with tconfig.configure(run_deadline_seconds=1e-9, device_cache_bytes=0, batch_size=104):
            ctx = T.AnalysisRunner.do_analysis_run(T.Dataset.from_pydict(_table_data()),
                                                   _analyzers(T))
        assert ctx.interruption is not None and ctx.interruption.kind == "deadline"

    def test_interrupted_run_starts_no_deferred_pass(self):
        """The deferred re-read of a grouping plan would be another pass
        over the source: an interrupted run fails it with the reason."""
        token = CancelToken()
        token.cancel("stop now")
        data = T.Dataset.from_pydict({"id": list(range(1000))})
        # the host group-by: a deferred plan, after the scan of Size
        host = dict(device_cache_bytes=0, batch_size=104, dense_grouping_budget_bytes=8,
                    device_spill_grouping=False)
        with tconfig.configure(**host):
            ctx = T.AnalysisRunner.do_analysis_run(data, [T.Size(), T.CountDistinct(["id"])],
                                                   cancel=token)
            clean = T.AnalysisRunner.do_analysis_run(data, [T.Size(), T.CountDistinct(["id"])])
        assert ctx.interruption.kind == "cancelled"
        value = ctx.metric(T.CountDistinct(["id"])).value
        assert value.is_failure and "stop now" in str(value.exception)
        assert clean.metric(T.CountDistinct(["id"])).value.get() == 1000


def test_cancelled_token_stops_the_collector_finalize():
    from deequ_tpu_torch.analyzers.grouping import finalize_collector_states
    from deequ_tpu_torch.analyzers.base import MetricCalculationException

    class Spec:
        plan = "p"

        def dispatch(self, state):
            raise AssertionError("a cancelled finalize launches no sort")

    token = CancelToken()
    token.cancel("drain")
    out = finalize_collector_states([Spec()], [None], T.AnalysisEngine(), isolate=True,
                                    cancel=token)
    assert isinstance(out["p"], MetricCalculationException) and "drain" in str(out["p"])
    with pytest.raises(RunCancelled, match="drain"):
        finalize_collector_states([Spec()], [None], T.AnalysisEngine(), cancel=token)


# -- verification status and the builders -------------------------------------------------------


class TestInterruptionFloorsVerification:
    def _results(self, policy):
        def run(P, cfg, faults, token):
            check = P.Check(P.CheckLevel.ERROR, "robust").has_size(lambda s: s > 0)
            ds = faults(P.Dataset.from_pydict(_table_data()), on_batch={5: lambda: token.cancel(
                "drain")})
            with cfg.configure(device_cache_bytes=0, batch_size=104, degradation_policy=policy):
                return P.VerificationSuite.do_verification_run(ds, [check], cancel=token)

        return (run(R, rconfig, RFaults, RCancelToken()),
                run(T, tconfig, FaultInjectingDataset, CancelToken()))

    @pytest.mark.parametrize("policy,status", [("fail", "Error"), ("warn", "Warning"),
                                               ("tolerate", "Success")])
    def test_policy_floors_as_the_reference(self, policy, status):
        ref, port = self._results(policy)
        assert port.status.value == ref.status.value == status
        assert port.interruption.kind == ref.interruption.kind == "cancelled"

    def test_builders_wire_deadline_and_cancel(self):
        token = CancelToken()
        token.cancel("pre-cancelled")
        data = T.Dataset.from_pydict(_table_data())
        check = T.Check(T.CheckLevel.ERROR, "x").has_size(lambda s: s == 1000)
        result = T.VerificationSuite().on_data(data).add_check(check).with_cancel(token).run()
        assert result.interruption is not None and result.status == T.CheckStatus.ERROR
        budget = RunBudget(deadline_s=1.0, clock=ManualClock()).start()
        budget.clock.advance(2.0)
        result = T.VerificationSuite().on_data(data).add_check(check).with_deadline(budget).run()
        assert result.interruption.kind == "deadline"
        ctx = (T.AnalysisRunner.on_data(data).add_analyzer(T.Size()).with_cancel(token).run())
        assert ctx.interruption.kind == "cancelled"
        ctx = T.AnalysisRunner.on_data(data).add_analyzer(T.Size()).with_deadline(3600.0).run()
        assert ctx.interruption is None and ctx.metric(T.Size()).value.get() == 1000


class TestGracefulShutdown:
    def test_sigterm_maps_to_shutdown_token(self):
        uninstall = install_graceful_shutdown()
        try:
            assert shutdown_installed() and not shutdown_token().cancelled
            signal.raise_signal(signal.SIGTERM)
            assert shutdown_token().cancelled and "SIGTERM" in shutdown_token().reason
        finally:
            uninstall()
            reset_shutdown_token()
        assert not shutdown_installed() and not shutdown_token().cancelled

    def test_sigterm_mid_scan_exits_with_provenance(self):
        uninstall = T.VerificationSuite.install_graceful_shutdown()
        try:
            ds = FaultInjectingDataset(
                T.Dataset.from_pydict(_table_data()),
                on_batch={3: lambda: signal.raise_signal(signal.SIGTERM)})
            ctx = _port(ds, "resident")
            assert ctx.interruption.kind == "cancelled"
            assert "SIGTERM" in ctx.interruption.reason
            assert ctx.interruption.batch_index == 3
            assert ctx.metric(T.Size()).value.get() == 3 * 104
        finally:
            uninstall()
            reset_shutdown_token()


class TestProfilerEnvelope:
    def test_interrupted_pass_skips_the_rest(self, monkeypatch):
        runs = []
        do_run = trunner.AnalysisRunner.do_analysis_run

        def counting(*a, **kw):
            runs.append(kw.get("cancel"))
            return do_run(*a, **kw)

        monkeypatch.setattr(trunner.AnalysisRunner, "do_analysis_run", staticmethod(counting))
        data = {"n": [str(i) for i in range(300)], "k": list(range(300))}
        token = CancelToken()
        token.cancel("budget spent elsewhere")
        with tconfig.configure(device_cache_bytes=0, batch_size=104):
            profiles = T.ColumnProfiler.profile(T.Dataset.from_pydict(data), cancel=token)
        assert profiles.interruption is not None and len(runs) == 1
        runs.clear()
        with tconfig.configure(device_cache_bytes=0, batch_size=104):
            profiles = T.ColumnProfiler.profile(T.Dataset.from_pydict(data))
        assert profiles.interruption is None and len(runs) >= 2  # pass 2 for "n"

    def test_float_deadline_becomes_shared_budget(self):
        with tconfig.configure(device_cache_bytes=0, batch_size=104):
            profiles = T.ColumnProfiler.profile(T.Dataset.from_pydict(_table_data()),
                                                deadline=3600.0)
        assert profiles.interruption is None and profiles.num_records == 1000

    def test_one_budget_spans_the_passes(self):
        """A deadline spent during pass 1 (a slow batch on the budget's
        clock) stops the profile: the later passes never start."""
        clock = ManualClock()
        budget = RunBudget(deadline_s=10.0, clock=clock)
        data = {"n": [str(i) for i in range(300)], "k": list(range(300))}
        ds = FaultInjectingDataset(T.Dataset.from_pydict(data), slow_batch={1: 50.0}, clock=clock)
        with tconfig.configure(device_cache_bytes=1 << 30, batch_size=104):
            profiles = T.ColumnProfiler.profile(ds, deadline=budget)
        assert profiles.interruption.kind == "deadline"
        assert profiles.interruption.batch_index == 1
