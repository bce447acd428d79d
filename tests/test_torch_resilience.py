"""The port's batch-level resilience (``deequ_tpu_torch/engine/
resilience.py``, the scan of ``engine/scan.py``, ``io/state_provider.py::
ScanCheckpointer`` and ``testing/faults.py``) against the JAX package's.

The same seeded data and the same fault schedule go through
``deequ_tpu.testing.faults.FaultInjectingDataset`` around a JAX-package
``Dataset`` and through the port's around a port ``Dataset``, in the
resident and the streamed modes of ``tests/test_resilience.py``
(``batch_size`` 104; ``device_cache_bytes`` 1 GiB or 0). Metrics agree
with the tolerances of the port's differentials (counts exact, float64
1e-12 relative), and the degradation records agree field for field:
retries, batches quarantined, rows skipped, error classes, and each
quarantined batch's index, rows, class and attempts. A killed scan
resumes from its checkpoint bit-identical (every state as bits) to an
uninterrupted run. Every retry sleeps through an injected recorder: no
test waits wall time.
"""

import numpy as np
import pytest

import deequ_tpu as R
from deequ_tpu import config as rconfig
from deequ_tpu.engine.resilience import RetryPolicy as RRetryPolicy
from deequ_tpu.engine.resilience import ScanKilled as RScanKilled
from deequ_tpu.io.state_provider import ScanCheckpointer as RScanCheckpointer
from deequ_tpu.io.state_provider import ScanCursor as RScanCursor
from deequ_tpu.testing.faults import FaultInjectingDataset as RFaults

import deequ_tpu_torch as T
from deequ_tpu_torch import config as tconfig
from deequ_tpu_torch.engine import scan
from deequ_tpu_torch.engine.resilience import (
    BatchIntegrityError,
    RetryPolicy,
    ScanDegradation,
    ScanKilled,
    TransientScanError,
    is_transient,
    resilient_batches,
    retry_transient,
)
from deequ_tpu_torch.interop import states_to_numpy
from deequ_tpu_torch.io.state_provider import ScanCheckpointer, ScanCursor
from deequ_tpu_torch.testing.faults import FaultInjectingDataset

RTOL = 1e-12
FAST = RetryPolicy(max_attempts=3, sleep=lambda _s: None)
RFAST = RRetryPolicy(max_attempts=3, sleep=lambda _s: None)
MODES = {
    "resident": dict(device_cache_bytes=1 << 30, batch_size=104),
    "streaming": dict(device_cache_bytes=0, batch_size=104),
}


@pytest.fixture(autouse=True)
def _cpu():
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
    """A degradation record as comparable fields (None for none)."""
    if d is None:
        return None
    return (d.batches_quarantined, d.rows_skipped, d.retries, d.error_classes,
            [(f.batch_index, f.rows, f.error_class, f.attempts) for f in d.failures])


class _Keep:
    def __init__(self):
        self.states = {}

    def persist(self, analyzer, state):
        self.states[repr(analyzer)] = state


def _bits(keep):
    return {k: {f: (np.asarray(v).dtype.str, np.asarray(v).tobytes())
                for f, v in states_to_numpy(s).items()}
            for k, s in keep.states.items()}


def _port_run(ds, mode, engine=None, **overrides):
    keep = _Keep()
    with tconfig.configure(scan_retry=FAST, **MODES[mode], **overrides):
        ctx = T.AnalysisRunner.do_analysis_run(ds, _analyzers(T), engine=engine,
                                               save_states_with=keep)
    return ctx, keep


def _ref_run(ds, mode, engine=None, **overrides):
    with rconfig.configure(scan_retry=RFAST, **MODES[mode], **overrides):
        return R.AnalysisRunner.do_analysis_run(ds, _analyzers(R), engine=engine)


def _both(mode, faults, data=None, **overrides):
    """(JAX package's context, port's context) of one fault schedule."""
    data = data or _table_data()
    rctx = _ref_run(RFaults(R.Dataset.from_pydict(data), **faults), mode, **overrides)
    tctx, _ = _port_run(FaultInjectingDataset(T.Dataset.from_pydict(data), **faults), mode,
                        **overrides)
    return rctx, tctx


# -- RetryPolicy --------------------------------------------------------------------


class TestRetryPolicy:
    @pytest.mark.parametrize("seed", [0, 1, 7, 12345])
    def test_delays_equal_the_reference_on_a_grid(self, seed):
        kw = dict(backoff_base_s=0.1, backoff_multiplier=2.0, backoff_max_s=2.0, jitter=0.25,
                  seed=seed)
        ours, theirs = RetryPolicy(**kw), RRetryPolicy(**kw)
        for batch in range(12):
            for attempt in range(1, 7):
                assert ours.delay_s(batch, attempt) == theirs.delay_s(batch, attempt)

    def test_delay_is_deterministic_and_jitter_bounded(self):
        policy = RetryPolicy(backoff_base_s=0.1, backoff_multiplier=2.0, jitter=0.25)
        for batch in range(5):
            for attempt in range(1, 4):
                d = policy.delay_s(batch, attempt)
                assert d == policy.delay_s(batch, attempt)
                base = min(0.1 * 2.0 ** (attempt - 1), policy.backoff_max_s)
                assert base * 0.75 <= d <= base * 1.25
        assert len({policy.delay_s(b, a) for b in range(5) for a in range(1, 4)}) > 5

    def test_delay_respects_cap_and_zero_jitter(self):
        assert RetryPolicy(backoff_base_s=1.0, backoff_max_s=2.0, jitter=0.0).delay_s(0, 10) == 2.0

    def test_sleep_is_injectable(self):
        recorded = []
        RetryPolicy(sleep=recorded.append).sleep_for(1234.5)
        assert recorded == [1234.5]

    def test_transient_taxonomy(self):
        assert is_transient(TransientScanError("x")) and is_transient(OSError("io"))
        assert is_transient(TimeoutError("slow")) and is_transient(T.ScanStalled("hung"))
        assert not is_transient(ValueError("decode"))
        assert not is_transient(BatchIntegrityError("short"))
        assert not issubclass(ScanKilled, Exception)


class TestRetryTransient:
    def test_retries_then_succeeds(self):
        sleeps = []
        policy = RetryPolicy(max_attempts=3, sleep=sleeps.append)
        degr = ScanDegradation()
        calls = {"n": 0}

        def flaky():
            calls["n"] += 1
            if calls["n"] < 3:
                raise TransientScanError("hiccup")
            return "ok"

        assert retry_transient(flaky, policy, 7, degr) == "ok"
        assert calls["n"] == 3 and degr.retries == 2
        assert sleeps == [policy.delay_s(7, 1), policy.delay_s(7, 2)]

    def test_deterministic_error_never_retried(self):
        degr = ScanDegradation()
        with pytest.raises(ValueError):
            retry_transient(lambda: (_ for _ in ()).throw(ValueError("decode")), FAST, 0, degr)
        assert degr.retries == 0

    def test_exhaustion_reraises(self):
        degr = ScanDegradation()
        with pytest.raises(TransientScanError):
            retry_transient(lambda: (_ for _ in ()).throw(TransientScanError("x")), FAST, 0, degr)
        assert degr.retries == FAST.max_attempts - 1


class TestPrefetched:
    def test_yields_then_raises_original_exception(self):
        def source():
            yield 1
            yield 2
            raise TransientScanError("read failed mid-stream")

        got = []
        with pytest.raises(TransientScanError, match="mid-stream") as info:
            for item in scan._prefetched(source(), 2):
                got.append(item)
        assert got == [1, 2]
        tb, frames = info.value.__traceback__, []
        while tb is not None:
            frames.append(tb.tb_frame.f_code.co_name)
            tb = tb.tb_next
        assert "source" in frames

    def test_clean_iteration_unchanged(self):
        assert list(scan._prefetched(iter(range(10)), 2)) == list(range(10))

    def test_immediate_error_propagates(self):
        def dead():
            raise OSError("no such source")
            yield  # pragma: no cover

        with pytest.raises(OSError, match="no such source"):
            list(scan._prefetched(dead(), 2))


# -- resilient_batches -----------------------------------------------------------------


class TestResilientBatches:
    def _drive(self, make_iter, validate=None, policy=FAST):
        degr = ScanDegradation()
        items = list(resilient_batches(make_iter, policy, degr, rows_for=lambda i: 10,
                                       validate=validate))
        return items, degr

    def test_transient_restarts_from_failing_index(self):
        ledger = {"fails_left": 2, "starts": []}

        def make_iter(start):
            ledger["starts"].append(start)

            def gen():
                for i in range(start, 6):
                    if i == 3 and ledger["fails_left"] > 0:
                        ledger["fails_left"] -= 1
                        raise TransientScanError("flaky batch 3")
                    yield f"item{i}"

            return gen()

        items, degr = self._drive(make_iter)
        assert items == [(i, f"item{i}") for i in range(6)]
        assert ledger["starts"] == [0, 3, 3]
        assert degr.retries == 2 and not degr.is_degraded

    def test_exhaustion_quarantines_and_continues(self):
        def make_iter(start):
            def gen():
                for i in range(start, 5):
                    if i == 2:
                        raise TransientScanError("always fails")
                    yield i

            return gen()

        items, degr = self._drive(make_iter)
        assert [i for i, _ in items] == [0, 1, 3, 4]
        assert degr.batches_quarantined == 1 and degr.rows_skipped == 10
        assert degr.failures[0].batch_index == 2
        assert degr.failures[0].attempts == FAST.max_attempts

    def test_deterministic_error_quarantines_immediately(self):
        starts = []

        def make_iter(start):
            starts.append(start)

            def gen():
                for i in range(start, 4):
                    if i == 1:
                        raise ValueError("bad decode")
                    yield i

            return gen()

        items, degr = self._drive(make_iter)
        assert [i for i, _ in items] == [0, 2, 3]
        assert degr.failures[0].attempts == 1 and degr.failures[0].error_class == "ValueError"
        assert starts == [0, 2]

    def test_validate_quarantines_without_restart(self):
        starts = []

        def make_iter(start):
            starts.append(start)
            return iter(range(start, 5))

        def validate(index, item):
            if item == 3:
                raise BatchIntegrityError("short batch")

        items, degr = self._drive(make_iter, validate=validate)
        assert [x for _, x in items] == [0, 1, 2, 4]
        assert degr.batches_quarantined == 1 and starts == [0]

    def test_scan_killed_passes_through_and_closes_the_source(self):
        closed = []

        def make_iter(start):
            def gen():
                try:
                    yield 0
                    raise ScanKilled("process death")
                finally:
                    closed.append(start)

            return gen()

        degr = ScanDegradation()
        with pytest.raises(ScanKilled):
            list(resilient_batches(make_iter, FAST, degr, rows_for=lambda i: 1))
        assert not degr.is_degraded and closed == [0]


class TestScanDegradationRecord:
    def test_merge(self):
        a = ScanDegradation()
        a.record_quarantine(1, 100, ValueError("x"), 1)
        b = ScanDegradation()
        b.record_quarantine(5, 50, OSError("y"), 3)
        b.record_retry()
        merged = a.merge(b)
        assert (merged.batches_quarantined, merged.rows_skipped, merged.retries) == (2, 150, 1)
        assert merged.error_classes == ["OSError", "ValueError"]
        assert ScanDegradation.merge_optional(None, a) is a
        assert ScanDegradation.merge_optional(a, None) is a

    def test_to_dict_matches_the_reference(self):
        from deequ_tpu.engine.resilience import ScanDegradation as RDegradation

        ours, theirs = ScanDegradation(), RDegradation()
        for d in (ours, theirs):
            d.record_quarantine(2, 10, ValueError("boom"), 2)
            d.record_retry()
        assert ours.to_dict() == theirs.to_dict()


# -- the engine against the JAX package --------------------------------------------------


@pytest.mark.parametrize("mode", list(MODES))
class TestEngineResilience:
    def test_transient_faults_bit_identical(self, mode):
        data = _table_data()
        clean, clean_keep = _port_run(T.Dataset.from_pydict(data), mode)
        rctx, tctx = _both(mode, dict(transient={2: 1, 5: 2}), data)
        _assert_close(_values(tctx, T), _values(rctx, R))
        assert _values(tctx, T) == _values(clean, T)
        assert _record(tctx.degradation) == _record(rctx.degradation) == (0, 0, 3, [], [])

    def test_permanent_fault_quarantines_and_completes(self, mode):
        rctx, tctx = _both(mode, dict(permanent={3}))
        _assert_close(_values(tctx, T), _values(rctx, R))
        assert _record(tctx.degradation) == _record(rctx.degradation)
        assert _record(tctx.degradation) == (1, 104, 0, ["ValueError"],
                                             [(3, 104, "ValueError", 1)])
        assert tctx.degradation.failures[0].message == rctx.degradation.failures[0].message
        assert tctx.metric(T.Size()).value.get() == 1000 - 104

    def test_retry_exhaustion_quarantines(self, mode):
        with rconfig.configure(scan_retry=RRetryPolicy(max_attempts=2, sleep=lambda _s: None),
                               **MODES[mode]):
            rctx = R.AnalysisRunner.do_analysis_run(
                RFaults(R.Dataset.from_pydict(_table_data()), transient={4: 99}), _analyzers(R))
        with tconfig.configure(scan_retry=RetryPolicy(max_attempts=2, sleep=lambda _s: None),
                               **MODES[mode]):
            tctx = T.AnalysisRunner.do_analysis_run(
                FaultInjectingDataset(T.Dataset.from_pydict(_table_data()), transient={4: 99}),
                _analyzers(T))
        assert _record(tctx.degradation) == _record(rctx.degradation)
        assert tctx.degradation.failures[0].error_class == "TransientScanError"
        assert tctx.degradation.failures[0].attempts == 2
        _assert_close(_values(tctx, T), _values(rctx, R))

    def test_kill_then_resume_bit_identical(self, mode, tmp_path):
        data = _table_data()
        _, clean_keep = _port_run(T.Dataset.from_pydict(data), mode)
        clean = _values(_port_run(T.Dataset.from_pydict(data), mode)[0], T)
        ckpt = ScanCheckpointer(str(tmp_path / "port"))
        engine = T.AnalysisEngine(checkpointer=ckpt)
        ds = FaultInjectingDataset(T.Dataset.from_pydict(data), kill_at_batch=7)
        with pytest.raises(ScanKilled):
            _port_run(ds, mode, engine=engine, checkpoint_every_batches=3)
        assert [c["batch_index"] for c in engine.checkpoints] == [3, 6]
        assert all(c["fetches"] == 1 and c["bytes"] > 0 for c in engine.checkpoints)
        assert ckpt._storage.list_keys("scan-ckpt-")
        fetches = engine.device_fetches
        ctx, keep = _port_run(ds, mode, engine=engine, checkpoint_every_batches=3)
        # resumed at batch 6: one checkpoint (batch 9) and the final fetch
        assert [c["batch_index"] for c in engine.checkpoints] == [9]
        assert engine.device_fetches - fetches == 2
        assert _values(ctx, T) == clean and _bits(keep) == _bits(clean_keep)
        assert ckpt._storage.list_keys("scan-ckpt-") == []
        # the JAX package's own kill and resume lands on the same metrics
        rckpt = RScanCheckpointer(str(tmp_path / "ref"))
        rengine = R.AnalysisEngine(checkpointer=rckpt)
        rds = RFaults(R.Dataset.from_pydict(data), kill_at_batch=7)
        with pytest.raises(RScanKilled):
            _ref_run(rds, mode, engine=rengine, checkpoint_every_batches=3)
        _assert_close(_values(ctx, T),
                      _values(_ref_run(rds, mode, engine=rengine, checkpoint_every_batches=3), R))

    def test_source_fingerprint_invalidates_checkpoint(self, mode, tmp_path):
        ckpt = ScanCheckpointer(str(tmp_path))
        ds = FaultInjectingDataset(T.Dataset.from_pydict(_table_data(seed=0)), kill_at_batch=7)
        with pytest.raises(ScanKilled):
            _port_run(ds, mode, engine=T.AnalysisEngine(checkpointer=ckpt),
                      checkpoint_every_batches=3)
        assert ckpt._storage.list_keys("scan-ckpt-")
        other = T.Dataset.from_pydict(_table_data(seed=1))
        engine = T.AnalysisEngine(checkpointer=ckpt)
        ctx, _ = _port_run(other, mode, engine=engine, checkpoint_every_batches=3)
        # no resume: every batch scanned, from batch 0
        assert [c["batch_index"] for c in engine.checkpoints] == [3, 6, 9]
        ref = _values(_port_run(T.Dataset.from_pydict(_table_data(seed=1)), mode)[0], T)
        assert _values(ctx, T) == ref
        _assert_close(ref, _values(_ref_run(R.Dataset.from_pydict(_table_data(seed=1)), mode), R))


class TestCorruptBatches:
    def test_corrupt_streamed_batch_quarantined_as_the_reference(self):
        rctx, tctx = _both("streaming", dict(corrupt={1}))
        assert _record(tctx.degradation) == _record(rctx.degradation)
        assert tctx.degradation.error_classes == ["BatchIntegrityError"]
        assert tctx.metric(T.Size()).value.get() == 1000 - 104
        _assert_close(_values(tctx, T), _values(rctx, R))

    def test_corrupt_resident_batch_quarantined(self):
        # the JAX package's resident chunks are device stacks, which its
        # harness never truncates; the port's resident batches are views,
        # checked against their batch's row count
        tctx, _ = _port_run(FaultInjectingDataset(T.Dataset.from_pydict(_table_data()),
                                                  corrupt={1}), "resident")
        assert _record(tctx.degradation) == (1, 104, 0, ["BatchIntegrityError"],
                                             [(1, 104, "BatchIntegrityError", 1)])
        assert tctx.metric(T.Size()).value.get() == 1000 - 104


# -- degradation -> verification status ---------------------------------------------------


class TestDegradationPolicy:
    def _results(self, policy):
        def run(P, cfg, faults):
            check = (P.Check(P.CheckLevel.ERROR, "robust checks")
                     .has_completeness("a", lambda v: v == 1.0).has_size(lambda s: s > 0))
            ds = faults(P.Dataset.from_pydict(_table_data()), permanent={2})
            with cfg.configure(device_cache_bytes=0, batch_size=104, degradation_policy=policy,
                               scan_retry=FAST if P is T else RFAST):
                return P.VerificationSuite.do_verification_run(ds, [check])

        return run(R, rconfig, RFaults), run(T, tconfig, FaultInjectingDataset)

    @pytest.mark.parametrize("policy,status", [("fail", "Error"), ("warn", "Warning"),
                                               ("tolerate", "Success")])
    def test_policy_floors_the_status_as_the_reference(self, policy, status):
        ref, port = self._results(policy)
        assert port.status.value == ref.status.value == status
        assert _record(port.degradation) == _record(ref.degradation)
        assert port.degradation.rows_skipped == 104

    def test_invalid_policy_rejected(self):
        with pytest.raises(ValueError, match="degradation_policy"):
            self._results("yolo")

    def test_clean_run_has_no_degradation(self):
        check = T.Check(T.CheckLevel.ERROR, "ok").has_size(lambda s: s == 1000)
        with tconfig.configure(device_cache_bytes=0, batch_size=104):
            result = T.VerificationSuite.do_verification_run(
                T.Dataset.from_pydict(_table_data()), [check])
        assert result.status == T.CheckStatus.SUCCESS
        assert result.degradation is None and result.interruption is None


# -- ScanCheckpointer --------------------------------------------------------------------


class TestScanCheckpointer:
    def _cursor(self, fp="parquet-abc", batch_size=64):
        return ScanCursor(batch_index=6, row_offset=384, source_fingerprint=fp,
                          batch_size=batch_size)

    def test_save_load_roundtrip(self, tmp_path):
        ckpt = ScanCheckpointer(str(tmp_path))
        states = ({"count": np.int64(7)}, np.arange(4))
        degr = ScanDegradation()
        degr.record_quarantine(1, 64, ValueError("x"), 1)
        assert ckpt.save(self._cursor(), "tok1", states, {0: [1.0, 2.0]}, degr) > 0
        payload = ckpt.load("parquet-abc", "tok1")
        assert payload["cursor"].batch_index == 6
        assert payload["host_accs"] == {0: [1.0, 2.0]}
        assert payload["degradation"].batches_quarantined == 1
        np.testing.assert_array_equal(payload["states"][1], np.arange(4))

    def test_wrong_fingerprint_or_token_is_none(self, tmp_path):
        ckpt = ScanCheckpointer(str(tmp_path))
        ckpt.save(self._cursor(), "tok1", (), {}, None)
        assert ckpt.load("parquet-OTHER", "tok1") is None
        assert ckpt.load("parquet-abc", "tok2") is None

    def test_corrupt_blob_is_none(self, tmp_path):
        ckpt = ScanCheckpointer(str(tmp_path))
        ckpt.save(self._cursor(), "tok1", (), {}, None)
        key = ckpt._key("tok1")
        blob = ckpt._storage.read_bytes(key)
        ckpt._storage.write_bytes(key, blob[: len(blob) // 2])
        assert ckpt.load("parquet-abc", "tok1") is None
        ckpt._storage.write_bytes(key, b"not a pickle at all")
        assert ckpt.load("parquet-abc", "tok1") is None

    def test_clear(self, tmp_path):
        ckpt = ScanCheckpointer(str(tmp_path))
        ckpt.save(self._cursor(), "tok1", (), {}, None)
        ckpt.save(self._cursor(), "tok2", (), {}, None)
        ckpt.clear("tok1")
        assert ckpt.load("parquet-abc", "tok1") is None
        assert ckpt.load("parquet-abc", "tok2") is not None
        ckpt.clear()
        assert ckpt._storage.list_keys("scan-ckpt-") == []

    def test_interval_falls_back_to_config(self, tmp_path):
        assert ScanCheckpointer(str(tmp_path), every_batches=5).interval() == 5
        with tconfig.configure(checkpoint_every_batches=17):
            assert ScanCheckpointer(str(tmp_path)).interval() == 17
        assert tconfig.options().checkpoint_every_batches == \
            rconfig.options().checkpoint_every_batches == 64

    def test_mem_uri_backend(self):
        ckpt = ScanCheckpointer("mem://ckpt-test-port")
        ckpt.save(self._cursor(), "tok1", (), {}, None)
        assert ckpt.load("parquet-abc", "tok1") is not None
        ckpt.clear()
        assert ckpt._storage.list_keys("scan-ckpt-") == []

    def test_reference_blob_loads_as_none(self, tmp_path):
        """Checkpoints are per-package: the JAX package's blob, under the
        very key the port reads, loads as None (never an exception), and
        a run over it starts fresh."""
        RScanCheckpointer(str(tmp_path)).save(
            RScanCursor(6, 384, "parquet-abc", 64), "tok1", (np.arange(4),), {}, None)
        ckpt = ScanCheckpointer(str(tmp_path))
        assert ckpt._storage.read_bytes(ckpt._key("tok1")) is not None
        assert ckpt.load("parquet-abc", "tok1") is None

    def test_reference_blob_under_a_real_plan_starts_fresh(self, tmp_path):
        data = _table_data()
        ckpt = ScanCheckpointer(str(tmp_path))
        ds = FaultInjectingDataset(T.Dataset.from_pydict(data), kill_at_batch=7)
        with pytest.raises(ScanKilled):
            _port_run(ds, "streaming", engine=T.AnalysisEngine(checkpointer=ckpt),
                      checkpoint_every_batches=3)
        (key,) = ckpt._storage.list_keys("scan-ckpt-")
        token = key[len("scan-ckpt-"):-len(".pkl")]
        fingerprint = ds.fingerprint()
        RScanCheckpointer(str(tmp_path)).save(RScanCursor(6, 624, fingerprint, 104), token,
                                              (np.arange(4),), {}, None)
        engine = T.AnalysisEngine(checkpointer=ckpt)
        ctx, _ = _port_run(T.Dataset.from_pydict(data), "streaming", engine=engine,
                           checkpoint_every_batches=3)
        assert [c["batch_index"] for c in engine.checkpoints] == [3, 6, 9]
        assert _values(ctx, T) == _values(_port_run(T.Dataset.from_pydict(data),
                                                    "streaming")[0], T)


class TestSourceFingerprints:
    def test_in_memory_fingerprint_tracks_content(self):
        a = T.Dataset.from_pydict({"x": [1.0, 2.0, 3.0]})
        b = T.Dataset.from_pydict({"x": [1.0, 2.0, 3.0]})
        c = T.Dataset.from_pydict({"x": [1.0, 2.0, 4.0]})
        assert a.fingerprint() == b.fingerprint() != c.fingerprint()
        assert a.fingerprint().startswith("mem-")
        s1 = T.Dataset.from_pydict({"s": ["a", None, "b"]})
        s2 = T.Dataset.from_pydict({"s": ["a", None, "c"]})
        assert s1.fingerprint() != s2.fingerprint()

    def test_parquet_fingerprint_tracks_files(self, tmp_path):
        import pyarrow as pa
        import pyarrow.parquet as pq

        path = str(tmp_path / "part.parquet")
        pq.write_table(pa.table({"x": [1.0, 2.0, 3.0]}), path)
        fp1 = T.Dataset.from_parquet(path).fingerprint()
        assert fp1.startswith("parquet-")
        assert T.Dataset.from_parquet(path).fingerprint() == fp1
        pq.write_table(pa.table({"x": [9.0, 9.0, 9.0, 9.0]}), path)
        assert T.Dataset.from_parquet(path).fingerprint() != fp1


# -- telemetry ------------------------------------------------------------------------


class TestResilienceTelemetry:
    """The counterpart of ``tests/test_resilience.py::TestResilienceTelemetry``:
    a faulted, checkpointed run's counters and events, rendered by
    ``tools/obs_report.py``, and equal to the JAX package's."""

    @pytest.mark.parametrize("mode", sorted(MODES))
    def test_counters_equal_the_reference_and_obs_report_renders_them(self, mode, tmp_path):
        from deequ_tpu.telemetry import get_telemetry as ref_telemetry
        from tools.obs_report import render_run

        from deequ_tpu_torch.telemetry import get_telemetry

        faults = dict(transient={1: 1}, permanent={4})
        names = ("engine.batch_retries", "engine.batches_quarantined",
                 "engine.checkpoints_written", "engine.resumes")
        with get_telemetry().run("resilience-report") as cap:
            _port_run(FaultInjectingDataset(T.Dataset.from_pydict(_table_data()), **faults),
                      mode, engine=T.AnalysisEngine(checkpointer=ScanCheckpointer(
                          str(tmp_path / "port"))), checkpoint_every_batches=3)
        with ref_telemetry().run("resilience-report") as rcap:
            _ref_run(RFaults(R.Dataset.from_pydict(_table_data()), **faults), mode,
                     engine=R.AnalysisEngine(checkpointer=RScanCheckpointer(
                         str(tmp_path / "ref"))), checkpoint_every_batches=3)
        got = {n: cap.final["counters"].get(n, 0) for n in names}
        assert got == {n: rcap.final["counters"].get(n, 0) for n in names}
        assert got["engine.batch_retries"] == 1 and got["engine.batches_quarantined"] == 1
        quarantined = [e for e in cap.final["events"] if e["event"] == "batch_quarantined"]
        assert [e["batch_index"] for e in quarantined] == [4]
        text = render_run(cap.final)
        for needle in ("resilience", "engine.batch_retries", "engine.batches_quarantined",
                       "engine.checkpoints_written", "quarantined batch 4"):
            assert needle in text
