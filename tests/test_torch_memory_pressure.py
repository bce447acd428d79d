"""Memory pressure on the port's scan (``deequ_tpu_torch/engine/
memory.py`` and the guarded update of ``engine/scan.py``), against the
JAX package's ``tests/test_memory_pressure.py``.

- The classifier: the JAX package's cases agree, and the port's own:
  ``torch.OutOfMemoryError`` is memory pressure by its class, a kernel
  launch error of ``cudaErrorMemoryAllocation`` by its code, and every
  other CUDA or kernel error (an illegal address, too many resources)
  is not: it propagates out of ``VerificationSuite.run()``, retried and
  quarantined never.
- The backoff: a device that fits only so many rows (the fault
  harness's ``oom_rows_over``) makes the scan settle at the first
  halved size that fits, with every state bit-identical to the port's
  run configured natively at that size, and metrics equal to the JAX
  package's backed-off run (counts exact, float64 1e-12 relative); the
  same for an OOM raised INSIDE the k-th op's update (monkeypatched),
  after the ops before it, a spill collector's in-place key writes
  among them, have run. Exhausted backoff quarantines with the JAX
  package's record.
- The spill downgrade chain (collector -> deferred re-read -> host
  group-by) and the admission watermark.

Modes are the JAX package's resident and streamed ones (``batch_size``
104; ``device_cache_bytes`` 1 GiB or 0; a suite with a spill collector
streams at ``rows * 64`` bytes, which keeps the collector's gate open).
"""

import threading
import time

import numpy as np
import pytest
import torch

import deequ_tpu as R
from deequ_tpu import config as rconfig
from deequ_tpu.engine import memory as rmemory
from deequ_tpu.engine.resilience import RetryPolicy as RRetryPolicy
from deequ_tpu.testing.faults import FaultInjectingDataset as RFaults

import deequ_tpu_torch as T
from deequ_tpu_torch import config as tconfig
from deequ_tpu_torch.analyzers.base import ScanOps
from deequ_tpu_torch.data.table import ROW_MASK
from deequ_tpu_torch.engine import scan
from deequ_tpu_torch.engine.deadline import AdmissionController, admission_controller
from deequ_tpu_torch.engine.memory import (
    AdaptiveBatchBackoff,
    BackoffExhausted,
    MemoryPressureError,
    SimulatedResourceExhausted,
    classify_memory_pressure,
    is_device_fault,
    make_backoff,
    simulated_device_oom,
)
from deequ_tpu_torch.engine.resilience import RetryPolicy, ScanKilled, is_transient
from deequ_tpu_torch.interop import states_to_numpy
from deequ_tpu_torch.io.state_provider import ScanCheckpointer
from deequ_tpu_torch.sketches import scatter_max
from deequ_tpu_torch.testing.faults import FaultInjectingDataset

RTOL = 1e-12
FAST = RetryPolicy(max_attempts=3, sleep=lambda _s: None)
RFAST = RRetryPolicy(max_attempts=3, sleep=lambda _s: None)
# protection on, an aggressive floor, no healing: the partition of the
# differentials stays that of the native run
BACKOFF = dict(min_batch_rows=8, memory_heal_after_batches=0)
MODES = {"resident": 1 << 30, "streaming": 0}
# full batch, the device's row limit, the size the backoff settles at
ONE = dict(n=1000, full=104, over=60, settled=52)
TWO = dict(n=1040, full=104, over=30, settled=26)


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


def _values(ctx, analyzers):
    out = []
    for a in analyzers:
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


class _Keep:
    def __init__(self):
        self.states = {}

    def persist(self, analyzer, state):
        self.states[repr(analyzer)] = state


def _bits(keep):
    return {k: {f: (np.asarray(v).dtype.str, np.asarray(v).tobytes())
                for f, v in states_to_numpy(s).items()}
            for k, s in keep.states.items()}


def _port(ds, mode, batch_size, analyzers=_analyzers, engine=None, **overrides):
    """(context, state bits, engine) of a port run."""
    keep = _Keep()
    engine = engine or T.AnalysisEngine()
    opts = dict(device_cache_bytes=MODES[mode], batch_size=batch_size, scan_retry=FAST)
    opts.update(overrides)
    with tconfig.configure(**opts):
        ctx = T.AnalysisRunner.do_analysis_run(ds, analyzers(T), engine=engine,
                                               save_states_with=keep)
    return ctx, _bits(keep), engine


def _ref(ds, mode, batch_size, analyzers=_analyzers, **overrides):
    with rconfig.configure(device_cache_bytes=MODES[mode], batch_size=batch_size,
                           scan_retry=RFAST, **overrides):
        return R.AnalysisRunner.do_analysis_run(ds, analyzers(R))


# -- classification ---------------------------------------------------------------------


class _KernelLibrary:
    """A stand-in for the kernels' library: only its error strings."""

    STRINGS = {2: b"out of memory", 700: b"an illegal memory access was encountered",
               701: b"too many resources requested for launch"}

    def hll_cuda_error_string(self, err):
        return self.STRINGS[err]


def _launch_error(monkeypatch, code, kernel="hll_update"):
    monkeypatch.setattr(scatter_max, "_library", lambda: _KernelLibrary())
    with pytest.raises(RuntimeError) as info:
        scatter_max._raise_on(code, kernel)
    return info.value


class TestClassification:
    def test_host_memory_error_classifies(self):
        pressure = classify_memory_pressure(MemoryError("arena exhausted"))
        assert isinstance(pressure, MemoryPressureError) and pressure.origin == "host"

    def test_simulated_device_oom_matches_the_reference(self):
        ours, theirs = simulated_device_oom(1000, "dispatch@3"), rmemory.simulated_device_oom(
            1000, "dispatch@3")
        assert str(ours) == str(theirs) and "8000 bytes" in str(ours)
        assert classify_memory_pressure(ours).origin == "device"

    @pytest.mark.parametrize("exc", [
        RuntimeError("RESOURCE_EXHAUSTED: Out of memory allocating 8 bytes"),
        RuntimeError("Failed to allocate request for 1.0GiB"),
        RuntimeError("resource busy"),
        ValueError("out of memory in the spec, not at runtime"),
        KeyError("RESOURCE_EXHAUSTED"),
        OSError("out of memory"),
    ], ids=["marker", "failed-to-allocate", "no-marker", "value-error", "key-error", "os-error"])
    def test_agrees_with_the_reference(self, exc):
        assert (classify_memory_pressure(exc) is None) == \
            (rmemory.classify_memory_pressure(exc) is None)

    def test_runtime_type_names_match_by_name(self):
        xla = type("XlaRuntimeError", (Exception,), {})
        assert classify_memory_pressure(xla("RESOURCE_EXHAUSTED: out of memory")) is not None
        assert classify_memory_pressure(SimulatedResourceExhausted("nothing")) is None

    def test_memory_pressure_error_passes_through_and_is_not_transient(self):
        err = MemoryPressureError("x")
        assert classify_memory_pressure(err) is err
        assert classify_memory_pressure(BackoffExhausted("y")) is not None
        assert not is_transient(err)

    def test_torch_out_of_memory_classifies_by_class(self):
        exc = torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB")
        assert type(exc).__name__ == "OutOfMemoryError"
        # the JAX package's name-based rule misses it
        assert rmemory.classify_memory_pressure(exc) is None
        pressure = classify_memory_pressure(exc)
        assert pressure is not None and pressure.origin == "device"
        assert pressure.__cause__ is exc and not is_device_fault(exc)

    def test_kernel_memory_allocation_error_classifies(self, monkeypatch):
        exc = _launch_error(monkeypatch, 2)
        assert str(exc) == "hll_update kernel launch failed: out of memory (cudaError 2)"
        assert classify_memory_pressure(exc) is not None and not is_device_fault(exc)

    @pytest.mark.parametrize("code", [700, 701])
    def test_other_kernel_errors_are_device_faults(self, monkeypatch, code):
        exc = _launch_error(monkeypatch, code, "hll_update_codes")
        assert classify_memory_pressure(exc) is None
        assert is_device_fault(exc) and not is_transient(exc)

    def test_torch_cuda_errors_are_device_faults(self):
        exc = RuntimeError("CUDA error: an illegal memory access was encountered")
        assert classify_memory_pressure(exc) is None and is_device_fault(exc)
        assert is_device_fault(torch.AcceleratorError("CUDA error: misaligned address"))
        assert not is_device_fault(ValueError("decode"))
        assert not is_device_fault(RuntimeError("a dictionary past its capacity"))


# -- the backoff controller --------------------------------------------------------------


class TestBackoffController:
    def test_shrink_halves_to_floor_then_exhausts(self):
        b = AdaptiveBatchBackoff(1024, 100)
        sizes = []
        while b.shrink():
            sizes.append(b.effective)
        assert sizes == [512, 256, 128, 100]
        assert b.shrink() is False and b.effective == 100 and b.backoffs == 4

    def test_align_keeps_multiples(self):
        b = AdaptiveBatchBackoff(104, 8, align=8)
        sizes = []
        while b.shrink():
            sizes.append(b.effective)
        assert sizes == [48, 24, 8]

    def test_min_rows_clamped_to_full(self):
        b = AdaptiveBatchBackoff(100, 10_000)
        assert b.min_rows == 100 and b.shrink() is False

    def test_active_property(self):
        b = AdaptiveBatchBackoff(104, 8)
        assert not b.active
        b.shrink()
        assert b.active

    def test_heal_after_consecutive_cleans(self):
        b = AdaptiveBatchBackoff(104, 8, heal_after=2)
        b.shrink()
        b.shrink()
        assert b.effective == 26
        assert [b.note_clean() for _ in range(5)] == [False, True, False, True, False]
        assert b.effective == 104 and b.heals == 2

    def test_heal_disabled_by_default(self):
        b = AdaptiveBatchBackoff(104, 8)
        b.shrink()
        assert not any(b.note_clean() for _ in range(50)) and b.effective == 52

    def test_shrink_resets_clean_streak(self):
        b = AdaptiveBatchBackoff(104, 8, heal_after=2)
        b.shrink()
        assert b.note_clean() is False
        b.shrink()
        assert b.note_clean() is False and b.note_clean() is True

    def test_make_backoff_uses_config_with_the_reference_defaults(self):
        with tconfig.configure(min_batch_rows=16, memory_heal_after_batches=5):
            b = make_backoff(1024, align=4)
        assert (b.full, b.min_rows, b.heal_after, b.align) == (1024, 16, 5, 4)
        with tconfig.configure(memory_backoff=False):
            assert make_backoff(1024) is None
        ours, theirs = tconfig.options(), rconfig.options()
        for name in ("memory_backoff", "min_batch_rows", "memory_heal_after_batches",
                     "memory_watermark_bytes", "max_concurrent_runs", "run_deadline_seconds",
                     "batch_stall_seconds", "degradation_policy", "checkpoint_every_batches"):
            assert getattr(ours, name) == getattr(theirs, name), name


# -- the engine ------------------------------------------------------------------------------


@pytest.mark.parametrize("mode", list(MODES))
class TestEngineBackoff:
    def test_backoff_settles_bit_identical(self, mode):
        g = ONE
        data = _table_data(g["n"])
        native, native_bits, _ = _port(T.Dataset.from_pydict(data), mode, g["settled"], **BACKOFF)
        ds = FaultInjectingDataset(T.Dataset.from_pydict(data), oom_rows_over=g["over"])
        ctx, bits, engine = _port(ds, mode, g["full"], **BACKOFF)
        assert bits == native_bits
        assert _values(ctx, _analyzers(T)) == _values(native, _analyzers(T))
        assert any(f[0] == "oom" for f in ds.faults_fired)
        assert engine.last_backoff.backoffs == 1 and engine.last_backoff.effective == g["settled"]
        assert ctx.degradation is None
        rds = RFaults(R.Dataset.from_pydict(data), oom_rows_over=g["over"])
        _assert_close(_values(ctx, _analyzers(T)),
                      _values(_ref(rds, mode, g["full"], **BACKOFF), _analyzers(R)))

    def test_two_level_backoff_bit_identical(self, mode):
        g = TWO
        data = _table_data(g["n"])
        _, native_bits, _ = _port(T.Dataset.from_pydict(data), mode, g["settled"], **BACKOFF)
        ds = FaultInjectingDataset(T.Dataset.from_pydict(data), oom_rows_over=g["over"])
        ctx, bits, engine = _port(ds, mode, g["full"], **BACKOFF)
        assert bits == native_bits and engine.last_backoff.backoffs == 2
        rds = RFaults(R.Dataset.from_pydict(data), oom_rows_over=g["over"])
        _assert_close(_values(ctx, _analyzers(T)),
                      _values(_ref(rds, mode, g["full"], **BACKOFF), _analyzers(R)))

    def test_exhausted_backoff_quarantines(self, mode):
        data = _table_data()
        ds = FaultInjectingDataset(T.Dataset.from_pydict(data), oom_at_batch={2: 99})
        ctx, _, _ = _port(ds, mode, 104, min_batch_rows=104)
        rds = RFaults(R.Dataset.from_pydict(data), oom_at_batch={2: 99})
        rctx = _ref(rds, mode, 104, min_batch_rows=104)
        assert _record(ctx.degradation) == _record(rctx.degradation) == (
            1, 104, 0, ["BackoffExhausted"], [(2, 104, "BackoffExhausted", 1)])
        assert ctx.metric(T.Size()).value.get() == 1000 - 104
        _assert_close(_values(ctx, _analyzers(T)), _values(rctx, _analyzers(R)))

    def test_heal_restores_full_batch(self, mode):
        ds = FaultInjectingDataset(T.Dataset.from_pydict(_table_data()), oom_at_batch={0: 1})
        ctx, _, engine = _port(ds, mode, 104, min_batch_rows=8, memory_heal_after_batches=2)
        backoff = engine.last_backoff
        assert (backoff.backoffs, backoff.heals, backoff.effective) == (1, 1, 104)
        assert ctx.metric(T.Size()).value.get() == 1000
        assert ctx.degradation is None


class TestBackoffDisabled:
    def test_dispatch_oom_fails_scan_when_disabled(self):
        ds = FaultInjectingDataset(T.Dataset.from_pydict(_table_data()), oom_at_batch={1: 1})
        ctx, _, _ = _port(ds, "streaming", 104, memory_backoff=False)
        assert not ctx.metric(T.Size()).value.is_success
        rds = RFaults(R.Dataset.from_pydict(_table_data()), oom_at_batch={1: 1})
        assert not _ref(rds, "streaming", 104, memory_backoff=False).metric(
            R.Size()).value.is_success

    def test_transfer_stage_oom_backs_off(self):
        ds = FaultInjectingDataset(T.Dataset.from_pydict(_table_data()), oom_transfer_at={1: 1})
        ctx, bits, engine = _port(ds, "streaming", 104, **BACKOFF)
        rds = RFaults(R.Dataset.from_pydict(_table_data()), oom_transfer_at={1: 1})
        _ref(rds, "streaming", 104, **BACKOFF)
        assert ds.faults_fired == rds.faults_fired == [("oom", "transfer", 1, 104)]
        assert ctx.metric(T.Size()).value.get() == 1000 and ctx.degradation is None
        assert engine.last_backoff.backoffs == 1
        # batch 1 went through in halves, every other batch whole
        native = _port(T.Dataset.from_pydict(_table_data()), "streaming", 104, **BACKOFF)
        assert _values(ctx, _analyzers(T))[:2] == _values(native[0], _analyzers(T))[:2]


@pytest.mark.parametrize("mode", list(MODES))
def test_kill_resume_with_backoff_bit_identical(mode, tmp_path):
    """A checkpoint's cursor keeps the NOMINAL batch size (backoff is
    internal to a batch), so a run killed while backed off resumes and
    still equals the native run at the settled size, state for state."""
    g = ONE
    data = _table_data(g["n"])
    _, native_bits, _ = _port(T.Dataset.from_pydict(data), mode, g["settled"],
                              checkpoint_every_batches=3, **BACKOFF)
    ckpt = ScanCheckpointer(str(tmp_path))
    engine = T.AnalysisEngine(checkpointer=ckpt)
    ds = FaultInjectingDataset(T.Dataset.from_pydict(data), oom_rows_over=g["over"],
                               kill_at_batch=7)
    with pytest.raises(ScanKilled):
        _port(ds, mode, g["full"], engine=engine, checkpoint_every_batches=3, **BACKOFF)
    assert ckpt._storage.list_keys("scan-ckpt-")
    _, bits, _ = _port(ds, mode, g["full"], engine=engine, checkpoint_every_batches=3, **BACKOFF)
    assert [c["batch_index"] for c in engine.checkpoints] == [9]
    assert bits == native_bits and ckpt._storage.list_keys("scan-ckpt-") == []


# -- an OOM raised inside an op's update -----------------------------------------------------


def _spill_data(n=1000, seed=3):
    rng = np.random.default_rng(seed)
    data = {f"a{i}": rng.normal(size=n).tolist() for i in range(8)}
    data["g"] = (np.arange(n) % 7).tolist()
    data["id"] = rng.integers(0, 2**40, n).tolist()  # a high-cardinality spill plan
    return data


def _spill_analyzers(P):
    return ([P.Size(), P.ApproxQuantile("a0", 0.5), P.Uniqueness(["g"])]
            + [P.Mean(f"a{i}") for i in range(8)]
            + [P.Uniqueness(["id"]), P.CountDistinct(["id"])])


SPILL = dict(one_pass_spill=True, dense_grouping_budget_bytes=4 * 1024, **BACKOFF)


def _spill_budget(mode, n=1000):
    """Resident, or streamed at a budget under the suite's 77 bytes a row
    that still passes the collectors' headroom gate (rows x 64 bytes)."""
    return dict(device_cache_bytes=MODES[mode] or n * 64)


def _oom_inside(monkeypatch, which, when, fired):
    """Make the ``which``-th op of the scan (after it has run, so its
    writes, a collector's in-place key slots among them, are made) raise
    CUDA's out-of-memory error on a batch of ``rows`` where
    ``when(rows)``."""
    prepare = T.AnalysisEngine.prepare_scan
    update = ScanOps.apply_update
    target = {}

    def recording_prepare(self, dataset, pairs):
        plan = prepare(self, dataset, pairs)
        ops = list(plan.ops)
        target["op"] = ops[-1] if which == "collector" else ops[which]
        assert which != "collector" or target["op"].revert is not None
        return plan

    def raising_update(self, state, batch, consts):
        out = update(self, state, batch, consts)
        rows = batch[ROW_MASK].shape[0]
        if self is target.get("op") and when(rows):
            fired.append(rows)
            raise torch.OutOfMemoryError(
                f"CUDA out of memory. Tried to allocate {rows * 8} bytes")
        return out

    monkeypatch.setattr(T.AnalysisEngine, "prepare_scan", recording_prepare)
    monkeypatch.setattr(ScanOps, "apply_update", raising_update)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("which", [1, "collector"])
def test_oom_inside_kth_update_backs_off_bit_identical(monkeypatch, mode, which):
    data = _spill_data()
    budget = _spill_budget(mode)
    native, native_bits, e0 = _port(T.Dataset.from_pydict(data), mode, 52, _spill_analyzers,
                                    **SPILL, **budget)
    assert e0.stream_stats is None if mode == "resident" else e0.stream_stats.batches == 20
    fired = []
    _oom_inside(monkeypatch, which, lambda rows: rows > 60, fired)
    ctx, bits, engine = _port(T.Dataset.from_pydict(data), mode, 104, _spill_analyzers,
                              **SPILL, **budget)
    assert fired and fired[0] == 104
    assert engine.last_backoff.effective == 52 and ctx.degradation is None
    assert bits == native_bits


@pytest.mark.parametrize("mode", list(MODES))
def test_oom_inside_the_last_batch_quarantines_cleanly(monkeypatch, mode):
    """Backoff exhausted on the last batch, inside the collector's update
    after it wrote its keys: the written slots are reverted, so the
    states equal a run over the rows without that batch."""
    n = 1000
    data = _spill_data(n)
    cut = {k: v[:(n // 104) * 104] for k, v in data.items()}
    want, want_bits, _ = _port(T.Dataset.from_pydict(cut), mode, 104, _spill_analyzers,
                               **SPILL, **_spill_budget(mode, len(cut["g"])))
    fired = []
    _oom_inside(monkeypatch, "collector", lambda rows: rows == n % 104, fired)
    ctx, bits, _ = _port(T.Dataset.from_pydict(data), mode, 104, _spill_analyzers,
                         **dict(SPILL, min_batch_rows=104), **_spill_budget(mode))
    assert fired == [n % 104]
    assert _record(ctx.degradation) == (1, n % 104, 0, ["BackoffExhausted"],
                                        [(n // 104, n % 104, "BackoffExhausted", 1)])
    assert ctx.metric(T.Size()).value.get() == len(cut["g"])
    grouping = [str(a) for a in _spill_analyzers(T)[-2:]]
    assert _values(ctx, _spill_analyzers(T))[-2:] == _values(want, _spill_analyzers(T))[-2:]
    assert {k: v for k, v in bits.items() if k in grouping} == \
        {k: v for k, v in want_bits.items() if k in grouping}


# -- the spill downgrade chain ------------------------------------------------------------


class TestSpillDowngrade:
    N = 4096

    @pytest.fixture
    def spill_data(self):
        rng = np.random.default_rng(42)
        return {
            "v": rng.normal(size=self.N).tolist(),
            "dense_g": (np.arange(self.N) % 5).tolist(),
            "id": rng.integers(0, 2**40, self.N).tolist(),
        }

    @staticmethod
    def _analyzers(P):
        return [P.Size(), P.Mean("v"), P.Uniqueness(["dense_g"]), P.Uniqueness(["id"])]

    def _overrides(self, **extra):
        base = dict(device_cache_bytes=1 << 30, batch_size=512, scan_retry=FAST,
                    one_pass_spill=True, dense_grouping_budget_bytes=4 * 1024, **BACKOFF)
        base.update(extra)
        return base

    def _run(self, data, faults=None, **extra):
        ds = T.Dataset.from_pydict(data)
        if faults is not None:
            ds = FaultInjectingDataset(ds, **faults)
        with tconfig.configure(**self._overrides(**extra)):
            ctx = T.AnalysisRunner.do_analysis_run(ds, self._analyzers(T))
        return ctx, ds

    def _ref(self, data, **extra):
        extra = dict(self._overrides(**extra), scan_retry=RFAST)
        with rconfig.configure(**extra):
            return _values(R.AnalysisRunner.do_analysis_run(R.Dataset.from_pydict(data),
                                                            self._analyzers(R)),
                           self._analyzers(R))

    @staticmethod
    def _downgrades(ctx):
        return [(e["stage"], e["path"]) for e in ctx.run_metadata.events
                if e.get("action") == "spill-downgrade"]

    def test_finalize_oom_downgrades_to_deferred(self, spill_data):
        clean, _ = self._run(spill_data)
        ctx, ds = self._run(spill_data, dict(oom_finalize=1))
        assert _values(ctx, self._analyzers(T)) == _values(clean, self._analyzers(T))
        _assert_close(_values(ctx, self._analyzers(T)), self._ref(spill_data))
        assert self._downgrades(ctx) == [("finalize", "deferred")]
        assert ("oom", "finalize", 0, 0) in ds.faults_fired

    def test_finalize_then_deferred_oom_falls_to_host(self, spill_data):
        clean, _ = self._run(spill_data)
        ctx, _ = self._run(spill_data, dict(oom_finalize=1, oom_deferred=1))
        assert _values(ctx, self._analyzers(T)) == _values(clean, self._analyzers(T))
        assert self._downgrades(ctx) == [("finalize", "deferred"), ("deferred", "host")]
        paths = [e["path"] for e in ctx.run_metadata.events if e.get("event") == "grouping_spill"]
        assert "host-oom" in paths

    def test_deferred_path_oom_without_collectors(self, spill_data):
        clean, _ = self._run(spill_data, one_pass_spill=False)
        ctx, _ = self._run(spill_data, dict(oom_deferred=1), one_pass_spill=False)
        assert _values(ctx, self._analyzers(T)) == _values(clean, self._analyzers(T))
        assert self._downgrades(ctx) == [("deferred", "host")]

    def test_spill_suite_backoff_differential(self, spill_data):
        native, _ = self._run(spill_data, batch_size=256)
        ctx, ds = self._run(spill_data, dict(oom_rows_over=300), batch_size=512)
        assert _values(ctx, self._analyzers(T)) == _values(native, self._analyzers(T))
        assert any(f[0] == "oom" for f in ds.faults_fired)
        _assert_close(_values(ctx, self._analyzers(T)), self._ref(spill_data, batch_size=256))


# -- admission by count and watermark ----------------------------------------------------------


def _spin_until(predicate, what, timeout_s=5.0):
    deadline = time.monotonic() + timeout_s
    while not predicate():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.001)


class TestWatermarkAdmission:
    def test_second_run_queues_past_watermark(self):
        ctl = AdmissionController()
        ctl.acquire(0, estimated_bytes=600, watermark_bytes=1000)
        assert ctl.snapshot() == {"active": 1, "queued": 0, "active_bytes": 600}
        admitted = []

        def worker():
            ctl.acquire(0, estimated_bytes=600, watermark_bytes=1000)
            admitted.append(True)
            ctl.release(600)

        t = threading.Thread(target=worker)
        t.start()
        _spin_until(lambda: ctl.snapshot()["queued"] == 1, "worker queued")
        assert admitted == []
        ctl.release(600)
        t.join(timeout=5)
        assert admitted == [True]
        assert ctl.snapshot() == {"active": 0, "queued": 0, "active_bytes": 0}

    def test_oversized_single_run_admits_when_idle(self):
        ctl = AdmissionController()
        ctl.acquire(0, estimated_bytes=10_000, watermark_bytes=100)
        assert ctl.snapshot()["active_bytes"] == 10_000
        ctl.release(10_000)
        assert ctl.snapshot()["active_bytes"] == 0

    def test_no_estimate_no_gate(self):
        ctl = AdmissionController()
        ctl.acquire(0, estimated_bytes=0, watermark_bytes=100)
        ctl.acquire(0, estimated_bytes=0, watermark_bytes=100)
        assert ctl.snapshot() == {"active": 2, "queued": 0, "active_bytes": 0}
        ctl.release()
        ctl.release()

    def test_estimated_run_bytes_matches_the_reference(self):
        engine = T.AnalysisEngine()
        one = {"a": [1.0] * 100}
        two = {"a": [1.0] * 100, "b": [2.0] * 100}
        est_one = engine.estimated_run_bytes(T.Dataset.from_pydict(one))
        est_two = engine.estimated_run_bytes(T.Dataset.from_pydict(two))
        assert 0 < est_one < est_two
        with rconfig.configure(batch_size=100):
            assert est_two == R.AnalysisEngine().estimated_run_bytes(R.Dataset.from_pydict(two))

    def test_runner_watermark_end_to_end(self):
        before = admission_controller().queued_total
        with tconfig.configure(device_cache_bytes=0, batch_size=104,
                               memory_watermark_bytes=1 << 40):
            ctx = T.AnalysisRunner.do_analysis_run(T.Dataset.from_pydict(_table_data()),
                                                   [T.Size()])
        assert ctx.metric(T.Size()).value.get() == 1000
        assert admission_controller().queued_total == before
        assert admission_controller().snapshot() == {"active": 0, "queued": 0,
                                                     "active_bytes": 0}

    def test_concurrent_runs_queue_past_the_watermark(self):
        """Two runs whose estimates together pass the watermark: the
        second starts only once the first has released its bytes."""
        data = T.Dataset.from_pydict(_table_data())
        est = T.AnalysisEngine().estimated_run_bytes(data)
        inside, release, order = threading.Event(), threading.Event(), []

        def hold():
            inside.set()
            assert release.wait(5)

        ds1 = FaultInjectingDataset(data, on_batch={0: hold})
        results = {}

        def run(name, ds):
            with tconfig.configure(device_cache_bytes=0, batch_size=104,
                                   memory_watermark_bytes=est + est // 2):
                results[name] = T.AnalysisRunner.do_analysis_run(ds, [T.Size()])
            order.append(name)

        first = threading.Thread(target=run, args=("first", ds1))
        first.start()
        assert inside.wait(5)
        before = admission_controller().queued_total
        second = threading.Thread(target=run, args=("second", data))
        second.start()
        _spin_until(lambda: admission_controller().snapshot()["queued"] == 1, "second queued")
        assert admission_controller().queued_total == before + 1
        release.set()
        first.join(10)
        second.join(10)
        assert order == ["first", "second"]
        assert results["second"].metric(T.Size()).value.get() == 1000


# -- verification status and device faults ---------------------------------------------------


class TestDegradationPolicy:
    def _results(self, policy):
        def run(P, cfg, faults, retry):
            check = P.Check(P.CheckLevel.ERROR, "mem").has_size(lambda s: s > 0)
            ds = faults(P.Dataset.from_pydict(_table_data()), oom_at_batch={2: 99})
            with cfg.configure(device_cache_bytes=0, batch_size=104, min_batch_rows=104,
                               scan_retry=retry, degradation_policy=policy):
                return P.VerificationSuite.do_verification_run(ds, [check])

        return (run(R, rconfig, RFaults, RFAST),
                run(T, tconfig, FaultInjectingDataset, FAST))

    @pytest.mark.parametrize("policy,status", [("fail", "Error"), ("warn", "Warning"),
                                               ("tolerate", "Success")])
    def test_exhausted_backoff_floors_as_the_reference(self, policy, status):
        ref, port = self._results(policy)
        assert port.status.value == ref.status.value == status
        assert _record(port.degradation) == _record(ref.degradation)
        assert port.degradation.error_classes == ["BackoffExhausted"]


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("code", [700, 701])
def test_kernel_fault_propagates_out_of_run(monkeypatch, mode, code):
    """A kernel launch error that is not memory pressure fails the run:
    ``VerificationSuite.run()`` raises it, after ONE launch (no retry, no
    quarantine, no plain version in its place)."""
    calls = []

    def faulting(values, masks, rows, registers):
        calls.append(values.shape)
        scatter_max._raise_on(code, "hll_update")

    monkeypatch.setattr(scatter_max, "_library", lambda: _KernelLibrary())
    monkeypatch.setattr(scatter_max, "hll_update", faulting)
    check = (T.Check(T.CheckLevel.ERROR, "k").has_size(lambda s: s == 1000)
             .has_approx_count_distinct("a", lambda v: v > 0))
    with tconfig.configure(device_cache_bytes=MODES[mode], batch_size=104, scan_retry=FAST):
        with pytest.raises(RuntimeError, match=rf"\(cudaError {code}\)"):
            (T.VerificationSuite().on_data(T.Dataset.from_pydict(_table_data()))
             .add_check(check).run())
    assert len(calls) == 1


# -- telemetry ------------------------------------------------------------------------


class TestObsReport:
    """The counterpart of ``tests/test_memory_pressure.py::TestObsReport``:
    a backed-off run's counters and ``scan_memory_pressure`` events, as
    ``tools/obs_report.py`` renders them, equal to the JAX package's."""

    @pytest.mark.parametrize("mode", sorted(MODES))
    def test_capture_end_to_end(self, mode):
        from deequ_tpu.telemetry import get_telemetry as ref_telemetry
        from tools.obs_report import render_run

        from deequ_tpu_torch.telemetry import get_telemetry

        g = ONE
        data = _table_data(g["n"])
        with get_telemetry().run("memory-report") as cap:
            _port(FaultInjectingDataset(T.Dataset.from_pydict(data), oom_rows_over=g["over"]),
                  mode, g["full"], **BACKOFF)
        with ref_telemetry().run("memory-report") as rcap:
            _ref(RFaults(R.Dataset.from_pydict(data), oom_rows_over=g["over"]), mode,
                 g["full"], **BACKOFF)
        names = ("engine.oom_events", "engine.batch_size_backoffs", "engine.spill_downgrades")
        got = {n: cap.final["counters"].get(n, 0) for n in names}
        assert got == {n: rcap.final["counters"].get(n, 0) for n in names}
        actions = [e["action"] for e in cap.final["events"]
                   if e["event"] == "scan_memory_pressure"]
        assert actions == [e["action"] for e in rcap.final["events"]
                           if e["event"] == "scan_memory_pressure"]
        text = render_run(cap.final)
        assert "engine.oom_events" in text and "memory pressure (device)" in text
        assert f"batch size backoff: {g['full']} -> {g['settled']} rows" in text

    def test_clean_run_emits_no_memory_telemetry(self):
        from deequ_tpu_torch.telemetry import get_telemetry

        with get_telemetry().run("zero-cost") as cap:
            _port(T.Dataset.from_pydict(_table_data()), "streaming", 104)
        assert not [e for e in cap.final["events"] if e["event"] == "scan_memory_pressure"]
        assert "engine.oom_events" not in cap.final["counters"]
