"""The port's streamed scan (``deequ_tpu_torch/engine/scan.py``) on the CPU.

- The mode decision: ``Dataset.estimated_device_bytes`` equals the JAX
  package's for the same fresh dataset and requests (rows a multiple of
  the batch) on the column types both hold at the same width, and the
  plan's mode equals the JAX package's for the same budget. Pinned
  divergences: the port counts the widths it holds (an int16 column 2
  bytes a row, the JAX package 4; the codes a lengths request is
  gathered from), and unpadded rows.
- Streamed equals resident BIT FOR BIT: every state of the suites of
  ``test_torch_verification.py`` (plain and filtered), of the sketches
  (HLL registers, KLL, quantiles), DataType, PatternMatch and a dense
  and a collector grouping plan, filtered and not, on a ragged last
  batch, on an empty dataset and on columns without nulls. Float states
  are compared as bits.
- Streamed equals the JAX package's streamed run at the same batch size:
  integer states and registers exactly, float states within 1e-12
  relative (1e-5 for the float32 column, which reduces each batch in
  float32 in another order; the JAX package's own streamed and resident
  results differ by an ulp).
- Codecs on and off, ``ingest_depth`` 1, 2 and 4, and a mid-stream codec
  widening give identical states.
- After a streamed run, and after a source error raised mid-stream, the
  dataset holds no device copy and no prefetch thread is alive; the
  failing batch is retried from its index and, failing every attempt,
  quarantined into the run's degradation record.
- Data passes and fetches equal the resident run's (drains included).
"""

import threading

import numpy as np
import pytest
import torch

import deequ_tpu as R
from deequ_tpu import config as rconfig
from deequ_tpu.analyzers import runner as rrunner
from deequ_tpu.data.table import ColumnRequest as RReq

import deequ_tpu_torch as T
from deequ_tpu_torch import config as tconfig
from deequ_tpu_torch.analyzers import runner as trunner
from deequ_tpu_torch.data.table import ColumnRequest as TReq
from deequ_tpu_torch.engine import scan
from deequ_tpu_torch.interop import states_to_numpy

from test_torch_verification import _checks, _data, _filter_checks

RTOL = 1e-12
RTOL_F32 = 1e-5
RESIDENT = dict(device_cache_bytes=1 << 40)


@pytest.fixture(autouse=True)
def _cpu():
    with tconfig.configure(device="cpu"):
        yield


# -- the mode decision -------------------------------------------------------


def _agreeing(n, nulls=True):
    rng = np.random.default_rng(1)
    mask = (lambda: rng.random(n) < 0.1) if nulls else (lambda: np.zeros(n, bool))
    return {
        "id": rng.integers(-(2**62), 2**62, n),
        "x": np.ma.array(rng.random(n), mask=mask()),
        "f": np.ma.array(rng.random(n).astype(np.float32), mask=mask()),
        "q": np.ma.array(rng.integers(-(2**30), 2**30, n).astype(np.int32), mask=mask()),
        "b": rng.random(n) < 0.5,
        "s": [None if (nulls and i % 7 == 0) else f"v{i % 13}" for i in range(n)],
        "t": np.arange(n).astype("datetime64[ms]"),
    }


REQS = [("id", "values"), ("x", "values"), ("f", "values"), ("q", "values"), ("b", "values"),
        ("s", "codes"), ("s", "lengths"), ("t", "values"), ("x", "mask")]


@pytest.mark.parametrize("nulls", [True, False])
@pytest.mark.parametrize("reqs", [REQS, REQS[:3], [("s", "codes")], [("b", "values")]])
def test_estimate_equals_the_reference_on_agreeing_columns(reqs, nulls):
    n, batch = 4000, 1000
    data = _agreeing(n, nulls)
    ref = R.Dataset.from_pydict(data).estimated_device_bytes([RReq(*r) for r in reqs], batch)
    port = T.Dataset.from_pydict(data).estimated_device_bytes([TReq(*r) for r in reqs])
    assert port == ref


def test_estimate_divergences_are_the_widths_and_the_padding():
    n, batch = 4000, 1000
    data = _agreeing(n)
    data["h"] = np.arange(n, dtype=np.int16)
    rds, tds = R.Dataset.from_pydict(data), T.Dataset.from_pydict(data)
    # an int16 column: the port holds 2 bytes a row, the JAX package 4
    h = [("h", "values")]
    assert rds.estimated_device_bytes([RReq(*r) for r in h], batch) - \
        tds.estimated_device_bytes([TReq(*r) for r in h]) == 2 * n
    # a lengths request without its codes: the port counts the codes it
    # gathers the lengths from (4 bytes a row); the JAX package counts
    # them only once it holds the column's dictionary
    ln = [("s", "lengths")]
    assert tds.estimated_device_bytes([TReq(*r) for r in ln]) - \
        rds.estimated_device_bytes([RReq(*r) for r in ln], batch) == 4 * n
    # a ragged last batch: the JAX package counts the padded rows
    ragged = 3500
    rds = R.Dataset.from_pydict({k: v[:ragged] for k, v in data.items()})
    tds = T.Dataset.from_pydict({k: v[:ragged] for k, v in data.items()})
    per_row = tds.estimated_device_bytes([TReq(*r) for r in REQS]) // ragged
    assert rds.estimated_device_bytes([RReq(*r) for r in REQS], batch) == per_row * 4000


def _plan(P, runner, data, checks, budget, batch):
    ds = P.Dataset.from_pydict(data)
    engine = P.AnalysisEngine() if P is R else P.AnalysisEngine(device="cpu")
    analyzers = runner._dedup([a for c in checks for a in c.required_analyzers()])
    base = __import__(f"{P.__name__}.analyzers.base", fromlist=["x"])
    scan_shareable = [a for a in analyzers if isinstance(a, base.ScanShareableAnalyzer)]
    pass_plan = runner._plan_fused_pass(ds, scan_shareable, [], engine)
    cfg = P.config.configure(device_cache_bytes=budget, batch_size=batch)
    with cfg:
        return engine.prepare_scan(ds, pass_plan.scan_pairs)


@pytest.mark.parametrize("budget", [0, 1, 10_000, 100_000, 1_000_000, 1 << 33])
def test_plan_mode_equals_the_reference(budget):
    n, batch = 3000, 1000
    data = _data(np.random.default_rng(0), n)
    checks = lambda P: _checks(P) + _filter_checks(P)  # noqa: E731
    ref = _plan(R, rrunner, data, checks(R), budget, batch)
    port = _plan(T, trunner, data, checks(T), budget, batch)
    assert port.mode == ref.mode
    # the port's default; the JAX package's is True (ROADMAP queue 3)
    assert port.wire_codecs is False
    assert port.mode == ("resident" if budget >= 1_000_000 else "streaming")


# -- streamed equals resident, bit for bit -----------------------------------


class Keep:
    def __init__(self):
        self.states = {}

    def persist(self, analyzer, state):
        self.states[repr(analyzer)] = state


def _bits(state):
    out = {}
    for k, v in states_to_numpy(state).items():
        v = np.asarray(v)
        out[k] = (v.dtype.str, v.shape,
                  v.view(f"i{v.dtype.itemsize}").tobytes() if v.dtype.kind == "f" else v.tobytes())
    return out


def _sketch_checks(P):
    c = P.Check(P.CheckLevel.ERROR, "sketches")
    for col in ("price", "cost", "z", "q", "id"):
        c = c.has_approx_quantile(col, 0.5, lambda v: True)
    c = c.has_approx_quantile("price", 0.9, lambda v: True).where("cat = 'Books'")
    c = c.kll_sketch_satisfies("cost", lambda d: True)
    c = c.has_data_type("cat", P.checks.ConstrainableDataTypes.STRING, lambda v: True)
    c = c.has_pattern("cat", r"^[BM]", lambda v: True)
    c = c.has_pattern("cat", r"o", lambda v: True).where("q > 20")
    c = c.has_approx_count_distinct("price", lambda v: True).where("q > 20")
    return [c]


def _grouping_checks(P):
    c = (
        P.Check(P.CheckLevel.ERROR, "grouping")
        .has_number_of_distinct_values("cat", lambda v: True)  # dense
        .has_histogram_values("q", lambda d: True)  # dense
        .is_unique("id")  # collector (id is a random int64)
        .has_uniqueness(["price"], lambda v: True)  # collector (float64 keys)
        .has_entropy("cat", lambda v: True)
        .has_distinctness(["cat", "q"], lambda v: True)
        .has_uniqueness(["id"], lambda v: True).where("q > 50")
    )
    return [c]


SUITES = {
    "verification": _checks,
    "filtered": _filter_checks,
    "sketches": _sketch_checks,
    "grouping": _grouping_checks,
}


def _stream(data):
    """Options that make a scan of ``data`` stream with the device spill
    still allowed: a budget of rows x 64 bytes, below what the wide rows
    request (``_widen``). An empty table requests nothing, so it streams
    only at a budget of 0, which sends grouping to the host: both runs
    of it then take the host path."""
    rows = len(data["id"])
    if rows == 0:
        return dict(device_cache_bytes=0, device_spill_grouping=False)
    return dict(device_cache_bytes=rows * 64)


def _widen(data, checks, P=T):
    """Six more float64 columns and a check reading them: more than 64
    requested bytes a row."""
    rng = np.random.default_rng(12)
    rows = len(data["id"])
    data = dict(data)
    c = P.Check(P.CheckLevel.WARNING, "wide")
    for i in range(6):
        data[f"w{i}"] = np.ma.array(rng.random(rows) * 1000, mask=rng.random(rows) < 0.05)
        c = c.has_mean(f"w{i}", lambda v: True).has_completeness(f"w{i}", lambda v: True)
    return data, list(checks) + [c]


def _run(data, checks, batch, engine=None, **opts):
    keep = Keep()
    with tconfig.configure(batch_size=batch, **opts):
        ds = T.Dataset.from_pydict(data)
        engine = engine or T.AnalysisEngine()
        result = T.VerificationSuite().on_data(ds).with_engine(engine).add_checks(checks) \
            .save_states_with(keep).run()
    return result, keep.states, engine, ds


def _metrics(result):
    out = {}
    for a, m in result.metrics.items():
        if m.value.is_failure:
            out[repr(a)] = ("failure", str(m.value.exception))
        else:
            v = m.value.get()
            out[repr(a)] = repr(v) if not isinstance(v, float) else np.float64(v).tobytes()
    return out


def assert_bit_equal(a, b):
    (ra, sa, *_), (rb, sb, *_) = a, b
    assert _metrics(ra) == _metrics(rb)
    assert list(sa) == list(sb)
    for k in sa:
        assert _bits(sa[k]) == _bits(sb[k]), k
    assert [r["constraint_status"] for r in ra.check_results_as_records()] == \
        [r["constraint_status"] for r in rb.check_results_as_records()]


def _case(name):
    rng = np.random.default_rng(7)
    if name == "ragged":
        return _data(rng, 3000), 700
    if name == "empty":
        return {k: v[:0] for k, v in _data(rng, 10).items()}, 700
    data = _data(rng, 2100)  # no nulls anywhere, batches of equal size
    for k in ("q", "price", "cost"):
        data[k] = np.asarray(data[k].filled(1))
    data["cat"] = ["Books" if v is None else v for v in data["cat"]]
    return data, 700


@pytest.mark.parametrize("case", ["ragged", "empty", "all-valid"])
@pytest.mark.parametrize("suite", sorted(SUITES))
def test_streamed_equals_resident_bit_for_bit(suite, case):
    data, batch = _case(case)
    data, checks = _widen(data, SUITES[suite](T))
    stream = _stream(data)
    streamed = _run(data, checks, batch, **stream)
    resident = _run(data, checks, batch, **{**stream, **RESIDENT})
    assert streamed[2].stream_stats is not None and resident[2].stream_stats is None
    assert_bit_equal(streamed, resident)
    assert streamed[2].data_passes == resident[2].data_passes
    assert streamed[2].device_fetches == resident[2].device_fetches
    if case != "empty":
        assert streamed[2].stream_stats.batches == -(-len(data["id"]) // batch)
        if suite == "grouping":
            # the collectors' finalize fetch: the device spill path ran
            assert streamed[2].device_fetches >= 2
    assert streamed[3]._device_cache == {}
    assert scan.active_prefetch_workers() == []


def test_streamed_wire_accounting():
    data, batch = _case("ragged")
    data, checks = _widen(data, _checks(T))
    result, _, engine, _ = _run(data, checks, batch, wire_codecs=True, **_stream(data))
    stats = engine.stream_stats
    assert stats.batches == 5 and stats.repacks == 0
    # q (int32 1-100) ships as int8, s (int16) as int16 and the masks as
    # bits; the random int64 ids and float64 prices ship whole
    assert 0 < stats.encoded_bytes < stats.raw_bytes
    assert set(engine.phase_times) >= {"resident_s", "scan_s", "fold_s", "pack_s", "copy_s"}
    _, _, off, _ = _run(data, checks, batch, **_stream(data))
    assert off.stream_stats.encoded_bytes == off.stream_stats.raw_bytes == stats.raw_bytes


@pytest.mark.parametrize("variant", [
    dict(wire_codecs=True), dict(ingest_depth=1), dict(ingest_depth=4),
    dict(ingest_depth=4, wire_codecs=True),
])
def test_codecs_and_ring_depths_are_identical(variant):
    data, batch = _case("ragged")
    data, checks = _widen(data, _checks(T) + _sketch_checks(T) + _grouping_checks(T))
    base = _run(data, checks, batch, **_stream(data))
    other = _run(data, checks, batch, **_stream(data), **variant)
    assert_bit_equal(other, base)


def test_mid_stream_widening_repacks_and_stays_identical():
    """A float64 column exact in float32 in the first batch, then not;
    dictionary codes under 128 in the first batch, then past it: both
    codecs widen mid-stream, and the batch is packed again."""
    rng = np.random.default_rng(3)
    n, batch = 2000, 500
    x = np.round(rng.random(n) * 64) / 4  # exact in float32
    x[1700] = 0.1  # not exact: a later batch widens
    words = np.array([f"w{i}" for i in range(300)], dtype=object)
    codes = rng.integers(0, 100, n).astype(np.int32)
    codes[1200:] = rng.integers(0, 300, n - 1200)
    data = {"x": x, "s": T.DictionaryColumn(codes, words), "id": rng.integers(0, 50, n)}
    checks = lambda P: [P.Check(P.CheckLevel.ERROR, "w")  # noqa: E731
                        .has_mean("x", lambda v: True).has_max("x", lambda v: True)
                        .has_approx_count_distinct("s", lambda v: True)
                        .has_max_length("s", lambda v: True)
                        .has_number_of_distinct_values("s", lambda v: True)
                        .has_approx_quantile("x", 0.5, lambda v: True)]
    stream = dict(device_cache_bytes=1)
    streamed = _run(data, checks(T), batch, wire_codecs=True, **stream)
    assert streamed[2].stream_stats.repacks == 2
    assert_bit_equal(streamed, _run(data, checks(T), batch, **RESIDENT))
    assert_bit_equal(streamed, _run(data, checks(T), batch, **stream))


def test_drains_count_the_same_fetches():
    rng = np.random.default_rng(4)
    n, batch = 7000, 100  # 70 batches: one drain past DRAIN_EVERY
    data = {"x": rng.random(n), "id": rng.integers(0, 5, n)}
    checks = [T.Check(T.CheckLevel.ERROR, "q").has_approx_quantile("x", 0.5, lambda v: True)]
    streamed = _run(data, checks, batch, device_cache_bytes=1)
    resident = _run(data, checks, batch, **RESIDENT)
    assert streamed[2].device_fetches == resident[2].device_fetches == 2
    assert_bit_equal(streamed, resident)


# -- against the JAX package's streamed run ----------------------------------




def _states_close(port, ref, key):
    got, want = states_to_numpy(port), ref
    assert list(got) == list(want), key
    # a float32 column reduces each batch in float32, in another order
    # than XLA's (test_torch_verification.py's stated tolerance)
    rtol = RTOL_F32 if "'cost'" in key else RTOL
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, (key, k)
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=rtol, atol=0, equal_nan=True, err_msg=f"{key} {k}")
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{key} {k}")


def test_streamed_equals_the_reference_streamed_run():
    from deequ_tpu.analyzers.grouping import FrequenciesAndNumRows as RFreq
    from deequ_tpu.sketches.kll import KLLSketchState as RKll

    n, batch = 20_000, 3_000
    suite = lambda P: _checks(P) + _filter_checks(P) + _sketch_checks(P) + _grouping_checks(P)  # noqa: E731
    data, tchecks = _widen(_data(np.random.default_rng(11), n), suite(T))
    _, rchecks = _widen(data, suite(R), R)
    budget = n * 64

    class RKeep(Keep):
        def persist(self, analyzer, state):
            # the reference's persisted arrays (its FileSystemStateProvider's)
            if isinstance(state, RFreq):
                import json

                from deequ_tpu.io.state_provider import _json_safe
                arrays = {"__type__": np.asarray("FrequenciesAndNumRows"),
                          "columns": np.asarray(json.dumps(list(state.columns))),
                          "keys": np.asarray(json.dumps(
                              [[_json_safe(v) for v in row] for row in state.keys])),
                          "counts": state.counts, "num_rows": np.int64(state.num_rows)}
            elif isinstance(state, RKll):
                arrays = {"__type__": np.asarray("KLLSketchState"), **state.to_arrays()}
            else:
                from deequ_tpu.analyzers.states import STATE_FORMAT_VERSIONS

                name = type(state).__name__
                arrays = {"__type__": np.asarray(name),
                          "__version__": np.int64(STATE_FORMAT_VERSIONS.get(name, 1)),
                          **{f: np.asarray(getattr(state, f)) for f in state._fields}}
            self.states[repr(analyzer)] = arrays

    rkeep = RKeep()
    with rconfig.configure(batch_size=batch, device_cache_bytes=budget):
        rds = R.Dataset.from_pydict(data)
        engine = R.AnalysisEngine()
        R.VerificationSuite().on_data(rds).with_engine(engine).add_checks(rchecks) \
            .save_states_with(rkeep).run()
    assert "put_s" in engine.phase_times  # the JAX package streamed
    result, states, tengine, tds = _run(data, tchecks, batch, device_cache_bytes=budget)
    assert tengine.stream_stats is not None
    assert set(states) == set(rkeep.states)
    for key in rkeep.states:
        _states_close(states[key], rkeep.states[key], key)


# -- hygiene ------------------------------------------------------------------


def test_prefetch_error_arrives_after_the_items_before_it():
    def source():
        yield 0
        yield 1
        yield 2
        raise KeyError("batch 3")

    got = []
    with pytest.raises(KeyError, match="batch 3"):
        for item in scan._prefetched(source(), 2):
            got.append(item)
    assert got == [0, 1, 2]
    assert scan.active_prefetch_workers() == []


def test_abandoned_prefetch_joins_its_thread():
    def endless():
        i = 0
        while True:
            yield i
            i += 1

    it = scan._prefetched(endless(), 2)
    assert next(it) == 0
    it.close()
    assert scan.active_prefetch_workers() == []


def test_source_error_mid_stream_leaves_nothing_behind(monkeypatch):
    """A source that fails at batch 3 on every read: the scan retries it
    from batch 3 (an OSError is transient), quarantines it once the
    attempts are spent, finishes the other batches, and leaves no
    thread and no device copy behind."""
    data, batch = _case("ragged")
    ds = T.Dataset.from_pydict(data)
    host_batches = T.Dataset.host_batches
    starts, seen = [], []

    def failing(self, requests, batch_size, start_batch=0):
        starts.append(start_batch)
        for i, b in enumerate(host_batches(self, requests, batch_size, start_batch), start_batch):
            if i == 3:
                raise OSError("source read failed at batch 3")
            seen.append(i)
            yield b

    monkeypatch.setattr(T.Dataset, "host_batches", failing)
    no_wait = T.RetryPolicy(sleep=lambda _s: None)
    with tconfig.configure(batch_size=batch, device_cache_bytes=1, scan_retry=no_wait):
        engine = T.AnalysisEngine()
        result = T.VerificationSuite().on_data(ds).with_engine(engine).add_checks(_checks(T)).run()
        degradation = result.degradation
        assert degradation.retries == 2 and degradation.batches_quarantined == 1
        assert [(f.batch_index, f.error_class, f.attempts) for f in degradation.failures] == [
            (3, "OSError", 3)]
        assert "batch 3" in degradation.failures[0].message
        assert degradation.rows_skipped == batch
        assert result.status == T.CheckStatus.ERROR  # the default policy floors it
        assert starts == [0, 3, 3, 4] and seen[:3] == [0, 1, 2]
        assert ds._device_cache == {}
        assert scan.active_prefetch_workers() == []
        # and the same from the engine alone: the scan ends degraded
        engine = T.AnalysisEngine()
        units, _ = __import__("deequ_tpu_torch.engine.vectorize", fromlist=["x"]).plan_scan_units(
            ds, [T.Size(), T.Mean("price")])
        states = engine.run_scan(ds, [(u, u.ops) for u in units])
        assert len(states) == len(units)
        assert engine.last_degradation.failures[0].batch_index == 3
    assert scan.active_prefetch_workers() == []


class _FakeEvent:
    def __init__(self):
        self.synced = threading.Event()

    def synchronize(self):
        self.synced.set()


def test_staging_ring_waits_for_the_last_copy_before_reuse():
    ring = scan._StagingRing(2)
    for slot in list(ring._free.queue):
        slot["buffer"] = torch.empty(64, dtype=torch.uint8)  # no pinning on the CPU
    a, view_a = ring.acquire(16)
    b, _ = ring.acquire(16)
    assert a is not b and view_a.size == 16
    # both slots out: a third acquire blocks until one is released
    got = []
    waiter = threading.Thread(target=lambda: got.append(ring.acquire(8)))
    waiter.start()
    waiter.join(timeout=0.3)
    assert waiter.is_alive() and not got
    event = _FakeEvent()
    ring.release(a, event)
    waiter.join(timeout=10)
    assert not waiter.is_alive()
    assert got[0][0] is a and event.synced.is_set()  # waited for a's copy
    # a closed ring releases a waiting packer
    errors = []

    def blocked():
        try:
            ring.acquire(8)
        except scan._RingClosed as exc:
            errors.append(exc)

    t = threading.Thread(target=blocked)
    t.start()
    ring.close()
    t.join(timeout=10)
    assert not t.is_alive() and len(errors) == 1


def test_resident_scan_aliases_masks_of_columns_without_nulls():
    data, batch = _case("all-valid")
    data["price"] = np.ma.array(data["price"], mask=np.arange(len(data["id"])) % 5 == 0)
    _, _, _, ds = _run(data, _checks(T), batch, **RESIDENT)
    keys = {k for k, _ in ds._device_cache}
    assert "price::mask" in keys and "id::mask" not in keys and "q::mask" not in keys
    requests = [TReq("id", "values"), TReq("price", "values")]
    assert ds.estimated_device_bytes(requests) == len(data["id"]) * (1 + 8 + 8 + 1)


def test_reads_outside_the_scan_follow_the_mode():
    """The host group-by's where filter streams when its columns do not
    fit the budget, and gives what its resident read gives."""
    data, batch = _case("ragged")
    opts = dict(dense_grouping_budget_bytes=8, device_spill_grouping=False)
    streamed = _run(data, _grouping_checks(T), batch, device_cache_bytes=1, **opts)
    resident = _run(data, _grouping_checks(T), batch, **{**opts, **RESIDENT})
    assert_bit_equal(streamed, resident)
    assert streamed[3]._device_cache == {}
    assert scan.active_prefetch_workers() == []


def test_deferred_spill_under_a_streamed_scan():
    """The deferred spill form (``one_pass_spill=False``) beside a
    streamed scan: its re-read of the plan's columns, which fit the
    budget, is resident, and every state equals the all-resident run's."""
    data, batch = _case("ragged")
    data, checks = _widen(data, _grouping_checks(T))
    streamed = _run(data, checks, batch, one_pass_spill=False, **_stream(data))
    resident = _run(data, checks, batch, one_pass_spill=False, **RESIDENT)
    assert streamed[2].stream_stats is not None
    assert_bit_equal(streamed, resident)


def test_device_spill_state_keeps_only_its_groups():
    """A device spill state keeps its groups' keys and counts, not the
    scan-length buffers they were cut from: a streamed run's states held
    after it (as a caller that persists them holds them) pin 16 bytes a
    group on the device, not 16 bytes a row."""
    from deequ_tpu_torch.analyzers.spill import DeviceFrequencies

    data, batch = _case("ragged")
    data["id"] = np.repeat(data["id"][:300], 10)  # 300 wide-range keys, ten rows each
    data, checks = _widen(data, _grouping_checks(T))
    _, states, _, _ = _run(data, checks, batch, **_stream(data))
    spilled = [s for s in states.values() if isinstance(s, DeviceFrequencies)]
    assert spilled
    for state in spilled:
        keys, counts = state._dev
        assert counts.shape[0] == state._num_segments < len(data["id"])
        assert keys.shape[0] == state._num_segments
