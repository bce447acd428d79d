"""The ordered ingest pool (``deequ_tpu_torch/engine/ingest.py``) and
the streamed scan's pool path (``engine/scan.py::_pool_packed``), on
the CPU.

The load-bearing assertion is differential: ``ingest_workers=1`` runs
the single prefetch thread, so every metric and state computed with the
pool (workers > 1) must equal it bit for bit, through dictionary-delta
growth and mid-stream codec widening; and the pool's batches equal the
JAX package's stream of the same files. The ordering machinery
(reassembly, the lookahead bound, the error position, teardown) gets
unit cases against ``ordered_ingest`` directly, and the pinned ring
(taken in batch order) gets a case with jittered workers and fewer
slots than batches in flight. The retry, quarantine and checkpoint
cases of ``tests/test_ingest_pool.py`` are mirrored at the end, with a
pool restarted past batch 0 and a pool run with a quarantined batch,
each under a timeout; its multi-device cases wait for the multi-GPU
slice.
"""

import os
import threading
import time

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import deequ_tpu as R
from deequ_tpu import config as rconfig
from deequ_tpu.data.table import ColumnRequest as RReq
from deequ_tpu.data.table import DICT_DELTA_PREFIX as R_DELTA

import deequ_tpu_torch as T
from deequ_tpu_torch import config as tconfig
from deequ_tpu_torch.data.table import DICT_DELTA_PREFIX, ColumnRequest
from deequ_tpu_torch.engine import scan
from deequ_tpu_torch.engine.ingest import (
    IngestPoolStats,
    active_ingest_threads,
    ordered_ingest,
    resolve_ingest_lookahead,
    resolve_ingest_workers,
)


@pytest.fixture(autouse=True)
def _cpu():
    with tconfig.configure(device="cpu"):
        yield
    assert _settled()


def _settled():
    """No ingest thread alive, waiting up to 5 s for exits in flight."""
    deadline = time.time() + 5.0
    while active_ingest_threads() and time.time() < deadline:
        time.sleep(0.01)
    return active_ingest_threads() == []


# -- ordered_ingest --------------------------------------------------------------


class TestOrderedIngest:
    def test_release_order_is_source_order_under_jitter(self):
        rng = np.random.default_rng(7)
        delays = rng.uniform(0.0, 0.004, 32).tolist()

        def work(i):
            time.sleep(delays[i])
            return i * 10

        out = list(ordered_ingest(range(32), work, workers=4, lookahead=8))
        assert out == [i * 10 for i in range(32)]

    def test_workers_1_is_plain_passthrough(self):
        out = list(ordered_ingest(range(10), lambda i: i + 1, workers=1, lookahead=2))
        assert out == list(range(1, 11))

    def test_error_surfaces_at_exact_position(self):
        def work(i):
            if i == 5:
                raise ValueError("boom at five")
            return i

        received = []
        with pytest.raises(ValueError, match="boom at five"):
            for value in ordered_ingest(range(12), work, workers=4, lookahead=6):
                received.append(value)
        assert received == [0, 1, 2, 3, 4]
        assert _settled()

    def test_commit_runs_on_consumer_thread_in_order(self):
        consumer = threading.current_thread()
        committed = []

        def commit(result, item):
            assert threading.current_thread() is consumer
            committed.append(item)
            return result

        out = list(ordered_ingest(range(16), lambda i: -i, commit, workers=3, lookahead=4))
        assert committed == list(range(16))
        assert out == [-i for i in range(16)]

    def test_lookahead_bounds_in_flight_items(self):
        stats = IngestPoolStats()
        list(ordered_ingest(range(40), lambda i: i, workers=4, lookahead=5, stats=stats))
        assert stats.released == 40
        assert 1 <= stats.peak_in_flight <= 5

    def test_sizer_prices_peak_in_flight_bytes(self):
        stats = IngestPoolStats()
        list(ordered_ingest(range(8), lambda i: i, workers=2, lookahead=4, stats=stats,
                            sizer=lambda _r: 1000))
        assert 1000 <= stats.peak_in_flight_bytes <= 4000

    def test_abandoned_consumer_tears_down_all_threads(self):
        gen = ordered_ingest(range(1000), lambda i: time.sleep(0.001) or i,
                             workers=4, lookahead=4)
        assert next(gen) == 0
        gen.close()
        assert _settled()

    def test_resolvers(self):
        assert resolve_ingest_workers(3) == 3
        assert 1 <= resolve_ingest_workers(0) <= 4
        assert resolve_ingest_lookahead(7, workers=2) == 7
        assert resolve_ingest_lookahead(0, workers=3) == 6
        assert resolve_ingest_lookahead(1, workers=4) == 4

    def test_stats_by_worker(self):
        stats = IngestPoolStats()

        def work(i):
            stats.add("decode_s", 0.5)
            return i

        list(ordered_ingest(range(6), work, workers=3, lookahead=3, stats=stats))
        assert stats.decode_s == 3.0
        assert sum(w.get("decode_s", 0.0) for w in stats.by_worker.values()) == 3.0
        assert all(name.startswith("deequ-tpu-torch-ingest-") for name, w in
                   stats.by_worker.items() if "decode_s" in w)


# -- the engine: workers=1 is the oracle -------------------------------------------


@pytest.fixture(scope="module")
def pool_parquet(tmp_path_factory):
    """``tests/test_ingest_pool.py``'s source: floats (one masked),
    stats-narrowable ints, and a string vocabulary that GROWS per file so
    dictionary deltas are cut mid-stream."""
    directory = tmp_path_factory.mktemp("poolpq")
    rng = np.random.default_rng(29)
    for i in range(4):
        n = 900 + i * 150
        vocab = np.array([f"tok{j:03d}" for j in range((i + 1) * 5)])
        flat = np.array(["red", "green", "blue"])
        x = rng.normal(0.0, 1.0, n)
        pq.write_table(pa.table({
            "f": pa.array(rng.normal(50.0, 9.0, n)),
            "x": pa.array(x, pa.float64(), mask=(rng.random(n) < 0.1)),
            "k": pa.array(rng.integers(0, 120, n, dtype=np.int64)),
            "s": pa.array(vocab[rng.integers(0, len(vocab), n)]),
            "t": pa.array(flat[rng.integers(0, 3, n)]),
        }), os.path.join(directory, f"part-{i}.parquet"))
    return str(directory)


def _analyzers(P):
    # two string columns each with ACD and DataType: the planner forms
    # the delta groups only for two or more members, so the deltas stay
    # on the path and the run takes one pass
    return [P.Size(), P.Mean("f"), P.Minimum("f"), P.Maximum("f"), P.Completeness("x"),
            P.Mean("x"), P.Minimum("k"), P.Maximum("k"), P.ApproxCountDistinct("s"),
            P.DataType("s"), P.ApproxCountDistinct("t"), P.DataType("t")]


class _Keep:
    def __init__(self):
        self.states = {}

    def persist(self, analyzer, state):
        self.states[repr(analyzer)] = state


def _bits(state):
    from deequ_tpu_torch.interop import states_to_numpy

    return {k: (np.asarray(v).dtype.str, np.asarray(v).tobytes())
            for k, v in states_to_numpy(state).items()}


def _run(source, workers, analyzers=_analyzers, engine=None, **overrides):
    overrides.setdefault("device_cache_bytes", 1)
    overrides.setdefault("batch_size", 512)
    keep = _Keep()
    engine = engine or T.AnalysisEngine()
    with tconfig.configure(ingest_workers=workers, **overrides):
        ds = T.Dataset.from_parquet(source) if isinstance(source, str) else source
        ctx = T.AnalysisRunner.do_analysis_run(ds, analyzers(T), engine=engine,
                                               save_states_with=keep)
    metrics = []
    for a in analyzers(T):
        value = ctx.metric(a).value
        assert value.is_success, (a, value)
        v = value.get()
        metrics.append((repr(a), repr(v) if hasattr(v, "values") else float(v).hex()))
    return metrics, {k: _bits(s) for k, s in keep.states.items()}, engine


class TestPoolDifferential:
    @pytest.mark.parametrize("codecs", [False, True])
    def test_streaming_bit_identity_and_one_pass(self, pool_parquet, codecs):
        ref_m, ref_s, e1 = _run(pool_parquet, 1, wire_codecs=codecs)
        assert e1.stream_stats.pool is None and e1.data_passes == 1
        for workers in (2, 4):
            got_m, got_s, en = _run(pool_parquet, workers, wire_codecs=codecs)
            assert en.stream_stats.pool is not None
            assert en.stream_stats.pool.workers == workers
            assert got_m == ref_m and got_s == ref_s
            assert en.data_passes == 1
            assert en.stream_stats.deltas == e1.stream_stats.deltas > 2
            assert en.stream_stats.delta_values == e1.stream_stats.delta_values
        assert scan.active_prefetch_workers() == []

    def test_resident_path_unaffected(self, pool_parquet):
        ref = _run(pool_parquet, 1, device_cache_bytes=1 << 30)
        got = _run(pool_parquet, 4, device_cache_bytes=1 << 30)
        assert got[2].stream_stats is None
        assert got[:2] == ref[:2]

    def test_mid_stream_codec_widen_under_concurrency(self, tmp_path):
        # file 0's stats admit int8 for "k" in the JAX package; here the
        # probe of the first batch does, and file 2 violates mid-stream,
        # forcing CodecTable.widen with several batches in flight
        rng = np.random.default_rng(31)
        for i, hi in enumerate((90, 90, 30_000)):
            n = 800
            pq.write_table(pa.table({
                "k": pa.array(rng.integers(0, hi, n, dtype=np.int64)),
                "f": pa.array(rng.normal(size=n)),
                "s": pa.array([f"v{j % (5 + 40 * i)}" for j in range(n)]),
            }), os.path.join(tmp_path, f"part-{i}.parquet"), write_statistics=False)
        analyzers = lambda P: [P.Minimum("k"), P.Maximum("k"), P.Mean("k"),  # noqa: E731
                               P.Mean("f"), P.ApproxCountDistinct("s"),
                               P.ApproxCountDistinct("k")]
        ref = _run(str(tmp_path), 1, analyzers, batch_size=256, wire_codecs=True)
        got = _run(str(tmp_path), 4, analyzers, batch_size=256, wire_codecs=True)
        assert got[:2] == ref[:2]
        assert got[2].stream_stats.repacks >= 1

    def test_dictionary_delta_order_pin(self, pool_parquet):
        """The growing vocabulary is found in FIRST-SEEN order on both
        paths: the cached end-of-stream dictionaries are equal, and equal
        the JAX package's."""
        def dictionary_after(workers):
            ds = T.Dataset.from_parquet(pool_parquet)
            _run(ds, workers)
            return list(ds._dictionaries["s"]), list(ds._dictionaries["t"])

        d1, d4 = dictionary_after(1), dictionary_after(4)
        assert d4 == d1
        ref = R.Dataset.from_parquet(pool_parquet)
        with rconfig.configure(device_cache_bytes=0, batch_size=512, ingest_workers=4):
            R.AnalysisRunner.do_analysis_run(ref, _analyzers(R))
        assert d1 == (list(ref._dictionaries["s"]), list(ref._dictionaries["t"]))

    def test_pool_records_its_stats(self, pool_parquet):
        _, _, engine = _run(pool_parquet, 4)
        pool = engine.stream_stats.pool
        assert pool.workers == 4 and pool.released == engine.stream_stats.batches == 9
        assert pool.decode_s > 0 and pool.encode_s > 0 and pool.wall_s > 0
        assert 1 <= pool.peak_in_flight <= 8
        workers = [w for name, w in pool.by_worker.items() if "decode_s" in w]
        assert workers and sum(w["decode_s"] for w in workers) == pytest.approx(pool.decode_s)

    def test_wrapper_without_declaration_stays_on_single_thread(self, pool_parquet):
        class Opaque:
            def __init__(self, inner):
                self._inner = inner

            def __getattr__(self, name):
                return getattr(self._inner, name)

        ref = _run(pool_parquet, 1)
        got = _run(Opaque(T.Dataset.from_parquet(pool_parquet)), 4)
        assert got[2].stream_stats.pool is None
        assert got[:2] == ref[:2]


# -- the planner's items against the JAX package's stream ---------------------------


class TestIngestWorkItems:
    REQS = [("f", "values"), ("x", "values"), ("x", "mask"), ("s", "codes"), ("t", "codes"),
            ("k", "values")]

    def test_batches_equal_the_reference_stream(self, pool_parquet):
        """Drained items (decode, then commit, in order) hold the JAX
        package's streamed batches row for row (its batches are padded
        to the batch size, the port's last batch is short), the same
        dictionary deltas, and the same end-of-stream dictionaries."""
        with rconfig.configure(dict_deltas=True), tconfig.configure(dict_deltas=True):
            rds = R.Dataset.from_parquet(pool_parquet)
            tds = T.Dataset.from_parquet(pool_parquet)
            want = list(rds.device_batches([RReq(*r) for r in self.REQS], 512))
            items = list(tds.ingest_work_items([ColumnRequest(*r) for r in self.REQS], 512))
            got = [item.commit(item.decode()) for item in items]
        assert [i.index for i in items] == list(range(len(want)))
        assert [i.final for i in items] == [False] * (len(want) - 1) + [True]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            rows = len(g["f::values"])
            assert w["__row_mask__"][:rows].all() and not w["__row_mask__"][rows:].any()
            for key in ("f::values", "x::values", "x::mask", "s::codes", "t::codes",
                        "k::values"):
                np.testing.assert_array_equal(g[key], w[key][:rows].astype(g[key].dtype), key)
            deltas = {k for k in g if k.startswith(DICT_DELTA_PREFIX)}
            assert deltas == {k.replace(R_DELTA, DICT_DELTA_PREFIX)
                              for k in w if k.startswith(R_DELTA)}
            for k in deltas:
                wd = w[k.replace(DICT_DELTA_PREFIX, R_DELTA)]
                assert g[k]["start"] == wd["start"]
                assert list(g[k]["values"]) == list(wd["values"])
        for c in ("s", "t"):
            assert list(tds._dictionaries[c]) == list(rds._dictionaries[c])

    def test_host_batches_are_the_items_in_order(self, pool_parquet):
        requests = [ColumnRequest(*r) for r in self.REQS]
        a = list(T.Dataset.from_parquet(pool_parquet).host_batches(requests, 500))
        b = [i.commit(i.decode()) for i in
             T.Dataset.from_parquet(pool_parquet).ingest_work_items(requests, 500)]
        assert len(a) == len(b) == 9
        for x, y in zip(a, b):
            assert x.keys() == y.keys()
            for k in x:
                if k.startswith(DICT_DELTA_PREFIX):
                    assert x[k]["start"] == y[k]["start"]
                    assert list(x[k]["values"]) == list(y[k]["values"])
                else:
                    np.testing.assert_array_equal(x[k], y[k])


# -- the ring and the pool ------------------------------------------------------------


class _JitteredItem:
    """A work item whose decode sleeps a random while."""

    deferred = []

    def __init__(self, index, rows, delay):
        self.index, self.width, self.final, self._delay = index, rows, False, delay

    def decode(self):
        time.sleep(self._delay)
        return {"v::values": np.full(self.width, self.index, dtype=np.int64)}

    def commit(self, decoded):
        return decoded


class _ItemSource:
    supports_parallel_ingest = True

    def __init__(self, n, rows, seed, fail_at=None):
        rng = np.random.default_rng(seed)
        self.delays = rng.uniform(0.0, 0.01, n).tolist()
        self.n, self.rows, self.fail_at = n, rows, fail_at

    def ingest_work_items(self, requests, batch_size):
        for i in range(self.n):
            if i == self.fail_at:
                raise OSError(f"source read failed at batch {i}")
            yield _JitteredItem(i, self.rows, self.delays[i])


def _cpu_ring(slots, nbytes, first_seq=0):
    ring = scan._StagingRing(slots, first_seq)
    for slot in list(ring._free.queue):
        slot["buffer"] = torch.empty(nbytes, dtype=torch.uint8)  # no pinning on the CPU
    return ring


def _wire():
    ds = T.Dataset.from_pydict({"v": np.arange(4)})
    stats = scan.StreamStats()
    codecs = scan.wire_mod.resolve_codecs(ds, [ColumnRequest("v", "values")], enabled=False)
    return scan._StreamWire(ds, [ColumnRequest("v", "values")], codecs, stats)


def test_ring_with_fewer_slots_than_lookahead_releases_in_source_order():
    """Four jittered workers, eight batches in flight, two pinned slots:
    slots go out in batch order, so the consumer (which frees a slot
    once it has taken the batch) never waits on a batch that cannot get
    one. Finishes well inside its timeout, in source order."""
    rows, n = 64, 40
    ring = _cpu_ring(2, rows * 8)
    pool = IngestPoolStats()
    order, errors = [], []

    def consume():
        try:
            for packed in scan._pool_packed(_ItemSource(n, rows, 3), [], rows, _wire(), ring,
                                            4, 8, pool):
                order.append(int(packed.host[:8].view(np.int64)[0]))
                ring.release(packed.slot, None)
        except BaseException as exc:  # noqa: BLE001 — reported below
            errors.append(exc)

    t = threading.Thread(target=consume)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive(), "the pool deadlocked on the ring"
    assert not errors and order == list(range(n))
    assert pool.released == n and pool.peak_in_flight <= 8
    assert _settled()


@pytest.mark.parametrize("stop", ["source error", "consumer stops early"])
def test_pool_and_ring_leave_no_thread(stop):
    rows = 32
    ring = _cpu_ring(2, rows * 8)
    fail_at = 5 if stop == "source error" else None
    packed_iter = scan._pool_packed(_ItemSource(30, rows, 4, fail_at), [], rows, _wire(),
                                    ring, 4, 8, IngestPoolStats())
    got = []
    try:
        for packed in packed_iter:
            got.append(packed)
            ring.release(packed.slot, None)
            if stop == "consumer stops early" and len(got) == 3:
                break
    except OSError as exc:
        assert "batch 5" in str(exc)
    finally:
        ring.close()
        packed_iter.close()
    assert len(got) == (5 if fail_at else 3)
    assert _settled()


def test_streamed_run_raising_mid_stream_leaves_no_thread(pool_parquet, monkeypatch):
    """A decode that fails at batch 3 on every attempt, on one thread
    and in the pool: retried, then quarantined; the run ends degraded
    and no thread is left."""
    from deequ_tpu_torch.data import parquet

    decode = parquet._IngestItem.decode

    def failing(self):
        if self.index == 3:
            raise OSError("decode failed at batch 3")
        return decode(self)

    monkeypatch.setattr(parquet._IngestItem, "decode", failing)
    for workers in (1, 4):
        with tconfig.configure(ingest_workers=workers, device_cache_bytes=1, batch_size=512,
                               scan_retry=T.RetryPolicy(sleep=lambda _s: None)):
            ctx = T.AnalysisRunner.do_analysis_run(T.Dataset.from_parquet(pool_parquet),
                                                   _analyzers(T))
        assert all(m.value.is_success for m in ctx.all_metrics())
        degradation = ctx.degradation
        assert degradation.batches_quarantined == 1 and degradation.retries == 2
        assert degradation.failures[0].batch_index == 3
        assert degradation.failures[0].error_class == "OSError"
        assert "batch 3" in degradation.failures[0].message
        assert ctx.metric(T.Size()).value.get() == 4500 - 512
        assert _settled()


# -- config ------------------------------------------------------------------------------


class TestIngestConfig:
    def test_ingest_depth_reaches_prefetcher(self, pool_parquet):
        ref = _run(pool_parquet, 1, ingest_depth=1)
        got = _run(pool_parquet, 1, ingest_depth=5)
        assert got[:2] == ref[:2]

    def test_defaults(self):
        opts = tconfig.options()
        ref = rconfig.options()
        assert opts.ingest_depth >= 1
        assert opts.ingest_workers >= 0 and opts.ingest_lookahead >= 0
        assert (opts.dict_deltas, opts.dict_delta_capacity, opts.ingest_workers,
                opts.ingest_lookahead, opts.ingest_depth) == (
            ref.dict_deltas, ref.dict_delta_capacity, ref.ingest_workers,
            ref.ingest_lookahead, ref.ingest_depth)
        assert opts.dict_delta_capacity == 1 << 16


# -- resilience on the pool (the JAX package's tests/test_ingest_pool.py) -----------------


def _resilient(**overrides):
    overrides.setdefault("scan_retry", T.RetryPolicy(sleep=lambda _s: None))
    return overrides


class TestPoolResilience:
    def test_checkpoint_resume_lands_mid_pool(self, pool_parquet, tmp_path):
        from deequ_tpu_torch.engine.resilience import ScanKilled
        from deequ_tpu_torch.testing.faults import FaultInjectingDataset

        ref_m, ref_s, _ = _run(pool_parquet, 1)
        ckpt = T.ScanCheckpointer(str(tmp_path))
        engine = T.AnalysisEngine(checkpointer=ckpt)
        ds = FaultInjectingDataset(T.Dataset.from_parquet(pool_parquet), kill_at_batch=5)
        with pytest.raises(ScanKilled):
            _run(ds, 4, engine=engine, **_resilient(checkpoint_every_batches=2))
        assert [c["batch_index"] for c in engine.checkpoints] == [2, 4]
        assert ckpt._storage.list_keys("scan-ckpt-")
        got_m, got_s, _ = _run(ds, 4, engine=engine, **_resilient(checkpoint_every_batches=2))
        assert [c["batch_index"] for c in engine.checkpoints] == [6, 8]
        assert got_m == ref_m and got_s == ref_s
        assert ckpt._storage.list_keys("scan-ckpt-") == []
        assert _settled()

    def test_worker_death_retries_then_matches_oracle(self, pool_parquet):
        from deequ_tpu_torch.testing.faults import FaultInjectingDataset

        ref_m, ref_s, _ = _run(pool_parquet, 1)
        ds = FaultInjectingDataset(T.Dataset.from_parquet(pool_parquet), decode_transient={3: 1})
        keep = _Keep()
        with tconfig.configure(ingest_workers=4, device_cache_bytes=1, batch_size=512,
                               **_resilient()):
            ctx = T.AnalysisRunner.do_analysis_run(ds, _analyzers(T), save_states_with=keep)
        assert ("decode_transient", 3) in ds.faults_fired
        assert ctx.degradation.retries == 1 and not ctx.degradation.is_degraded
        assert {k: _bits(s) for k, s in keep.states.items()} == ref_s
        assert _settled()

    def test_permanent_worker_fault_quarantines(self, pool_parquet):
        from deequ_tpu.testing.faults import FaultInjectingDataset as RFaults
        from deequ_tpu_torch.testing.faults import FaultInjectingDataset

        ds = FaultInjectingDataset(T.Dataset.from_parquet(pool_parquet), decode_permanent={2})
        with tconfig.configure(ingest_workers=4, device_cache_bytes=1, batch_size=512,
                               **_resilient()):
            ctx = T.AnalysisRunner.do_analysis_run(ds, _analyzers(T))
        rds = RFaults(R.Dataset.from_parquet(pool_parquet), decode_permanent={2})
        with rconfig.configure(ingest_workers=4, device_cache_bytes=0, batch_size=512,
                               scan_retry=R.engine.resilience.RetryPolicy(sleep=lambda _s: None)
                               if hasattr(R, "engine") else None):
            rctx = R.AnalysisRunner.do_analysis_run(rds, _analyzers(R))

        def record(d):
            return (d.batches_quarantined, d.rows_skipped, d.retries, d.error_classes,
                    [(f.batch_index, f.rows, f.error_class, f.attempts) for f in d.failures])

        assert record(ctx.degradation) == record(rctx.degradation) == (
            1, 512, 0, ["ValueError"], [(2, 512, "ValueError", 1)])
        assert ("decode_permanent", 2) in ds.faults_fired
        assert ctx.metric(T.Size()).value.get() == rctx.metric(R.Size()).value.get() == 4500 - 512
        assert _settled()

    def test_kill_and_resume_from_a_fresh_dataset_with_deltas(self, pool_parquet, tmp_path):
        """Killed mid-stream, then resumed in a NEW ``Dataset.from_parquet``
        over the same files: its delta columns' accumulators start empty,
        absorb the skipped rows first, and the run ends bit-identical to
        an uninterrupted one (every state, the delta tables in the HLL
        and DataType groups' states too), on one thread and in the pool."""
        from deequ_tpu_torch.engine.resilience import ScanKilled
        from deequ_tpu_torch.testing.faults import FaultInjectingDataset

        ref_m, ref_s, ref_engine = _run(pool_parquet, 1)
        assert ref_engine.stream_stats.deltas > 2
        for workers in (1, 4):
            ckpt = T.ScanCheckpointer(str(tmp_path / f"w{workers}"))
            killed = FaultInjectingDataset(T.Dataset.from_parquet(pool_parquet), kill_at_batch=6)
            with pytest.raises(ScanKilled):
                _run(killed, workers, engine=T.AnalysisEngine(checkpointer=ckpt),
                     **_resilient(checkpoint_every_batches=4))
            # the resumed run retries a failed read too
            fresh = FaultInjectingDataset(T.Dataset.from_parquet(pool_parquet),
                                          transient={7: 1})
            engine = T.AnalysisEngine(checkpointer=ckpt)
            got_m, got_s, _ = _run(fresh, workers, engine=engine,
                                   **_resilient(checkpoint_every_batches=4))
            assert ("transient", 7) in fresh.faults_fired
            assert [c["batch_index"] for c in engine.checkpoints] == [8]  # resumed at 4
            assert fresh.prepasses == 1  # the skipped rows of the delta columns, once
            assert got_m == ref_m and got_s == ref_s
            assert ckpt._storage.list_keys("scan-ckpt-") == []
        assert _settled()


class TestIngestWorkItemsRestart:
    REQS = TestIngestWorkItems.REQS

    def test_resume_from_start_batch(self, pool_parquet):
        """Items from batch 3 of a FRESH dataset equal batches 3.. of a
        whole stream: the same rows and, after the accumulators caught
        up on the skipped rows, the same codes; the non-delta columns
        equal the JAX package's restarted stream."""
        requests = [ColumnRequest(*r) for r in self.REQS]
        with tconfig.configure(dict_deltas=True), rconfig.configure(dict_deltas=True):
            whole = [i.commit(i.decode()) for i in
                     T.Dataset.from_parquet(pool_parquet).ingest_work_items(requests, 512)]
            fresh = T.Dataset.from_parquet(pool_parquet)
            items = list(fresh.ingest_work_items(requests, 512, start_batch=3))
            got = [i.commit(i.decode()) for i in items]
            want = list(R.Dataset.from_parquet(pool_parquet).device_batches(
                [RReq(*r) for r in self.REQS], 512, start_batch=3))
        assert [i.index for i in items] == list(range(3, len(whole)))
        assert items[-1].final and len(got) == len(want)
        for g, w, r in zip(got, whole[3:], want):
            rows = len(g["f::values"])
            for key in ("f::values", "x::values", "x::mask", "s::codes", "t::codes", "k::values"):
                np.testing.assert_array_equal(g[key], w[key], key)
            for key in ("f::values", "x::values", "x::mask", "k::values"):
                np.testing.assert_array_equal(g[key], r[key][:rows].astype(g[key].dtype), key)
        # the first restarted batch ships each dictionary from entry 0
        for c in ("s", "t"):
            delta = got[0][DICT_DELTA_PREFIX + c]
            assert delta["start"] == 0
            assert fresh._delta_dicts[c].rows == sum(len(b["f::values"]) for b in whole)
        # a restarted scan does not cache the dictionaries (as the JAX package)
        assert fresh._dictionaries == {}


class _RestartableSource:
    """Jittered items from any start batch, optionally failing to decode
    one batch on every attempt."""

    supports_parallel_ingest = True

    def __init__(self, n, rows, seed, bad=None):
        rng = np.random.default_rng(seed)
        self.delays = rng.uniform(0.0, 0.005, n).tolist()
        self.n, self.rows, self.bad = n, rows, bad

    def ingest_work_items(self, requests, batch_size, start_batch=0):
        for i in range(start_batch, self.n):
            item = _JitteredItem(i, self.rows, self.delays[i])
            if i == self.bad:
                item.decode = lambda i=i: (_ for _ in ()).throw(ValueError(f"bad batch {i}"))
            yield item


def _drain_under_timeout(target, timeout=60):
    errors = []

    def run():
        try:
            target()
        except BaseException as exc:  # noqa: BLE001 — reported below
            errors.append(exc)

    t = threading.Thread(target=run)
    t.start()
    t.join(timeout=timeout)
    assert not t.is_alive(), "the pool deadlocked on the ring"
    assert not errors, errors


def test_pool_restarted_past_batch_zero_takes_its_slots_in_turn():
    """A source restarted at batch 3 (a retry or a resume) gets a ring
    whose turns begin at 3: with two slots and eight batches in flight
    it finishes, in order, well inside its timeout."""
    rows, n, start = 64, 24, 3
    ring = _cpu_ring(2, rows * 8, first_seq=start)
    order = []

    def consume():
        for packed in scan._pool_packed(_RestartableSource(n, rows, 5), [], rows, _wire(), ring,
                                        4, 8, IngestPoolStats(), start=start):
            order.append(int(packed.host[:8].view(np.int64)[0]))
            ring.release(packed.slot, None)

    _drain_under_timeout(consume)
    assert order == list(range(start, n))
    assert _settled()


def test_pool_with_a_quarantined_batch_does_not_hang():
    """``resilient_batches`` over the pool and a two-slot ring: batch 5
    fails to decode on every attempt, so it is quarantined and the source
    rebuilt at batch 6 (a fresh ring whose turns begin there); the run
    finishes inside its timeout with every other batch, in order."""
    from deequ_tpu_torch.engine.resilience import ScanDegradation, resilient_batches

    rows, n = 64, 20
    source = _RestartableSource(n, rows, 9, bad=5)
    rings, order = [], []
    degradation = ScanDegradation()

    def make_iter(start):
        ring = _cpu_ring(2, rows * 8, first_seq=start)
        rings.append(ring)
        return scan._pool_packed(source, [], rows, _wire(), ring, 4, 8, IngestPoolStats(),
                                 start=start)

    def close(it):
        rings[-1].close()
        it.close()

    def consume():
        for index, packed in resilient_batches(make_iter, T.RetryPolicy(sleep=lambda _s: None),
                                               degradation, lambda i: rows, close=close):
            order.append((index, int(packed.host[:8].view(np.int64)[0])))
            rings[-1].release(packed.slot, None)

    _drain_under_timeout(consume)
    assert order == [(i, i) for i in range(n) if i != 5]
    assert degradation.batches_quarantined == 1 and degradation.failures[0].batch_index == 5
    assert len(rings) == 2
    assert _settled()


# -- telemetry ------------------------------------------------------------------------


class TestIngestTelemetry:
    def test_the_pool_events_its_stats_as_the_reference_names_them(self, pool_parquet):
        """One ``ingest_pool`` event a pooled scan, on the scan's thread
        (inside the run's capture), with the JAX package's fields, and
        the stream's dictionary deltas counted and evented."""
        from deequ_tpu.telemetry import get_telemetry as ref_telemetry

        from deequ_tpu_torch.telemetry import get_telemetry

        with get_telemetry().run("pool") as cap:
            _, _, engine = _run(pool_parquet, 3)
        (event,) = [e for e in cap.final["events"] if e["event"] == "ingest_pool"]
        with ref_telemetry().run("pool") as rcap:
            with rconfig.configure(ingest_workers=3, device_cache_bytes=1, batch_size=512):
                R.AnalysisRunner.do_analysis_run(R.Dataset.from_parquet(pool_parquet),
                                                 _analyzers(R))
        (ref_event,) = [e for e in rcap.final["events"] if e["event"] == "ingest_pool"]
        assert set(event) == set(ref_event)
        assert event["workers"] == 3 and event["released"] == engine.stream_stats.batches
        deltas = [e for e in cap.final["events"] if e["event"] == "dictionary_delta"]
        assert deltas and cap.final["counters"]["engine.dict_deltas"] == len(deltas)
        assert {tuple(sorted(e)) for e in deltas} == {
            tuple(sorted(e)) for e in rcap.final["events"] if e["event"] == "dictionary_delta"}
