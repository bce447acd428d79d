"""Parquet sources on the port (``deequ_tpu_torch/data/parquet.py``)
against the JAX package, on the CPU.

The differentials of ``tests/test_parquet.py`` run on the port: a
parquet source equals the same rows in memory, and the JAX package's
run over the same files. Integer states, HLL registers, counts,
min/max, histograms and messages must be exact; float sums sit within
F64_RTOL (float64) or F32_RTOL (float32) of the other side, the bounds
every differential of the port states (both packages sum in their own
order). Beyond those:

- a streamed scan materializes no whole column;
- one-pass dictionary deltas: the HLL codes registers in both forms of
  K1's codes entry (the presence bitmap up to 4096 table entries, the
  per-row form past it) equal the JAX package's and the in-memory
  consts form's, bit for bit; DataType under deltas; the overflow error
  of ``dict_delta_capacity``, word for word;
- ``data_passes`` equals the JAX package's count (its telemetry counter
  ``engine.data_passes``: scans plus dictionary pre-passes) for the same
  suite on the same files, resident and streamed;
- the wire dtypes of a parquet source, decided from its row-group
  statistics, equal the JAX package's;
- decimal(7,2) columns read from parquet sum as the JAX package sums
  them;
- ``Dataset.from_pandas``, ``.table``, ``.record_batches`` and the two
  ``*_as_dataframe`` methods against the JAX package's.
"""

import math
import os
from decimal import Decimal

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import deequ_tpu as R
from deequ_tpu import config as rconfig
from deequ_tpu.data.table import ColumnRequest as RReq
from deequ_tpu.engine import wire as rwire
from deequ_tpu.io.state_provider import InMemoryStateProvider
from deequ_tpu.telemetry import get_telemetry

import deequ_tpu_torch as T
from deequ_tpu_torch import config as tconfig
from deequ_tpu_torch.data.parquet import ParquetDataset
from deequ_tpu_torch.data.table import ColumnRequest as TReq
from deequ_tpu_torch.engine import wire as twire
from deequ_tpu_torch.sketches import hll_hash

F64_RTOL = 1e-12
F32_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _cpu():
    with tconfig.configure(device="cpu"):
        yield


@pytest.fixture(scope="module")
def parquet_dir(tmp_path_factory):
    """Three parquet files with numeric, nullable, and string columns
    (``tests/test_parquet.py``'s fixture)."""
    directory = tmp_path_factory.mktemp("pq")
    rng = np.random.default_rng(5)
    tables = []
    for i in range(3):
        n = 1000 + i * 500
        x = rng.normal(10.0, 2.0, n)
        tables.append(pa.table({
            "x": pa.array(x, pa.float64(), mask=(rng.random(n) < 0.1)),
            "k": pa.array(rng.integers(0, 1 << 40, n)),
            "s": pa.array(rng.choice(["red", "green", "blue", "mail@x.io"], n)),
        }))
        pq.write_table(tables[-1], os.path.join(directory, f"part-{i}.parquet"))
    return str(directory), pa.concat_tables(tables)


def _analyzers(P):
    return [P.Size(), P.Completeness("x"), P.Mean("x"), P.Sum("x"), P.Minimum("x"),
            P.Maximum("x"), P.StandardDeviation("x"), P.Compliance("big x", "x > 10"),
            P.ApproxCountDistinct("k"), P.PatternMatch("s", r"@"), P.Histogram("s")]


def _values(ctx, analyzers):
    out = {}
    for a in analyzers:
        value = ctx.metric(a).value
        if value.is_failure:
            out[repr(a)] = ("fail", str(value.exception))
            continue
        v = value.get()
        out[repr(a)] = {k: d.absolute for k, d in v.values.items()} if hasattr(v, "values") else v
    return out


FLOAT_PREFIXES = ("Mean(", "Sum(", "StandardDeviation(", "Entropy(")


def _assert_close(got, want, rtol=F64_RTOL):
    assert got.keys() == want.keys()
    for k, w in want.items():
        if k.startswith(FLOAT_PREFIXES) and isinstance(w, float):
            assert math.isclose(got[k], w, rel_tol=rtol), (k, got[k], w)
        else:
            assert got[k] == w, k


def _port(source, analyzers, engine=None, **opts):
    with tconfig.configure(**opts):
        ds = T.Dataset.from_parquet(source) if isinstance(source, str) else source
        ctx = T.AnalysisRunner.do_analysis_run(ds, analyzers, engine=engine)
    return _values(ctx, analyzers)


def _reference(source, analyzers, **opts):
    with rconfig.configure(**opts):
        ds = R.Dataset.from_parquet(source) if isinstance(source, str) else source
        ctx = R.AnalysisRunner.do_analysis_run(ds, analyzers)
    return _values(ctx, analyzers)


# -- tests/test_parquet.py on the port ------------------------------------------


def test_matches_in_memory_results(parquet_dir):
    directory, full = parquet_dir
    streamed = T.Dataset.from_parquet(directory)
    assert streamed.num_rows == full.num_rows
    got = _port(streamed, _analyzers(T))
    _assert_close(got, _port(T.Dataset.from_arrow(full), _analyzers(T)))
    _assert_close(got, _reference(directory, _analyzers(R)))


@pytest.mark.parametrize("workers", [1, 4])
def test_streaming_path_never_materializes_columns(parquet_dir, workers):
    directory, _ = parquet_dir
    streamed = T.Dataset.from_parquet(directory, read_batch_rows=512)
    engine = T.AnalysisEngine(batch_size=700)
    got = _port(streamed, [T.Mean("x"), T.Size(), T.ApproxCountDistinct("s"),
                           T.MaxLength("s")], engine=engine,
                device_cache_bytes=1, ingest_workers=workers)
    assert got[repr(T.Size())] == streamed.num_rows
    assert engine.stream_stats is not None and engine.stream_stats.batches == 7
    # whole columns fill ParquetDataset._columns; the streamed path reads none
    assert len(streamed._columns) == 0 and streamed._device_cache == {}
    assert T.engine.scan.active_prefetch_workers() == []


def test_small_read_batches_rechunk_correctly(parquet_dir):
    directory, full = parquet_dir
    streamed = T.Dataset.from_parquet(directory, read_batch_rows=333)
    got = _port(streamed, [T.Size(), T.Sum("x"), T.Histogram("s")],
                engine=T.AnalysisEngine(batch_size=1000), device_cache_bytes=1)
    want = _port(T.Dataset.from_arrow(full), [T.Size(), T.Sum("x"), T.Histogram("s")])
    _assert_close(got, want)


def test_resident_path_also_works(parquet_dir):
    directory, full = parquet_dir
    ds = T.Dataset.from_parquet(directory)
    engine = T.AnalysisEngine()
    got = _port(ds, _analyzers(T), engine=engine)
    assert engine.stream_stats is None  # it stayed resident
    _assert_close(got, _port(T.Dataset.from_arrow(full), _analyzers(T)))


def test_single_file_and_metadata(parquet_dir):
    directory, _ = parquet_dir
    one = T.Dataset.from_parquet(os.path.join(directory, "part-0.parquet"))
    assert isinstance(one, ParquetDataset) and one.supports_parallel_ingest
    assert one.num_rows == 1000
    assert one.num_columns == 3
    assert one.schema.kind_of("x").is_numeric
    assert [(f.name, f.kind.value) for f in one.schema.fields] == [
        (f.name, f.kind.value) for f in R.Dataset.from_parquet(directory).schema.fields]
    # statistics answer without reading data
    assert not one._is_all_valid("x") and one._is_all_valid("k")
    assert one.integral_range("k") == R.Dataset.from_parquet(
        os.path.join(directory, "part-0.parquet")).integral_range("k")
    assert len(one._columns) == 0


# -- one-pass dictionary deltas ---------------------------------------------------


@pytest.fixture(scope="module")
def vocab_dir(tmp_path_factory):
    """Four files whose string vocabulary grows file by file, so deltas
    are cut mid-stream; ``wide`` draws from 6,000 values (past K1's 4096
    bitmap limit), ``narrow`` from 3, ``s`` grows 5 a file."""
    directory = tmp_path_factory.mktemp("vocab")
    rng = np.random.default_rng(29)
    wide = np.array([f"w{j:05d}" for j in range(6000)])
    for i in range(4):
        n = 900 + i * 150
        vocab = np.array([f"tok{j:03d}" for j in range((i + 1) * 5)])
        pq.write_table(pa.table({
            "f": pa.array(rng.normal(50.0, 9.0, n)),
            "x": pa.array(rng.normal(0.0, 1.0, n), pa.float64(), mask=(rng.random(n) < 0.1)),
            "k": pa.array(rng.integers(0, 120, n, dtype=np.int64)),
            "s": pa.array(vocab[rng.integers(0, len(vocab), n)], mask=rng.random(n) < 0.05),
            "t": pa.array(np.array(["red", "green", "blue"])[rng.integers(0, 3, n)]),
            "wide": pa.array(wide[rng.integers(0, 1500 * (i + 1), n)]),
            "num": pa.array(np.array(["12", "3.5", "true", "x"])[rng.integers(0, 4, n)]),
        }), os.path.join(directory, f"part-{i}.parquet"))
    return str(directory)


def _registers(P, source, analyzers, rconf, **opts):
    """Each analyzer's HLL registers (numpy) after one run."""
    if P is R:
        keep = InMemoryStateProvider()
        with rconf.configure(**opts):
            R.AnalysisRunner.do_analysis_run(source, analyzers, save_states_with=keep)
        return [np.asarray(keep.load(a).registers) for a in analyzers]
    states = {}

    class Keep:
        def persist(self, analyzer, state):
            states[analyzer] = state

    with rconf.configure(**opts):
        T.AnalysisRunner.do_analysis_run(source, analyzers, save_states_with=Keep())
    return [states[a].registers.numpy() for a in analyzers]


@pytest.mark.parametrize("cap,form", [(1 << 12, "bitmap"), (1 << 13, "rows")])
@pytest.mark.parametrize("workers", [1, 4])
def test_hll_codes_registers_in_both_forms(vocab_dir, cap, form, workers):
    """A delta group's hash tables are (C, cap) wide: up to 4096 entries
    K1's codes entry takes its presence-bitmap form, past it the per-row
    form. Either way, streamed with deltas (no pre-pass), the registers
    equal the JAX package's and the in-memory consts form's."""
    assert (cap <= hll_hash.PRESENCE_DICT_CAP) == (form == "bitmap")
    analyzers = lambda P: [P.ApproxCountDistinct(c) for c in ("s", "t", "wide")]  # noqa: E731
    opts = dict(device_cache_bytes=1, batch_size=512, dict_delta_capacity=cap)
    got = _registers(T, T.Dataset.from_parquet(vocab_dir), analyzers(T), tconfig,
                     ingest_workers=workers, **opts)
    opts["device_cache_bytes"] = 0
    want = _registers(R, R.Dataset.from_parquet(vocab_dir), analyzers(R), rconfig, **opts)
    consts = _registers(T, T.Dataset.from_arrow(pq.read_table(vocab_dir)), analyzers(T),
                        tconfig, batch_size=512)
    for g, w, c in zip(got, want, consts):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, c)
        assert g.any()


def test_delta_group_carries_its_tables_in_state(vocab_dir):
    from deequ_tpu_torch.engine.vectorize import plan_scan_units

    ds = T.Dataset.from_parquet(vocab_dir)
    with tconfig.configure(dict_delta_capacity=1 << 12):
        units, failures = plan_scan_units(ds, [T.ApproxCountDistinct("s"),
                                               T.ApproxCountDistinct("t"),
                                               T.DataType("s"), T.DataType("t")])
    assert not failures and len(units) == 2
    for unit in units:
        assert unit.ops.host_delta is not None and unit.ops.consts is None
        state = unit.ops.init()
        widths = {k: v.shape for k, v in state.items()}
        assert all(shape[-1] == 1 << 12 for k, shape in widths.items() if k != "counts"
                   and k != "registers")
    # planning read no data: the deltas build the dictionaries in the pass
    assert ds.prepasses == 0 and ds._dictionaries == {}


@pytest.mark.parametrize("workers", [1, 4])
def test_datatype_under_deltas(vocab_dir, workers):
    analyzers = lambda P: [P.DataType("num"), P.DataType("s"), P.DataType("t"),  # noqa: E731
                           P.ApproxCountDistinct("num")]
    got = _port(vocab_dir, analyzers(T), device_cache_bytes=1, batch_size=512,
                ingest_workers=workers)
    want = _reference(vocab_dir, analyzers(R), device_cache_bytes=0, batch_size=512)
    assert got == want
    resident = _port(vocab_dir, analyzers(T), batch_size=512)
    assert resident == want


def test_delta_capacity_overflow_fails_as_the_reference(vocab_dir):
    analyzers = lambda P: [P.ApproxCountDistinct("s"), P.ApproxCountDistinct("t"),  # noqa: E731
                           P.Mean("f")]
    got = _port(vocab_dir, analyzers(T), device_cache_bytes=1, batch_size=512,
                dict_delta_capacity=8)
    want = _reference(vocab_dir, analyzers(R), device_cache_bytes=0, batch_size=512,
                      dict_delta_capacity=8)
    message = ("dictionary for column 's' grew to 10 values, past dict_delta_capacity=8: "
               "raise DEEQU_TPU_DICT_DELTA_CAPACITY or set dict_deltas=False to fall back "
               "to the pre-pass consts path")
    for a in analyzers(T):
        assert message in got[repr(a)][1]
    assert got.keys() == want.keys() and all(message in v[1] for v in want.values())
    # the documented remedy: a larger capacity
    ok = _port(vocab_dir, analyzers(T), device_cache_bytes=1, batch_size=512,
               dict_delta_capacity=64)
    assert all(not isinstance(v, tuple) for v in ok.values())


@pytest.mark.parametrize("dict_deltas", [True, False])
def test_dictionaries_equal_the_pre_pass(vocab_dir, dict_deltas):
    """The accumulated dictionary (values and order) equals the pre-pass
    dictionary, and the JAX package's."""
    ds = T.Dataset.from_parquet(vocab_dir, read_batch_rows=300)
    _port(ds, [T.ApproxCountDistinct("s"), T.ApproxCountDistinct("t")],
          device_cache_bytes=1, batch_size=512, dict_deltas=dict_deltas)
    assert ("s" in ds._dictionaries) == dict_deltas or not dict_deltas
    fresh = T.Dataset.from_parquet(vocab_dir)
    ref = R.Dataset.from_parquet(vocab_dir)
    for c in ("s", "t"):
        assert list(ds.dictionary(c)) == list(fresh.dictionary(c)) == list(ref.dictionary(c))


# -- data passes --------------------------------------------------------------------


PASS_SUITES = {
    # two string columns, each with ACD and DataType: delta groups, one pass
    "deltas": lambda P: [P.Size(), P.Mean("f"), P.ApproxCountDistinct("s"),
                         P.ApproxCountDistinct("t"), P.DataType("s"), P.DataType("t")],
    # a lone string ACD takes the single path, which pays a pre-pass
    "single string": lambda P: [P.Mean("f"), P.ApproxCountDistinct("s")],
    # a predicate on a string column needs its dictionary at plan time
    "string predicate": lambda P: [P.Mean("f", where="t = 'red'"),
                                   P.ApproxCountDistinct("s"), P.ApproxCountDistinct("t")],
    "pattern": lambda P: [P.PatternMatch("num", r"^[0-9]+$"), P.Completeness("x")],
    "grouping": lambda P: [P.Uniqueness(["k"]), P.CountDistinct(["t"]), P.Histogram("s")],
    "numeric": lambda P: [P.Mean("f"), P.Maximum("k"), P.Completeness("x")],
}


@pytest.mark.parametrize("budget", ["streamed", "resident"])
@pytest.mark.parametrize("suite", sorted(PASS_SUITES))
def test_data_passes_equal_the_reference(vocab_dir, suite, budget):
    """Passes, fetches and (streamed) the dictionary deltas applied and
    their values, against the JAX package's telemetry counters, both
    packages at the same budget (a tiny one streams, and closes both
    device spill gates alike)."""
    analyzers = PASS_SUITES[suite]
    names = ("data_passes", "device_fetches", "dict_deltas", "dict_delta_values")
    tm = get_telemetry()
    before = [tm.counter(f"engine.{n}").value for n in names]
    cache = 1 if budget == "streamed" else 1 << 30
    want = _reference(vocab_dir, analyzers(R), batch_size=512, device_cache_bytes=cache)
    ref = [tm.counter(f"engine.{n}").value - b for n, b in zip(names, before)]
    engine = T.AnalysisEngine()
    got = _port(vocab_dir, analyzers(T), engine=engine, batch_size=512, device_cache_bytes=cache)
    stats = engine.stream_stats
    assert (stats is None) == (budget == "resident")
    port = [engine.data_passes, engine.device_fetches,
            0 if stats is None else stats.deltas, 0 if stats is None else stats.delta_values]
    assert port == ref
    _assert_close(got, want)


# -- wire dtypes ----------------------------------------------------------------------


def test_parquet_wire_dtypes_equal_the_reference(tmp_path):
    """Row-group statistics decide the integer columns' wire widths in
    both packages (the JAX package narrows int64 to int32 first, the
    port keeps int64 and narrows on the wire): every column ships at the
    same dtype."""
    rng = np.random.default_rng(0)
    n = 3000
    pq.write_table(pa.table({
        "a": pa.array(rng.integers(0, 100, n)),
        "b": pa.array(rng.integers(-40_000, 40_000, n)),
        "c": pa.array(rng.integers(0, 2**40, n)),
        "q": pa.array(rng.integers(0, 100, n).astype(np.int32)),
        "f": pa.array(np.round(rng.random(n), 2)),
        "g": pa.array(rng.random(n).astype(np.float32)),
        "s": pa.array([f"w{i % 9}" for i in range(n)]),
        "m": pa.array(rng.integers(5, 9, n), mask=rng.random(n) < 0.3),
    }), tmp_path / "w.parquet", row_group_size=1000)
    reqs = [("a", "values"), ("b", "values"), ("c", "values"), ("q", "values"),
            ("f", "values"), ("g", "values"), ("m", "values"), ("s", "lengths")]

    def shipped(ds, mod, Req, batches):
        requests = [Req(*r) for r in reqs]
        table = mod.resolve_codecs(ds, requests, True)
        batch = next(iter(batches(requests)))
        return {r.key: table.encode(r.key, np.asarray(batch[r.key])).dtype.name
                for r in requests}

    rds = R.Dataset.from_parquet(str(tmp_path))
    tds = T.Dataset.from_parquet(str(tmp_path))
    ref = shipped(rds, rwire, RReq, lambda q: rds.device_batches(q, 1024))
    port = shipped(tds, twire, TReq, lambda q: tds.host_batches(q, 1024))
    assert port == ref
    assert port["a::values"] == "int8" and port["c::values"] == "int64"


# -- decimals from parquet ------------------------------------------------------------


def test_decimal_7_2_parquet_columns_sum_as_the_reference(tmp_path):
    rng = np.random.default_rng(7)
    n = 5000
    cents = rng.integers(-999_999, 999_999, n)
    values = [None if i % 17 == 0 else Decimal(int(c)).scaleb(-2) for i, c in enumerate(cents)]
    pq.write_table(pa.table({"p": pa.array(values, pa.decimal128(7, 2)),
                             "s": pa.array([f"v{i % 7}" for i in range(n)])}),
                   tmp_path / "d.parquet", row_group_size=1024)
    analyzers = lambda P: [P.Sum("p"), P.Mean("p"), P.Minimum("p"), P.Maximum("p"),  # noqa: E731
                           P.ApproxCountDistinct("p"), P.Completeness("p"),
                           P.ApproxQuantile("p", 0.5), P.DataType("p")]
    want = _reference(str(tmp_path), analyzers(R), device_cache_bytes=0, batch_size=2048)
    for budget in (1, 1 << 30):
        got = _port(str(tmp_path), analyzers(T), device_cache_bytes=budget, batch_size=2048)
        _assert_close(got, want)
    # the values are the doubles nearest the decimals, as float(Decimal) gives
    ds = T.Dataset.from_parquet(str(tmp_path))
    host = ds.materialize(TReq("p", "values"))
    expect = np.array([0.0 if v is None else float(v) for v in values])
    np.testing.assert_array_equal(host, expect)


# -- the Arrow and pandas boundary ------------------------------------------------------


def test_from_pandas_table_and_record_batches_match_the_reference():
    df = pd.DataFrame({"a": [1, 2, None], "s": ["x", None, "y"], "f": [0.5, 1.5, 2.5]})
    tds, rds = T.Dataset.from_pandas(df), R.Dataset.from_pandas(df)
    assert [f.kind.value for f in tds.schema.fields] == [f.kind.value for f in rds.schema.fields]
    assert tds.table.to_pylist() == rds.table.to_pylist()
    got = [b.to_pylist() for b in tds.record_batches(["a", "s"], 2)]
    want = [b.to_pylist() for b in rds.record_batches(["a", "s"], 2)]
    assert got == want
    analyzers = lambda P: [P.Mean("a"), P.Completeness("s"), P.Sum("f")]  # noqa: E731
    assert _values(T.AnalysisRunner.do_analysis_run(tds, analyzers(T)), analyzers(T)) == \
        _values(R.AnalysisRunner.do_analysis_run(rds, analyzers(R)), analyzers(R))


def test_parquet_table_and_record_batches(parquet_dir):
    directory, full = parquet_dir
    ds = T.Dataset.from_parquet(directory)
    assert ds.table.equals(R.Dataset.from_parquet(directory).table)
    rows = sum(b.num_rows for b in ds.record_batches(["x", "s"], 700))
    assert rows == full.num_rows


def test_dataframes_match_the_reference():
    data = {"a": [1, 2, 3, None], "s": ["x", "y", None, "x"]}

    def run(P):
        check = (P.Check(P.CheckLevel.ERROR, "c").has_size(lambda n: n == 4)
                 .is_complete("a").has_max("a", lambda m: m == 3.0))
        return P.VerificationSuite().on_data(P.Dataset.from_pydict(data)).add_check(check).run()

    got, want = run(T), run(R)
    pd.testing.assert_frame_equal(got.check_results_as_dataframe(),
                                  want.check_results_as_dataframe())
    pd.testing.assert_frame_equal(got.success_metrics_as_dataframe(),
                                  want.success_metrics_as_dataframe())
    ctx = T.AnalysisRunner.do_analysis_run(T.Dataset.from_pydict(data), [T.Size(), T.Mean("a")])
    rctx = R.AnalysisRunner.do_analysis_run(R.Dataset.from_pydict(data), [R.Size(), R.Mean("a")])
    pd.testing.assert_frame_equal(ctx.success_metrics_as_dataframe(),
                                  rctx.success_metrics_as_dataframe())


@pytest.mark.parametrize("budget", ["streamed", "resident"])
def test_profile_and_suggestions_of_a_parquet_source(vocab_dir, budget):
    """The column profiler over a parquet source (its passes streamed or
    resident, its numeric cast of string columns through the in-memory
    reading) equals its run over the same rows in memory, and the
    suggestion run (its train/test split) suggests the same constraints."""
    cache = 1 if budget == "streamed" else 1 << 30
    with tconfig.configure(device_cache_bytes=cache, batch_size=512):
        got = T.ColumnProfilerRunner().on_data(T.Dataset.from_parquet(vocab_dir)).run()
        memory = T.Dataset.from_arrow(pq.read_table(vocab_dir))
        want = T.ColumnProfilerRunner().on_data(memory).run()
        suggested = (T.ConstraintSuggestionRunner().on_data(T.Dataset.from_parquet(vocab_dir))
                     .add_constraint_rules(T.DEFAULT_RULES).run())
        expected = (T.ConstraintSuggestionRunner().on_data(memory)
                    .add_constraint_rules(T.DEFAULT_RULES).run())
    assert sorted(got.profiles) == sorted(want.profiles)
    for c, w in want.profiles.items():
        g = got.profiles[c]
        assert (g.completeness, g.approximate_num_distinct_values, g.data_type) == \
            (w.completeness, w.approximate_num_distinct_values, w.data_type), c
        if getattr(w, "mean", None) is not None:
            assert math.isclose(g.mean, w.mean, rel_tol=F64_RTOL), c
            assert (g.minimum, g.maximum) == (w.minimum, w.maximum), c

    def codes(result):
        return sorted(s.code_for_constraint for v in result.constraint_suggestions.values()
                      for s in v)

    assert codes(suggested) == codes(expected) and codes(suggested)
