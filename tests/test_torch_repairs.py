"""Five faults of the port against the JAX package, repaired (F2-F6 of
the roadmap's fault queue), each held by differentials on the CPU.

- F2: an in-memory ``Dataset`` read from Arrow hands back its source's
  columns (``table``, ``record_batches``, ``filter_rows``, ``select``,
  ``slice_rows``, a mesh rank's ``row_share``), so the egress split of
  such a table is byte-equal to the JAX package's, resident and
  streamed. Lists and structs were written as nulls before, and a date64
  column failed the run.
- F3: a predicate over an UNKNOWN-kind column that has no ``values``
  (binary, large_binary, string_view, list, struct) answers ``IS [NOT]
  NULL`` from the mask; any other use fails its own analyzer at planning.
  The reference zeroes the whole pass there: a pinned divergence.
- F4: a Histogram over a null-typed column (or a dictionary of nulls)
  gives the reference's one ``NullValue`` bin.
- F5: subnormal floats read as zeros of their sign in the device's
  comparisons, min/max and sums, as XLA on the CPU reads them.
- F6: the row-level columns over null-typed and UNKNOWN-kind columns are
  the reference's, in both outcome modes and through the split.
"""

import datetime
import decimal
import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import deequ_tpu as R
from deequ_tpu import config as rconfig
from deequ_tpu.egress import RowLevelSink as RSink

import deequ_tpu_torch as T
from deequ_tpu_torch import config as tconfig
from deequ_tpu_torch.egress import RowLevelSink

MODES = {"resident": {"device_cache_bytes": 1 << 30}, "streaming": {"device_cache_bytes": 0}}
OUTCOMES = ["true", "null"]


@pytest.fixture(autouse=True)
def _cpu():
    with tconfig.configure(device="cpu"):
        yield


# ---------------------------------------------------------------- F2

def _dictionary(values, index_type, value_type=pa.string()):
    return pa.array(values).dictionary_encode().cast(pa.dictionary(index_type, value_type))


# every column type the reference reads (F1), six rows each with a null
SOURCE_ARRAYS = {
    "int8": lambda: pa.array([1, None, -3, 4, 5, 6], pa.int8()),
    "int16": lambda: pa.array([1, None, -3, 4, 5, 6], pa.int16()),
    "int32": lambda: pa.array([1, None, -3, 4, 5, 6], pa.int32()),
    "int64": lambda: pa.array([1, None, -3, 4, 5, 6], pa.int64()),
    "uint8": lambda: pa.array([1, None, 3, 255, 5, 6], pa.uint8()),
    "uint16": lambda: pa.array([1, None, 3, 65535, 5, 6], pa.uint16()),
    "uint32": lambda: pa.array([1, None, 3, 4, 5, 2**32 - 1], pa.uint32()),
    "uint64": lambda: pa.array([1, None, 3, 4, 5, 2**64 - 1], pa.uint64()),
    "float16": lambda: pa.array(np.array([1, 0, 2.5, 3, 4, 5], np.float16),
                                mask=np.array([0, 1, 0, 0, 0, 0], bool)),
    "float32": lambda: pa.array([1.5, None, 2.5, 3, 4, 5], pa.float32()),
    "float64": lambda: pa.array([1.5, None, 2.5, 3, 4, 5], pa.float64()),
    "bool": lambda: pa.array([True, None, False, True, True, False]),
    "string": lambda: pa.array(["a", None, "bc", "a", "zz", "q"]),
    "large_string": lambda: pa.array(["a", None, "bc", "a", "zz", "q"], pa.large_string()),
    "dictionary_int8": lambda: _dictionary(["a", None, "bc", "a", "zz", "q"], pa.int8()),
    "dictionary_uint16": lambda: _dictionary(["a", None, "bc", "a", "zz", "q"], pa.uint16()),
    "dictionary_int64_values": lambda: _dictionary([1, None, 2, 1, 7, 8], pa.int32(),
                                                   pa.int64()),
    "timestamp_ms_utc": lambda: pa.array([1, None, 2, 3, 4, 5], pa.timestamp("ms", tz="UTC")),
    "timestamp_us": lambda: pa.array([1, None, 2, 3, 4, 5], pa.timestamp("us")),
    "date32": lambda: pa.array([datetime.date(2024, 1, d) if d else None
                                for d in (1, 0, 3, 4, 5, 6)], pa.date32()),
    "date64": lambda: pa.array([86_400_000 * d if d else None for d in (1, 0, 3, 4, 5, 6)],
                               pa.date64()),
    "decimal128_7_2": lambda: pa.array([decimal.Decimal("1.25"), None, decimal.Decimal("-2.50"),
                                        decimal.Decimal("3.00"), decimal.Decimal("0.01"),
                                        decimal.Decimal("99999.99")], pa.decimal128(7, 2)),
    "decimal256_40_3": lambda: pa.array([decimal.Decimal("1.250"), None, decimal.Decimal("2"),
                                         decimal.Decimal("3"), decimal.Decimal("4"),
                                         decimal.Decimal("5")], pa.decimal256(40, 3)),
    "binary": lambda: pa.array([b"a", None, b"bc", b"a", b"zz", b"q"], pa.binary()),
    "large_binary": lambda: pa.array([b"a", None, b"bc", b"a", b"zz", b"q"], pa.large_binary()),
    "string_view": lambda: pa.array(["a", None, "bc", "a", "zz", "12"], pa.string_view()),
    "list": lambda: pa.array([[1], None, [2, 3], [1], [], [4]], pa.list_(pa.int64())),
    "struct": lambda: pa.array([{"a": 1}, None, {"a": 2}, {"a": 1}, {"a": 3}, {"a": 4}],
                               pa.struct([("a", pa.int64())])),
    "time32": lambda: pa.array([1, None, 2, 1, 5, 6], pa.time32("s")),
    "time64": lambda: pa.array([1, None, 2, 1, 5, 6], pa.time64("us")),
    "duration": lambda: pa.array([1, None, 2, 1, 5, 6], pa.duration("ms")),
    "null": lambda: pa.nulls(6),
}


def _source_table(name):
    return pa.table({"u": SOURCE_ARRAYS[name](), "x": pa.array([1.0, 2.0, 3.0, 4.0, 5.0, 6.0])},
                    metadata={b"origin": b"fixture"})


def _same_table(got, want):
    assert got.schema.equals(want.schema, check_metadata=True), (got.schema, want.schema)
    assert got.equals(want)


@pytest.mark.parametrize("name", sorted(SOURCE_ARRAYS))
def test_an_arrow_dataset_hands_back_its_source_columns(name):
    """``table``, ``select``, ``filter_rows``, ``slice_rows`` and
    ``record_batches`` equal the reference's, types, fields and schema
    metadata included; a mesh rank's share holds its slice."""
    table = _source_table(name)
    got, want = T.Dataset.from_arrow(table), R.Dataset.from_arrow(table)
    _same_table(got.table, want.table)
    _same_table(got.select(["x", "u"]).table, want.select(["x", "u"]).table)
    keep = np.array([True, True, False, True, False, True])
    if name == "string_view":  # Arrow filters no string_view rows
        for data in (got, want):
            with pytest.raises(pa.ArrowNotImplementedError):
                data.filter_rows(keep)
    else:
        _same_table(got.filter_rows(keep).table, want.filter_rows(keep).table)
    _same_table(got.slice_rows(1, 5).table, table.slice(1, 4))
    _same_table(got.row_share(1, 2).table, table.slice(3, 3))
    for g, w in zip(got.record_batches(["u", "x"], 4), want.record_batches(["u", "x"], 4)):
        assert g.equals(w) and g.schema.equals(w.schema, check_metadata=True)


def test_pandas_metadata_and_types_survive():
    pd = pytest.importorskip("pandas")
    df = pd.DataFrame({"u8": np.array([1, 2, 3], np.uint8),
                       "ts": pd.to_datetime([1, 2, 3], unit="s", utc=True)})
    _same_table(T.Dataset.from_pandas(df).table, R.Dataset.from_pandas(df).table)


def _mixed_table(n=240, seed=11, names=None):
    """The source types (six rows a pattern, repeated; every type but
    string_view, whose rows Arrow cannot take), a numeric column the
    checks read and a key."""
    rng = np.random.default_rng(seed)
    columns = {}
    for name in names or sorted(set(SOURCE_ARRAYS) - {"string_view"}):
        arr = SOURCE_ARRAYS[name]()
        columns[f"c_{name}"] = pa.concat_arrays([arr] * (n // len(arr)))
    columns["x"] = pa.array(rng.normal(size=n), mask=rng.random(n) < 0.05)
    columns["k"] = pa.array(rng.integers(0, n // 2, n))
    return pa.table(columns)


def _split_checks(P):
    return [P.Check(P.CheckLevel.ERROR, "typed").is_complete("x").satisfies("x < 0.8", "small")
            .has_min("k", lambda v: v >= 3)]


def _egress(P, table, out_dir, outcome, checks=_split_checks, **cfg):
    sink_type, config = (RSink, rconfig) if P is R else (RowLevelSink, tconfig)
    sink = sink_type(str(out_dir), filtered_row_outcome=outcome, tenant="t", run_id="r")
    with config.configure(batch_size=64, **cfg):
        result = P.VerificationSuite.do_verification_run(P.Dataset.from_arrow(table),
                                                         checks(P), row_level_sink=sink)
    return result.row_level_egress


def _split_files(out_dir):
    out = {}
    for split in ("clean", "quarantine"):
        with open(os.path.join(out_dir, split, "part-00000.parquet"), "rb") as fh:
            out[split] = fh.read()
    return out


@pytest.mark.parametrize("outcome", OUTCOMES)
@pytest.mark.parametrize("mode", sorted(MODES))
def test_the_split_of_an_arrow_table_is_byte_equal_to_the_reference(tmp_path, mode, outcome):
    """Every F1 type rides the split: the files are the reference's byte
    for byte, and each quarantined cell is its source value (a list cell
    is ``[2, 3]``, not None) in the type a parquet round trip gives it
    (the reference compacts its split from parquet segments: date64
    reads back as date32, time32[s] as time32[ms])."""
    table = _mixed_table()
    ref = _egress(R, table, tmp_path / "ref", outcome, **MODES[mode])
    got = _egress(T, table, tmp_path / "got", outcome, **MODES[mode])
    assert got.status == ref.status == "complete"
    assert (got.rows_clean, got.rows_quarantined) == (ref.rows_clean, ref.rows_quarantined)
    assert _split_files(tmp_path / "got") == _split_files(tmp_path / "ref")
    quarantine = pq.read_table(tmp_path / "got" / "quarantine")
    rows = pa.array(quarantine.column("__row_index__").to_pylist())
    for field in table.schema:
        published = quarantine.schema.field(field.name).type
        want = table.column(field.name).take(rows).cast(published, safe=False)
        assert quarantine.column(field.name).to_pylist() == want.to_pylist(), field.name
    assert [2, 3] in quarantine.column("c_list").to_pylist()


def test_a_string_view_column_aborts_the_split_as_in_the_reference(tmp_path):
    """Arrow has no take of string_view rows: both packages abort the
    sink, and every constraint fails with Arrow's message."""
    table = _mixed_table(names=["string_view", "int64"])
    for P, out in ((R, "ref"), (T, "got")):
        assert _egress(P, table, tmp_path / out, "true").status == "aborted"


def test_the_split_through_segments_equals_the_direct_split(tmp_path):
    """A checkpointing run compacts its split from span segments: the
    same bytes as the direct write's published types."""
    table = _mixed_table()
    _egress(T, table, tmp_path / "direct", "true", **MODES["resident"])
    sink = RowLevelSink(str(tmp_path / "seg"), tenant="t", run_id="r")
    engine = T.AnalysisEngine(checkpointer=T.io.state_provider.ScanCheckpointer(
        str(tmp_path / "ckpt")))
    with tconfig.configure(batch_size=64, checkpoint_every_batches=2, **MODES["resident"]):
        T.VerificationSuite.do_verification_run(T.Dataset.from_arrow(table), _split_checks(T),
                                                engine=engine, row_level_sink=sink)
    assert [c["batch_index"] for c in engine.checkpoints] == [2, 4]
    assert _split_files(tmp_path / "seg") == _split_files(tmp_path / "direct")


# ---------------------------------------------------------------- F3

def _values(P, data, analyzers, **cfg):
    """repr(analyzer) -> ("ok", value) or ("fail", exception type name);
    histograms as {label: absolute count}."""
    config = rconfig if P is R else tconfig
    if isinstance(data, pa.Table):
        data = P.Dataset.from_arrow(data)
    with config.configure(**cfg):
        ctx = P.AnalysisRunner.do_analysis_run(data, analyzers)
    out = {}
    for a in analyzers:
        value = ctx.metric(a).value
        if value.is_failure:
            out[repr(a)] = ("fail", type(value.exception).__name__)
            continue
        v = value.get()
        if hasattr(v, "values"):
            v = {k: d.absolute for k, d in v.values.items()}
        out[repr(a)] = ("ok", v)
    return out


VALUELESS = ["binary", "large_binary", "string_view", "list", "struct"]


def _null_tests(P):
    return [P.Completeness("x", where="u IS NOT NULL"), P.Compliance("nn", "u IS NOT NULL"),
            P.Compliance("n", "u IS NULL OR x > 5"), P.Mean("x"), P.Size()]


@pytest.mark.parametrize("name", VALUELESS)
def test_is_null_over_a_valueless_column_reads_its_mask(name):
    """The port answers IS [NOT] NULL over such a column as the reference
    answers it over an int64 column of the same nulls; a comparison of
    the column fails its own analyzer at planning and nothing else."""
    table = _source_table(name)
    twin = table.set_column(0, "u", pa.array([None if v is None else 0
                                              for v in table.column("u").to_pylist()],
                                             pa.int64()))
    want = _values(R, twin, _null_tests(R))
    got = _values(T, table, _null_tests(T) + [T.Compliance("bad", "u = 'a'"),
                                              T.Compliance("bad2", "LENGTH(u) > 1")])
    assert {k: got[k] for k in want} == want
    assert want[repr(R.Size())] == ("ok", 6.0)
    assert got[repr(T.Compliance("bad", "u = 'a'"))][0] == "fail"
    assert got[repr(T.Compliance("bad2", "LENGTH(u) > 1"))][0] == "fail"


@pytest.mark.parametrize("name", VALUELESS)
def test_the_reference_zeroes_a_pass_that_null_tests_a_valueless_column(name):
    """Pinned divergence: the reference's pass reads no row beside such a
    predicate (Size 0 of 6, every other analyzer fails); the port's
    answers are the test above."""
    got = _values(R, _source_table(name), _null_tests(R))
    assert got.pop(repr(R.Size())) == ("ok", 0.0)
    assert all(v == ("fail", "EmptyStateException") for v in got.values()), got


def test_is_null_over_a_valueless_column_streams(tmp_path):
    table = _source_table("list")
    want = _values(T, table, _null_tests(T), device_cache_bytes=1 << 30, batch_size=4)
    assert _values(T, table, _null_tests(T), device_cache_bytes=0, batch_size=4) == want


# ---------------------------------------------------------------- F4

NULL_COLUMNS = {
    "null": lambda n: pa.nulls(n),
    "dictionary_of_nulls": lambda n: pa.DictionaryArray.from_arrays(
        pa.array([None] * n, pa.int32()), pa.nulls(0)),
    "pydict_all_none": None,
}


def _null_dataset(P, name, n=7):
    x = [float(i % 3) for i in range(n)]
    if NULL_COLUMNS[name] is None:
        return P.Dataset.from_pydict({"u": [None] * n, "x": x})
    return P.Dataset.from_arrow(pa.table({"u": NULL_COLUMNS[name](n), "x": pa.array(x)}))


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("name", sorted(NULL_COLUMNS))
def test_histogram_of_a_null_column_is_one_null_bin(name, mode):
    """One ``NullValue`` bin, as the reference gives, and the pass's
    other grouping analyzers answer beside it."""
    analyzers = lambda P: [P.Histogram("u"), P.CountDistinct(["x"]),  # noqa: E731
                           P.Histogram("x"), P.Completeness("u")]
    want = _values(R, _null_dataset(R, name), analyzers(R), **MODES[mode])
    got = _values(T, _null_dataset(T, name), analyzers(T), **MODES[mode])
    assert got == want
    assert got[repr(T.Histogram("u"))] == ("ok", {"NullValue": 7})


# ---------------------------------------------------------------- F5

SUBNORMALS = [1e-310, -1e-310, 5e-324, 1.0, 0.0]


def _subnormal_analyzers(P):
    return [P.Compliance("pos", "f > 0"), P.Compliance("neg", "f < 0"),
            P.Compliance("zero", "f = 0"), P.Minimum("f"), P.Maximum("f"), P.Sum("f"),
            P.Mean("f"), P.StandardDeviation("f"), P.Completeness("g", where="f > 0"),
            P.Sum("g", where="f <= 0"), P.CustomSql("SUM(f) / COUNT(*)"),
            P.Correlation("f", "g")]


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_subnormals_read_as_zeros_as_in_the_reference(dtype, mode):
    """The roadmap's measured values (port before the repair: Compliance
    f > 0 0.6, f < 0 0.2, f = 0 0.2, Minimum -1e-310) now equal the
    reference's, through the fused stats group, a lone analyzer, the
    predicates, CustomSql and Correlation."""
    f = np.array(SUBNORMALS * 3, dtype=np.float64)
    if dtype == "float32":
        f = np.array([1e-40, -1e-40, 1e-45, 1.0, 0.0] * 3, dtype=np.float32)
    table = pa.table({"f": f, "g": np.arange(len(f), dtype=np.float64)})
    want = _values(R, table, _subnormal_analyzers(R), batch_size=4, **MODES[mode])
    got = _values(T, table, _subnormal_analyzers(T), batch_size=4, **MODES[mode])
    assert got.keys() == want.keys()
    for key, w in want.items():
        g = got[key]
        if g[0] == w[0] == "ok" and key.startswith(("Sum", "Mean", "Standard", "Corr")):
            assert g[1] == pytest.approx(w[1], rel=1e-12, abs=0), key
        else:
            assert g == w, key
    assert got[repr(T.Compliance("pos", "f > 0"))] == ("ok", 0.2)
    assert got[repr(T.Compliance("zero", "f = 0"))] == ("ok", 0.8)
    alone = _values(T, table, [T.Minimum("f")])
    assert alone == _values(R, table, [R.Minimum("f")]) == {repr(T.Minimum("f")): ("ok", 0.0)}


@pytest.mark.parametrize("inplace", [False, True])
@pytest.mark.parametrize("dtype", ["float16", "bfloat16", "float32", "float64"])
def test_flush_subnormals_keeps_signs_nans_and_infinities(dtype, inplace):
    """A subnormal becomes a zero of its sign; zeros keep theirs; normals,
    infinities and NaN pass. In place, the caller's tensor is the result."""
    import torch

    from deequ_tpu_torch.sql.predicate import flush_subnormals

    dt = getattr(torch, dtype)
    tiny = torch.finfo(dt).tiny
    x = torch.tensor([tiny / 4, -tiny / 4, tiny, -tiny, 0.0, -0.0, 1.5, float("inf"),
                      -float("inf"), float("nan")], dtype=dt)
    assert x[0] != 0 and x[1] != 0  # subnormal in its own dtype
    source = x.clone()
    out = flush_subnormals(x, inplace=inplace)
    assert (out is x) == inplace
    if not inplace:  # the caller's tensor keeps every bit
        assert torch.equal(x.view(torch.uint8), source.view(torch.uint8))
    assert out[:2].tolist() == [0.0, 0.0]
    assert torch.signbit(out).tolist()[:6] == [False, True, False, True, False, True]
    assert out[2:9].tolist() == source[2:9].tolist()
    assert torch.isnan(out[-1])


def test_a_fused_step_stacks_a_float_block_once_and_flushed():
    """The stats group and the HLL group read one stacked block a step,
    flushed as it is made; the batch's own columns keep their subnormals
    (the KLL step and the device spill read them)."""
    import torch

    from deequ_tpu_torch.engine import vectorize

    a = torch.tensor([1e-310, -2.0, 3.0], dtype=torch.float64)
    b = torch.tensor([-1e-310, 5e-324, 1.0], dtype=torch.float64)
    batch = {"a::values": a, "b::values": b}
    stack = vectorize._shared_stack(batch, ("a", "b"), "values")
    assert stack.tolist() == [[0.0, -2.0, 3.0], [-0.0, 0.0, 1.0]]
    assert vectorize._shared_stack(batch, ("a", "b"), "values") is stack
    assert sorted(batch) == sorted(["a::values", "b::values",
                                    vectorize._SHARED_PREFIX + "values:a\x1fb"])
    assert a[0].item() == 1e-310 and b[1].item() == 5e-324


def test_an_all_subnormal_column_sums_to_zero():
    table = pa.table({"f": np.array([1e-310, 2e-310, 3e-310])})
    analyzers = lambda P: [P.Sum("f"), P.Completeness("f", where="f > 0")]  # noqa: E731
    assert _values(T, table, analyzers(T)) == _values(R, table, analyzers(R))


# ---------------------------------------------------------------- F6

F6_COLUMNS = sorted(set(SOURCE_ARRAYS) - set(
    ["int8", "int16", "int32", "int64", "uint8", "uint16", "uint32", "uint64", "float16",
     "float32", "float64", "bool", "string", "large_string", "dictionary_int8",
     "dictionary_uint16", "dictionary_int64_values", "timestamp_ms_utc", "timestamp_us",
     "date32", "date64", "decimal128_7_2", "decimal256_40_3"]))


def _family_check(P):
    """Every row-level family over ``u`` (the column under test) and a
    where-filtered one, beside a control on ``x``."""
    return (P.Check(P.CheckLevel.ERROR, "families")
            .is_complete("u").is_unique("u").has_unique_value_ratio(["u"], lambda v: v > 0.1)
            .has_min_length("u", lambda v: v >= 1).has_max_length("u", lambda v: v <= 1)
            .has_min("u", lambda v: v >= 0).has_max("u", lambda v: v <= 3)
            .is_primary_key("u", "x").has_pattern("u", "a").contains_email("u")
            .has_min("x", lambda v: v >= 2).where("x > 1.5").is_unique("x"))


def _row_columns(P, table, outcome):
    result = P.VerificationSuite().on_data(P.Dataset.from_arrow(table)).add_check(
        _family_check(P)).run()
    got = result.row_level_results_as_dataset(filtered_row_outcome=outcome).table
    return {name: got.column(name).to_pylist() for name in got.schema.names}


@pytest.mark.parametrize("outcome", OUTCOMES)
@pytest.mark.parametrize("name", F6_COLUMNS)
def test_row_level_columns_over_unknown_and_null_columns_are_the_references(name, outcome):
    """The same columns, row for row, as the reference's. Before the
    repair the port answered uniqueness on binary, time and null
    columns, lengths on binary, min/max on time and null columns, and a
    key with a null column, where the reference gives no column; and gave
    none for a pattern over a null column, where the reference's is False
    on every row."""
    table = _source_table(name)
    want = _row_columns(R, table, outcome)
    with tconfig.configure(device="cpu"):
        got = _row_columns(T, table, outcome)
    assert list(got) == list(want)
    assert got == want


@pytest.mark.parametrize("name", ["null", "time32"])
def test_compliance_over_a_null_or_time32_column_diverges(name):
    """Pinned divergence: the port answers a Compliance over such a
    column, aggregate and row-level; the reference fails the aggregate
    and gives no row-level column."""
    table = _source_table(name)

    def run(P):
        check = P.Check(P.CheckLevel.ERROR, "c").satisfies("u IS NULL OR x > 3", "nullish")
        result = P.VerificationSuite().on_data(P.Dataset.from_arrow(table)).add_check(
            check).run()
        return result, result.row_level_results_as_dataset().table

    ref, ref_rows = run(R)
    got, got_rows = run(T)
    assert ref_rows.num_columns == 0 or "nullish" not in " ".join(ref_rows.schema.names)
    (col,) = [n for n in got_rows.schema.names if "nullish" in n]
    want = [v is None or x > 3 for v, x in zip(table.column("u").to_pylist(),
                                               table.column("x").to_pylist())]
    assert got_rows.column(col).to_pylist() == want
    (result,) = got.check_results.values()
    assert result.constraint_results[0].metric.value.is_success


@pytest.mark.parametrize("outcome", OUTCOMES)
@pytest.mark.parametrize("mode", sorted(MODES))
def test_the_split_of_unknown_and_null_columns_is_the_references(tmp_path, mode, outcome):
    """The families above through the sink: the same outcome columns and
    quarantine choice, byte for byte, and the same constraints reported
    unsupported. Named divergence: the reasons given for those are each
    package's own (Arrow's kernel errors in the reference, the port's
    TypeError naming the repr)."""
    table = _mixed_table(names=[n for n in F6_COLUMNS if n != "string_view"])
    table = table.append_column("u", table.column("c_null"))

    def checks(P):
        check = P.Check(P.CheckLevel.ERROR, "families")
        for c in table.schema.names:
            if c.startswith("c_"):
                check = (check.is_unique(c).has_min_length(c, lambda v: v >= 1)
                         .has_max(c, lambda v: v <= 3).has_pattern(c, "a"))
        return [check.is_complete("x").satisfies("x < 0.8", "small")]

    ref = _egress(R, table, tmp_path / "ref", outcome, checks=checks, **MODES[mode])
    got = _egress(T, table, tmp_path / "got", outcome, checks=checks, **MODES[mode])
    assert got.status == ref.status == "complete"
    assert got.constraints == ref.constraints
    assert got.unsupported.keys() == ref.unsupported.keys()
    assert len(got.unsupported) >= 10
    assert _split_files(tmp_path / "got") == _split_files(tmp_path / "ref")
