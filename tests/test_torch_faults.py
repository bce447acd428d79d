"""Two faults of the port's Dataset, repaired, against the JAX package on
the CPU.

1. A uint64 column used to fail the Dataset's construction, and with it
   every analyzer of the table. Torch has no uint64 arithmetic, so the
   port keeps the unsigned value as float64 for the analyzers that read
   values (as the JAX package converts it for sums and extrema) and the
   int64 bit view for the HLL hash (the JAX package's registers of a
   uint64 column are those of its raw 64 bits). Integer state (counts,
   min, max, HLL registers) must equal the reference exactly; Sum, Mean
   and StandardDeviation sum float64 in another order, so they must sit
   within FLOAT_RTOL of the reference.
2. A null-typed column under ApproxCountDistinct used to fail every
   analyzer of the fused scan. It now has an all-masked ``values``
   repr, so its estimate is 0.0 (the reference's answer for a column
   with no value). The reference itself zeroes the whole pass on such a
   table, so the other analyzers are held against the reference's run
   without ``ApproxCountDistinct("s")``.
3. F1: whole tables of column types the reference reads used to be
   refused when the Dataset was built. Decimals (decimal128 and
   decimal256) now read as FRACTIONAL float64 values cast as the
   reference casts them; binary, large_binary, string_view, list,
   struct, time32, time64 and duration columns read as Kind UNKNOWN with
   their masks; unsigned dictionary indices are cast to int32 before the
   null fill; ``from_pydict`` maps datetime, date, Decimal and bytes
   values as ``pyarrow.table`` does. Each type is one parametrised case.
   Where the reference's own answer is wrong (ApproxCountDistinct of an
   UNKNOWN column, Arrow dictionaries with unsigned indices, MinLength or
   MaxLength alone on an Arrow dictionary column) a named test pins the
   divergence.
"""

import math

import numpy as np
import pyarrow as pa
import pytest

import deequ_tpu as R
from deequ_tpu.io.state_provider import InMemoryStateProvider

import deequ_tpu_torch as T
from deequ_tpu_torch.data import ColumnRequest, Kind
from deequ_tpu_torch import config as tconfig

# float64 sums of up to 5,000 values near 2^64, taken in another order
# than XLA's: a few ulp of the result
FLOAT_RTOL = 1e-12
NAMES = ["Size", "Completeness", "Sum", "Mean", "Minimum", "Maximum",
         "StandardDeviation", "ApproxCountDistinct"]
EXACT = {"Size", "Completeness", "Minimum", "Maximum", "ApproxCountDistinct"}


class _Keep:
    def __init__(self):
        self.states = {}

    def persist(self, analyzer, state):
        self.states[repr(analyzer)] = state


def _analyzers(pkg, column, where=None):
    out = []
    for name in NAMES:
        cls = getattr(pkg, name)
        out.append(cls(where=where) if name == "Size" else cls(column, where=where))
    return out


def _metrics(pkg, dataset, analyzers, **kwargs):
    ctx = pkg.AnalysisRunner.do_analysis_run(dataset, analyzers, **kwargs)
    return {repr(a): ctx.metric(a).value.get() for a in analyzers}


def _compare(got, want):
    assert got.keys() == want.keys()
    for key, w in want.items():
        g = got[key]
        if any(key.startswith(name + "(") for name in EXACT):
            assert g == w, key
        else:
            assert math.isclose(g, w, rel_tol=FLOAT_RTOL), (key, g, w)


def _uint64_columns():
    rng = np.random.default_rng(64)
    odd = rng.integers(0, 2**63, 5000, dtype=np.uint64) * np.uint64(2) + np.uint64(1)
    masked = np.ma.array(odd, mask=rng.random(5000) < 0.1)
    return {
        "tiny": np.array([0, 2**64 - 1, 5], dtype=np.uint64),
        "odd": odd,
        "nullable": masked,
    }


@pytest.mark.parametrize("column", ["tiny", "odd", "nullable"])
def test_uint64_column_runs_every_ported_analyzer_as_the_reference(column):
    values = _uint64_columns()[column]
    data = {"u": values, "i": np.arange(len(values))}
    analyzers = lambda pkg: _analyzers(pkg, "u") + [pkg.Mean("i")]  # noqa: E731
    want = _metrics(R, R.Dataset.from_pydict(data), analyzers(R))
    with tconfig.configure(device="cpu"):
        got = _metrics(T, T.Dataset.from_pydict(data), analyzers(T))
    _compare(got, want)
    assert all(v == v for v in got.values())  # no failure, no NaN
    if column == "tiny":
        assert got[repr(T.Maximum("u"))] == 1.8446744073709552e19
        assert got[repr(T.Sum("u"))] == 1.8446744073709552e19
        assert got[repr(T.Mean("u"))] == 6.148914691236517e18


def test_uint64_hll_registers_equal_the_reference_stacked_single_and_filtered():
    """Two uint64 columns stack into one HLL group, a third stays single,
    and a fourth analyzer filters on a uint64 column, over three batches:
    registers equal the reference's exactly."""
    cols = _uint64_columns()
    rng = np.random.default_rng(3)
    n = 5000
    table = pa.table({
        "a": pa.array(cols["odd"]),
        "b": pa.array(rng.integers(0, 2**64 - 1, n, dtype=np.uint64, endpoint=True)),
        "c": pa.array(cols["nullable"].data, mask=np.ma.getmaskarray(cols["nullable"])),
        "q": pa.array(rng.integers(0, 100, n)),
    })
    analyzers = lambda pkg: [  # noqa: E731
        pkg.ApproxCountDistinct("a"), pkg.ApproxCountDistinct("b"),
        pkg.ApproxCountDistinct("c"), pkg.ApproxCountDistinct("a", where="q > 40"),
        pkg.ApproxCountDistinct("b", where="q > 40"),
    ]
    rkeep = InMemoryStateProvider()
    from deequ_tpu import config as rconfig

    with rconfig.configure(batch_size=2048):
        R.AnalysisRunner.do_analysis_run(
            R.Dataset.from_arrow(table), analyzers(R), save_states_with=rkeep)
    tkeep = _Keep()
    with tconfig.configure(device="cpu", batch_size=2048):
        T.AnalysisRunner.do_analysis_run(
            T.Dataset.from_arrow(table), analyzers(T), save_states_with=tkeep)
    for r, t in zip(analyzers(R), analyzers(T)):
        want = np.asarray(rkeep.load(r).registers)
        assert want.any()
        np.testing.assert_array_equal(tkeep.states[repr(t)].registers.numpy(), want,
                                      err_msg=repr(t))


def test_uint64_values_never_reach_torch_as_uint64():
    ds = T.Dataset.from_pydict({"u": _uint64_columns()["tiny"]})
    assert ds.schema.kind_of("u") == Kind.INTEGRAL
    assert ds.hll_repr("u") == "bits"
    values = ds.materialize(ColumnRequest("u", "values"))
    bits = ds.materialize(ColumnRequest("u", "bits"))
    assert values.dtype == np.float64 and bits.dtype == np.int64
    assert values.tolist() == [0.0, 2.0**64, 5.0]
    assert bits.tolist() == [0, -1, 5]


NULL_TABLE = {"s": [None, None, None], "x": [1.0, 2.0, 3.0], "y": [5, 6, 7]}


@pytest.mark.parametrize("source", ["pydict", "arrow"])
def test_null_typed_column_under_approx_count_distinct(source):
    others = lambda pkg: [pkg.Size(), pkg.Mean("y"), pkg.ApproxCountDistinct("x")]  # noqa: E731
    # the reference zeroes its whole pass with ApproxCountDistinct("s")
    # in it, so the port is held to the reference's run without it
    want = _metrics(R, R.Dataset.from_pydict(NULL_TABLE), others(R))
    if source == "pydict":
        dataset = T.Dataset.from_pydict(NULL_TABLE)
    else:
        dataset = T.Dataset.from_arrow(pa.table({
            "s": pa.nulls(3), "x": pa.array(NULL_TABLE["x"]), "y": pa.array(NULL_TABLE["y"]),
        }))
    assert dataset.schema.kind_of("s") == Kind.UNKNOWN
    with tconfig.configure(device="cpu"):
        got = _metrics(T, dataset, others(T) + [T.ApproxCountDistinct("s")])
    assert got.pop(repr(T.ApproxCountDistinct("s"))) == 0.0
    assert got == want
    assert want == {
        repr(T.Size()): 3.0,
        repr(T.Mean("y")): 6.0,
        repr(T.ApproxCountDistinct("x")): 3.000279510809919,
    }


# -- F1: column types the reference reads ---------------------------------
#
# Every case builds one Arrow (or Python) table, runs the same analyzers
# through both packages on the CPU, and holds the port to the reference:
# integer states, counts, min/max, histograms and messages exactly, float
# sums within FLOAT_RTOL. Where the reference's own answer is wrong, a
# named test below pins the divergence.

from datetime import date, datetime, timezone
from decimal import Decimal


def _values(pkg, table, analyzers, **kwargs):
    """repr(analyzer) -> ("ok", value) or ("fail", exception type name,
    message); histograms as {label: absolute count}."""
    data = pkg.Dataset.from_arrow(table) if isinstance(table, pa.Table) else table
    ctx = pkg.AnalysisRunner.do_analysis_run(data, analyzers, **kwargs)
    out = {}
    for a in analyzers:
        value = ctx.metric(a).value
        if value.is_failure:
            out[repr(a)] = ("fail", type(value.exception).__name__, str(value.exception))
            continue
        v = value.get()
        if hasattr(v, "values"):
            v = {k: d.absolute for k, d in v.values.items()}
        out[repr(a)] = ("ok", v)
    return out


def _both(table_of, analyzers_of, **kwargs):
    """(port, reference) results of one table; ``table_of(pkg)`` builds
    the table or dataset the package reads."""
    want = _values(R, table_of(R), analyzers_of(R))
    with tconfig.configure(device="cpu", **kwargs):
        got = _values(T, table_of(T), analyzers_of(T))
    return got, want


FLOAT_NAMES = ("Sum(", "Mean(", "StandardDeviation(", "Entropy(")


def _assert_same(got, want):
    assert got.keys() == want.keys()
    for key, w in want.items():
        g = got[key]
        if key.startswith(FLOAT_NAMES) and g[0] == w[0] == "ok":
            assert math.isclose(g[1], w[1], rel_tol=FLOAT_RTOL), (key, g, w)
        else:
            assert g == w, key


def _decimal_array(units, scale, typ, nulls):
    """A decimal array of ``units / 10**scale`` built from integer units
    without a Python loop: the int64 units become the low words of the
    little-endian two's-complement storage."""
    units = np.asarray(units, dtype=np.int64)
    words = typ.byte_width // 8
    storage = np.empty((len(units), words), dtype=np.int64)
    storage[:, 0] = units
    storage[:, 1:] = (units >> 63)[:, None]
    validity = pa.array(~nulls).buffers()[1] if nulls.any() else None
    return pa.Array.from_buffers(typ, len(units), [validity, pa.py_buffer(storage.tobytes())],
                                 null_count=int(nulls.sum()))


def test_decimal_7_2_column_sums_as_the_reference():
    table = pa.table({"d": pa.array([Decimal("0.10"), Decimal("0.20"), Decimal("0.70")],
                                    pa.decimal128(7, 2))})
    got, want = _both(lambda pkg: table, lambda pkg: [pkg.Sum("d"), pkg.Maximum("d")])
    assert got == want
    assert got[repr(T.Sum("d"))] == ("ok", 1.0)
    assert got[repr(T.Maximum("d"))] == ("ok", 0.7)


DECIMAL_TYPES = {
    "decimal128(7,2)": pa.decimal128(7, 2),
    "decimal128(12,2)": pa.decimal128(12, 2),
    "decimal128(38,10)": pa.decimal128(38, 10),
    "decimal256(20,4)": pa.decimal256(20, 4),
}


def _decimal_analyzers(pkg, c="d"):
    return [
        pkg.Size(), pkg.Completeness(c), pkg.Sum(c), pkg.Mean(c), pkg.Minimum(c),
        pkg.Maximum(c), pkg.StandardDeviation(c), pkg.ApproxCountDistinct(c),
        pkg.ApproxQuantile(c, 0.5), pkg.DataType(c), pkg.CountDistinct([c]),
        pkg.Uniqueness([c]), pkg.Distinctness([c]), pkg.Entropy(c), pkg.Histogram(c),
        pkg.Mean("x", where=f"{c} > 0"),
    ]


@pytest.mark.parametrize("name", sorted(DECIMAL_TYPES))
def test_decimal_column_answers_every_analyzer_as_the_reference(name):
    """Numeric, grouping, sketch and DataType analyzers on a decimal
    column (FRACTIONAL, float64 values, cast as the reference casts
    them), with nulls, negatives and repeated values; the Histogram's
    labels are the decimals as the reference prints them."""
    typ = DECIMAL_TYPES[name]
    rng = np.random.default_rng(11)
    n = 3000
    units = rng.integers(-99_999, 99_999, n)
    units[:40] = units[40:80]  # repeated values
    nulls = rng.random(n) < 0.07
    table = pa.table({"d": _decimal_array(units, typ.scale, typ, nulls),
                      "x": pa.array(rng.random(n))})
    got, want = _both(lambda pkg: table, _decimal_analyzers)
    _assert_same(got, want)
    assert all(v[0] == "ok" for v in got.values())
    assert T.Dataset.from_arrow(table).schema.kind_of("d") == Kind.FRACTIONAL


def test_decimal_beyond_int64_units_casts_as_the_reference():
    """Units past int64 (and past 2^53) take the exact per-value cast."""
    values = [Decimal("12345678901234567890.5"), Decimal("-0.000000001"), None,
              Decimal("99999999999999999999999999.99"), Decimal("0.1")]
    table = pa.table({"d": pa.array(values, pa.decimal128(38, 10)),
                      "x": pa.array([1.0, 2.0, 3.0, 4.0, 5.0])})
    analyzers = lambda pkg: [pkg.Sum("d"), pkg.Minimum("d"), pkg.Maximum("d"),  # noqa: E731
                             pkg.Completeness("d"), pkg.ApproxCountDistinct("d")]
    got, want = _both(lambda pkg: table, analyzers)
    assert got == want


UNKNOWN_ARRAYS = {
    "binary": lambda: pa.array([b"a", None, b"bc", b"a", b"zz", b"q"], pa.binary()),
    "large_binary": lambda: pa.array([b"a", None, b"bc", b"a", b"zz", b"q"], pa.large_binary()),
    "string_view": lambda: pa.array(["a", None, "bc", "a", "zz", "12"], pa.string_view()),
    "list": lambda: pa.array([[1], None, [2, 3], [1], [], [4]], pa.list_(pa.int64())),
    "struct": lambda: pa.array([{"a": 1}, None, {"a": 2}, {"a": 1}, {"a": 3}, {"a": 4}],
                               pa.struct([("a", pa.int64())])),
    "time32": lambda: pa.array([1, None, 2, 1, 5, 6], pa.time32("s")),
    "time64": lambda: pa.array([1, None, 2, 1, 5, 6], pa.time64("us")),
    "duration": lambda: pa.array([1, None, 2, 1, 5, 6], pa.duration("ms")),
}


def _unknown_table(name):
    return pa.table({"u": UNKNOWN_ARRAYS[name](), "x": pa.array([1.0, 2.0, 3.0, 4.0, 5.0, 6.0])})


@pytest.mark.parametrize("name", sorted(UNKNOWN_ARRAYS))
def test_unknown_kind_column_builds_and_fails_typed_analyzers_as_the_reference(name):
    """The table builds with the column as Kind.UNKNOWN; Size and
    Completeness (each run alone: the reference's own caveat) and the
    other column's metrics equal the reference's; the numeric, string
    and grouping analyzers fail with the reference's exception and
    message."""
    table = _unknown_table(name)
    assert T.Dataset.from_arrow(table).schema.kind_of("u") == Kind.UNKNOWN
    for alone in (lambda pkg: [pkg.Size()], lambda pkg: [pkg.Completeness("u")],
                  lambda pkg: [pkg.Mean("x"), pkg.Completeness("x")]):
        got, want = _both(lambda pkg: table, alone)
        assert got == want
    typed = lambda pkg: [  # noqa: E731
        pkg.Mean("u"), pkg.Minimum("u"), pkg.Sum("u"), pkg.MinLength("u"), pkg.MaxLength("u"),
        pkg.PatternMatch("u", "a"), pkg.CountDistinct(["u"]), pkg.Uniqueness(["u"]),
        pkg.Distinctness(["u"]), pkg.Entropy("u"),
    ]
    got, want = _both(lambda pkg: table, typed)
    assert got == want
    assert all(v[:2] == ("fail", "WrongColumnTypeException") for v in got.values())


@pytest.mark.parametrize("name", sorted(UNKNOWN_ARRAYS))
def test_unknown_kind_column_histogram_as_the_reference(name):
    """Histogram labels are the values as the reference prints them; on
    list and struct columns both packages fail (the reference cannot
    dictionary-encode them, the port builds no dictionary for them)."""
    table = _unknown_table(name)
    got, want = _both(lambda pkg: table, lambda pkg: [pkg.Histogram("u")])
    key = repr(T.Histogram("u"))
    if name in ("list", "struct"):
        assert got[key][0] == want[key][0] == "fail"
    else:
        assert got == want


@pytest.mark.parametrize("name", sorted(UNKNOWN_ARRAYS))
def test_datatype_of_unknown_column_counts_values_as_string_as_the_reference_does(name):
    """Pinned: both packages count every non-null value of an UNKNOWN
    column as String (the reference's caveat calls this wrong for
    time32; the port keeps the reference's bucket on purpose)."""
    table = _unknown_table(name)
    got, want = _both(lambda pkg: table, lambda pkg: [pkg.DataType("u")])
    assert got == want
    assert got[repr(T.DataType("u"))][1]["String"] == 5


def test_approx_count_distinct_of_unknown_columns_diverges_from_the_reference():
    """Pinned divergence. The reference's ApproxCountDistinct of an
    UNKNOWN column is 0.0 for every type but duration (a wrong answer:
    each column holds four distinct values). The port counts them:
    binary and string-view values through their dictionary's hashes,
    time and duration values through their storage as float64 (duration
    equals the reference). On list and struct columns the port fails
    the analyzer, without touching the table's other metrics. (Beside
    it, the reference's other metrics of the pass fail too, so the
    reference runs it alone.)"""
    for name in sorted(UNKNOWN_ARRAYS):
        table = _unknown_table(name)
        want = _values(R, table, [R.ApproxCountDistinct("u")])
        with tconfig.configure(device="cpu"):
            got = _values(T, table, [T.ApproxCountDistinct("u"), T.Mean("x")])
        key = repr(T.ApproxCountDistinct("u"))
        assert got[repr(T.Mean("x"))] == ("ok", 3.5)
        if name == "duration":
            assert got[key] == want[key] == ("ok", 4.000462954273216)
        elif name in ("list", "struct"):
            assert want[key] == ("ok", 0.0) and got[key][0] == "fail", name
        else:
            assert want[key] == ("ok", 0.0), name
            assert got[key][0] == "ok" and abs(got[key][1] - 4.0) < 0.01, (name, got[key])


@pytest.mark.parametrize("index_type", ["uint8", "uint16", "uint32", "uint64"])
def test_dictionary_with_unsigned_indices(index_type):
    """Unsigned indices are cast to int32 before the null fill. The
    reference answers Completeness and fails the other analyzers through
    its own fill of -1 in the unsigned type (its caveat), so those are
    held to the reference on the same column with int32 indices."""
    values = ["a", "bb", None, "a", "ccc", "bb"]
    base = pa.array(values).dictionary_encode()
    indices = pa.array([0, 1, None, 0, 2, 1], getattr(pa, index_type)())
    unsigned = pa.DictionaryArray.from_arrays(indices, base.dictionary)
    signed = pa.DictionaryArray.from_arrays(pa.array([0, 1, None, 0, 2, 1], pa.int32()),
                                            base.dictionary)
    analyzers = lambda pkg: [pkg.Completeness("s"), pkg.MaxLength("s"),  # noqa: E731
                             pkg.ApproxCountDistinct("s"), pkg.Histogram("s"),
                             pkg.PatternMatch("s", "b"), pkg.CountDistinct(["s"])]
    got, _ = _both(lambda pkg: pa.table({"s": unsigned}), analyzers)
    _, want_signed = _both(lambda pkg: pa.table({"s": signed}), analyzers)
    _, want = _both(lambda pkg: pa.table({"s": unsigned}), lambda pkg: [pkg.Completeness("s")])
    assert got[repr(T.Completeness("s"))] == want[repr(T.Completeness("s"))]
    assert math.isclose(got[repr(T.Completeness("s"))][1], 5 / 6)
    assert got == want_signed


PYDICT_CASES = {
    "datetime": [datetime(2024, 1, 2, 3, 4, 5, 678901), None, datetime(1969, 12, 31, 23, 59, 59),
                 datetime(2024, 1, 2, 3, 4, 5, 678901)],
    "datetime-utc": [datetime(2024, 1, 2, 3, 4, 5, tzinfo=timezone.utc), None,
                     datetime(2020, 5, 6, tzinfo=timezone.utc),
                     datetime(2024, 1, 2, 3, 4, 5, tzinfo=timezone.utc)],
    "date": [date(2024, 1, 2), None, date(1960, 3, 4), date(2024, 1, 2)],
    "Decimal": [Decimal("0.10"), None, Decimal("1.5"), Decimal("-2.25")],
    "bytes": [b"a", None, b"bc", b"a"],
}


@pytest.mark.parametrize("name", sorted(PYDICT_CASES))
def test_from_pydict_maps_python_types_as_arrow_does(name):
    data = {"v": PYDICT_CASES[name], "x": [1.0, 2.0, 3.0, 4.0]}
    tds, rds = T.Dataset.from_pydict(data), R.Dataset.from_pydict(data)
    assert tds.schema.kind_of("v").value == rds.schema.kind_of("v").value
    for analyzers in (lambda pkg: [pkg.Completeness("v")],
                      lambda pkg: [pkg.Size(), pkg.Histogram("v"), pkg.DataType("v"),
                                   pkg.Minimum("v"), pkg.Maximum("v"), pkg.Sum("v"),
                                   pkg.CountDistinct(["v"]), pkg.Mean("x")]):
        got, want = _both(lambda pkg: pkg.Dataset.from_pydict(data), analyzers)
        _assert_same(got, want)
    if name != "bytes":
        got, want = _both(lambda pkg: pkg.Dataset.from_pydict(data),
                          lambda pkg: [pkg.ApproxCountDistinct("v")])
        assert got == want


def test_a_table_with_every_new_type_keeps_its_other_metrics():
    """One table of a decimal, every UNKNOWN type and a plain float
    column builds, and the float column's metrics equal the reference's."""
    columns = {name: make() for name, make in UNKNOWN_ARRAYS.items()}
    columns["d"] = pa.array([Decimal("1.25")] * 6, pa.decimal128(7, 2))
    columns["x"] = pa.array([1.0, 2.0, 3.0, 4.0, 5.0, 6.0])
    table = pa.table(columns)
    analyzers = lambda pkg: [pkg.Size(), pkg.Mean("x"), pkg.Maximum("x"),  # noqa: E731
                             pkg.ApproxCountDistinct("x"), pkg.Sum("d")]
    got, want = _both(lambda pkg: table, analyzers)
    assert got == want


def test_min_max_length_alone_on_an_arrow_dictionary_column_diverge():
    """Pinned reference caveat: MinLength or MaxLength ALONE on an Arrow
    dictionary-typed string column fails in the reference with
    EmptyStateException; beside another analyzer of the column it
    answers. The port answers both ways, with the reference's values."""
    table = pa.table({"s": pa.array(["ab", "abc", None, "a"]).dictionary_encode()})
    for name, value in (("MinLength", 1.0), ("MaxLength", 3.0)):
        alone = lambda pkg: [getattr(pkg, name)("s")]  # noqa: E731
        got, want = _both(lambda pkg: table, alone)
        key = repr(getattr(T, name)("s"))
        assert want[key][:2] == ("fail", "EmptyStateException")
        assert got[key] == ("ok", value)
        beside = lambda pkg: [getattr(pkg, name)("s"),  # noqa: E731
                              pkg.Compliance("long", "length(s) > 1")]
        got, want = _both(lambda pkg: table, beside)
        assert got == want and got[key] == ("ok", value)
