"""The port's SQL predicate compiler against the JAX package's.

- Parsing: every expression parses to the same AST (compared by repr,
  the node classes have the same names and fields) or raises
  ``PredicateParseError`` with the same message.
- Planning: compiling against the same dataset either succeeds in both
  packages, with the same column requests, or fails in both with the
  same error type and message.
- Evaluation: ``complies(batch)`` on one mixed batch (float with NaN and
  nulls, int64, int32, float32, bool, two string columns, a timestamp
  and a date column) is equal to the reference's, row for row, exactly:
  the same numpy arrays go into both as device tensors.
- Through the runner: Compliance metrics equal the reference's exactly.

The expressions reuse the cases of ``tests/test_predicate.py`` (numeric
and string comparisons, three-valued logic, IN with NULL, LIKE, CASE,
COALESCE, string functions, CONCAT, CAST, date literals and date
arithmetic) written over this file's columns.
"""

import datetime

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deequ_tpu as R
from deequ_tpu.sql import predicate as rpred

import deequ_tpu_torch as T
from deequ_tpu_torch.data.table import ROW_MASK
from deequ_tpu_torch.sql import predicate as tpred

N = 400

EXPRESSIONS = [
    # comparisons and arithmetic
    "x >= 0.5", "x < y", "x + y = 3", "x * 2 > y", "i > 0", "i % 7 = 3",
    "i / 3 > 10", "q / 4 >= 12", "q / i > 0", "f > 0.1", "f * 3 <= x",
    "x / (x - x) > 0", "x / y >= 0", "q % 0 = 1", "-x > 0.25", "ABS(x) < 1",
    "i + q > 50", "f = x", "b = 1", "b", "NOT b", "b AND x > 0",
    # three-valued logic
    "x > 0 AND s = 'a'", "x > 0 OR s = 'a'", "x > 99 AND s = 'zz'",
    "NOT (x = 0)", "x IS NULL", "x IS NOT NULL OR q IS NULL",
    "x BETWEEN -1 AND 1", "q BETWEEN 10 AND 60",
    "q IN (1, 2, 3, 50)", "q NOT IN (1, 2, 3)", "q IN (1, NULL)",
    "q NOT IN (1, NULL)", "x IN (NULL)",
    # strings
    "s = 'a'", "s != 'bb'", "s = 'missing'", "s > 'a'", "'b' <= s",
    "s IN ('a', ' Cc ')", "s NOT IN ('a')", "s IS NULL OR s IN ('a', 'bb')",
    "s LIKE 'b%'", "s NOT LIKE '%c%'", "s RLIKE '^ ?C'", "s = t", "s < t",
    "s >= t", "LENGTH(s) >= 2", "LENGTH(s) = 0", "TRIM(s) = 'Cc'",
    "UPPER(s) = 'BB'", "LOWER(TRIM(s)) IN ('cc', 'a')", "SUBSTR(s, 1, 1) = 'b'",
    "SUBSTRING(TRIM(s), -1) = 'c'", "LENGTH(TRIM(s)) = 2", "UPPER(s) LIKE 'C%'",
    "LOWER(TRIM(s)) < 'b'",
    # CASE / COALESCE / CONCAT / CAST
    "CASE WHEN x > 1 THEN 1 ELSE 0 END = 1",
    "CASE WHEN x >= 1 THEN 10 WHEN x >= 0 THEN 5 ELSE 0 END >= 5",
    "CASE WHEN x > 1 THEN 1 END = 1",
    "CASE WHEN x > 0 THEN s ELSE 'neg' END = 'neg'",
    "CASE WHEN q > 50 THEN t ELSE s END > 'b'",
    "COALESCE(x, y, 0) >= 0.5", "COALESCE(s, t) = 'u'", "COALESCE(s, 'z') = 'z'",
    "CONCAT('<', TRIM(s), '>') = '<Cc>'", "CONCAT(s, '-', t) = 'a-u'",
    "LENGTH(CONCAT(s, t)) > 3", "CAST(x AS INT) = 0", "CAST(y / 3 AS INT) = 1",
    "CAST(n AS DOUBLE) >= 1.5", "CAST(n AS INT) = 1", "CAST(n AS DOUBLE) IS NULL",
    "CAST(b AS STRING) = 'true'", "CAST(s AS STRING) = 'a'",
    # timestamps and dates
    "ts >= '2024-06-01'", "ts = '2024-06-15 12:30:00'", "'2024-12-31' < ts",
    "d >= '2024-06-01'", "ts BETWEEN '2024-01-01' AND '2024-12-31'",
    "ts < '1970-01-01'", "DATE_ADD(ts, 1) = '2024-01-02'",
    "DATE_SUB(d, 31) < '2024-05-20'", "DATEDIFF(ts, '2024-01-01') > 100",
    "DATEDIFF(ts, d) = 0", "d < ts", "CAST(ts AS BIGINT) > 1700000000",
    "CAST(ts AS DOUBLE) < 0",
]

MALFORMED = [
    "x >>> 1", "AND x", "x >", "s = 1", "s < x", "s + 1 > 0",
    "TRIM(x) = 'a'", "CASE WHEN x > 0 THEN s ELSE 1 END = 1",
    "COALESCE(s, 1) = 1", "SUBSTR(s, x) = 'a'", "SUBSTR(s) = 'a'",
    "TRIM(s, s) = 'a'", "CASE WHEN s THEN 1 ELSE 0 END = 1",
    "DATE_ADD(s, 1) = 'yx'", "ts >= 'not-a-date'", "nope > 1",
    "SUM(x) > 1", "CAST(d AS INT) > 1", "CAST(x AS STRING) = '1'",
    "'a' = 'b'", "CONCAT('a', 'b') = 'ab'", "x = 'a' 'b'", "(x > 1",
    "x IN ('a')", "s IN (1)", "s LIKE 1", "x LIKE 'a'", "DATEDIFF('2024-01-01', '2024-01-02') > 0",
]


def _data(n=N, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n) * 2
    x[:4] = [np.nan, 0.0, -0.0, 1.0]
    stamps = np.array(
        ["2024-01-01T00:00:00", "2024-06-15T12:30:00", "2025-01-01T00:00:00",
         "1969-12-31T23:59:59.500001", "2024-01-01T23:59:59"],
        dtype="datetime64[us]",
    )
    ts = stamps[rng.integers(0, len(stamps), n)]
    ts[rng.random(n) < 0.1] = np.datetime64("NaT")
    d = ts.astype("datetime64[D]")
    d[rng.random(n) < 0.1] = np.datetime64("NaT")
    pick = lambda values: list(np.array(values, dtype=object)[rng.integers(0, len(values), n)])  # noqa: E731
    return {
        "x": np.ma.array(x, mask=rng.random(n) < 0.15),
        "y": np.ma.array(rng.standard_normal(n) + 1, mask=rng.random(n) < 0.15),
        "i": rng.integers(-1000, 1000, n),
        "q": np.ma.array(rng.integers(0, 101, n).astype(np.int32), mask=rng.random(n) < 0.1),
        "f": np.ma.array(rng.standard_normal(n).astype(np.float32), mask=rng.random(n) < 0.1),
        "b": rng.random(n) < 0.4,
        "s": pick(["a", "bb", None, " Cc ", "", "b"]),
        "t": pick(["u", "a", "bb", None, "zz"]),
        "n": pick(["1.5", "2", "x", None, " 3 ", "NaN", "1_0", "Infinity"]),
        "ts": ts,
        "d": d,
    }


@pytest.fixture(scope="module")
def datasets():
    data = _data()
    return R.Dataset.from_pydict(data), T.Dataset.from_pydict(data)


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as exc:  # noqa: BLE001 — the outcome is compared
        return (type(exc).__name__, str(exc))


@pytest.mark.parametrize("expr", EXPRESSIONS + MALFORMED)
def test_parse_parity(expr):
    ref = _outcome(lambda: repr(rpred.parse_predicate(expr)))
    port = _outcome(lambda: repr(tpred.parse_predicate(expr)))
    assert port == ref


def _batch(tds, compiled):
    """One batch holding every column the predicate reads, as torch
    tensors, and the same arrays for the reference as jax arrays."""
    batch = {ROW_MASK: torch.ones(tds.num_rows, dtype=torch.bool)}
    for req in compiled.requests:
        batch[req.key] = tds.device_column(req, torch.device("cpu"))
    return batch, {k: jnp.asarray(v.numpy()) for k, v in batch.items()}


@pytest.mark.parametrize("expr", EXPRESSIONS + MALFORMED)
def test_plan_and_complies_parity(expr, datasets):
    rds, tds = datasets
    ref = _outcome(lambda: rpred.compile_predicate(expr, rds))
    port = _outcome(lambda: tpred.compile_predicate(expr, tds))
    assert port[0] == ref[0]
    if ref[0] != "ok":
        assert port[1] == ref[1]
        return
    rc, tc = ref[1], port[1]
    assert [r.key for r in tc.requests] == [r.key for r in rc.requests]
    tbatch, rbatch = _batch(tds, tc)
    got = tc.complies(tbatch)
    want = np.asarray(rc.complies(rbatch))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(
        np.broadcast_to(got.numpy(), (tds.num_rows,)),
        np.broadcast_to(want, (tds.num_rows,)),
    )


def test_dictionaries_and_units_agree(datasets):
    rds, tds = datasets
    for col in ("s", "t", "n"):
        assert list(tds.dictionary(col)) == list(rds.dictionary(col))
    assert tds.timestamp_unit("ts") == "us" and tds.timestamp_unit("d") == "date32"


def test_compliance_through_the_runner_matches(datasets):
    """Compliance and where-filtered analyzers on both packages over two
    batches; every metric equal exactly (counts over counts), and the
    malformed predicates fail alike without touching the others."""
    rds, tds = datasets
    exprs = EXPRESSIONS[::3] + MALFORMED[:6]

    def analyzers(pkg):
        out = [pkg.Compliance(f"c{k}", e) for k, e in enumerate(exprs)]
        out += [pkg.Size(where="s = 'a'"), pkg.Completeness("x", where="q > 50")]
        return out

    from deequ_tpu import config as rconfig
    from deequ_tpu_torch import config as tconfig

    with rconfig.configure(batch_size=256):
        ref = R.AnalysisRunner.do_analysis_run(rds, analyzers(R))
    with tconfig.configure(device="cpu", batch_size=256):
        port = T.AnalysisRunner.do_analysis_run(tds, analyzers(T))
    for ra, ta in zip(analyzers(R), analyzers(T)):
        rm, tm = ref.metric(ra), port.metric(ta)
        assert tm.value.is_success == rm.value.is_success, ra
        if rm.value.is_success:
            assert tm.value.get() == rm.value.get(), ra
        else:
            assert type(tm.value.exception).__name__ == type(rm.value.exception).__name__


@pytest.mark.parametrize(
    "literal, unit, want",
    [
        ("1969-12-31 23:59:59.500001", "s", -1),
        ("1969-12-31 23:59:59.500001", "ms", -500),
        ("1969-12-31 23:59:59.500001", "us", -499999),
        ("2020-01-01 00:00:00.999999", "ns", 1577836800999999000),
        ("2020-01-01T10:00:00+02:00", "us", 1577865600000000),
        ("1960-01-01", "date64", -315619200000),
        ("2024-06-15 12:30:00", "date32", 19889),
    ],
)
def test_date_literal_epochs_match_arrow(literal, unit, want):
    """The port converts date literals without pyarrow; the values are
    those of Arrow's cast into the column's type (floor to the unit,
    offsets to UTC), as the JAX package computes them."""
    import pyarrow as pa

    class _Units:
        def timestamp_unit(self, column):
            return unit

    if unit.startswith("date"):
        typ = pa.date32() if unit == "date32" else pa.date64()
        value = datetime.datetime.fromisoformat(literal).date()
    else:
        typ, value = pa.timestamp(unit), datetime.datetime.fromisoformat(literal)
    arr = pa.array([value], type=typ)
    if unit == "date32":
        arr = arr.cast(pa.int32())
    assert arr.cast(pa.int64())[0].as_py() == want
    assert tpred._date_literal_epoch(_Units(), "c", literal) == want
