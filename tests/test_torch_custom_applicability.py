"""CustomSql and Applicability of deequ_tpu_torch against the JAX package.

CustomSql: the same columns through both packages at one batch size;
each metric's success equal (a failure: its exception type and
message), its value exactly when the expression sums nothing, else
within 1e-12 relative (1e-5 over the float32 column ``f``: both sum a
batch in their own order), with and without ``where=``, alone and beside other analyzers,
which it shares one data pass with. A ``CustomSqlState`` persisted by
either package loads through ``interop.py`` and merges in the other to
the whole table's metric. One divergence is held apart: the JAX package
requests a string column's ``values`` for ``COUNT(s)``, which it does
not have, and its whole pass then reads zero rows; the port counts the
column's non-null rows and leaves the pass alone.

Applicability: the cases of ``tests/test_custom_applicability.py`` and
more (a bad filter, a string analyzer on a number, every column kind)
give the same verdict and the same per-item failures in both.
"""

import numpy as np
import pytest
import torch

import deequ_tpu as R
from deequ_tpu import config as rconfig
from deequ_tpu.io.state_provider import FileSystemStateProvider, InMemoryStateProvider

import deequ_tpu_torch as T
from deequ_tpu_torch import config as tconfig
from deequ_tpu_torch.analyzers.custom import CustomSqlState
from deequ_tpu_torch.interop import states_from_numpy, states_to_numpy

BATCH = 64


def table(n=300, seed=11):
    rng = np.random.default_rng(seed)
    return {
        "a": np.ma.array(rng.normal(5, 3, n), mask=rng.random(n) < 0.1),
        "b": np.ma.array(rng.integers(-50, 50, n), mask=rng.random(n) < 0.05),
        "f": rng.random(n).astype(np.float32),
        "z": np.where(rng.random(n) < 0.5, -0.0, 0.0),
        "s": [["x", "y", "z"][i % 3] for i in range(n)],
        "flag": rng.random(n) < 0.3,
    }


EXPRESSIONS = [
    "SUM(a)", "COUNT(*)", "COUNT(a)", "COUNT(b)", "AVG(a)", "MIN(a)", "MAX(a)",
    "SUM(b) / COUNT(*)", "AVG(a) * 2 + MIN(a) - 1", "SUM(a) / SUM(b)", "-SUM(b) % 7",
    "MAX(f) - MIN(f)", "SUM(f)", "MIN(z)", "MAX(z)", "SUM(flag) / COUNT(*)",
    "(SUM(a) + 1) * (COUNT(b) - 3)",
    # failures: an unknown column, a bare column, a string sum, no aggregate,
    # division by zero, an unparseable expression, AVG over no rows
    "SUM(nope)", "a + 1", "SUM(s)", "1 + 2", "SUM(a) / (SUM(a) - SUM(a))", "SUM(a) +",
    "AVG(a) + COUNT(*)",
]
WHERES = [None, "b > 0", "s = 'x'", "a > 1000"]


def _run(analyzers_r, analyzers_t, data, rkeep=None, tkeep=None, engine=None):
    with rconfig.configure(batch_size=BATCH):
        ref = R.AnalysisRunner.do_analysis_run(
            R.Dataset.from_pydict(data), analyzers_r, save_states_with=rkeep)
    with tconfig.configure(device="cpu", batch_size=BATCH):
        port = T.AnalysisRunner.do_analysis_run(
            T.Dataset.from_pydict(data), analyzers_t, save_states_with=tkeep, engine=engine)
    return ref, port


def _rtol(key):
    if "SUM(" not in key and "AVG(" not in key and "Mean" not in key:
        return 0.0
    return 1e-5 if "(f)" in key else 1e-12


def assert_metric_equal(rm, tm, key):
    assert tm.value.is_success == rm.value.is_success, (key, rm.value, tm.value)
    if rm.value.is_success:
        want, got = rm.value.get(), tm.value.get()
        if _rtol(key) == 0.0:
            assert np.float64(got).view(np.uint64) == np.float64(want).view(np.uint64), (key, got, want)
        else:
            assert got == pytest.approx(want, rel=_rtol(key)), key
    else:
        assert type(tm.value.exception).__name__ == type(rm.value.exception).__name__, key
        assert str(tm.value.exception) == str(rm.value.exception), key


@pytest.mark.parametrize("where", WHERES)
@pytest.mark.parametrize("expression", EXPRESSIONS)
def test_custom_sql_matches_reference(expression, where):
    ref, port = _run([R.CustomSql(expression, where)], [T.CustomSql(expression, where)], table())
    assert_metric_equal(
        ref.metric(R.CustomSql(expression, where)), port.metric(T.CustomSql(expression, where)),
        expression)


def test_custom_sql_shares_the_fused_scan():
    data = table()

    def make(pkg):
        return [pkg.CustomSql("SUM(a) / COUNT(*)"), pkg.CustomSql("MAX(b)", "s = 'y'"),
                pkg.Mean("a"), pkg.Size(), pkg.Completeness("s"), pkg.Histogram("s")]

    with tconfig.configure(device="cpu"):
        engine = T.AnalysisEngine()
    ref, port = _run(make(R), make(T), data, engine=engine)
    assert engine.data_passes == 1 and engine.device_fetches == 1
    for ra, ta in zip(make(R), make(T)):
        if isinstance(ta, T.Histogram):
            assert port.metric(ta).value.get().values.keys() == ref.metric(ra).value.get().values.keys()
            continue
        assert_metric_equal(ref.metric(ra), port.metric(ta), repr(ta))


def test_count_of_a_string_column_counts_its_rows():
    """The divergence: the port answers COUNT(s) and keeps the pass; the
    JAX package's metrics of the same pass without it are the port's."""
    data = {"a": [1.0, 2.0, None], "s": ["x", None, "y"]}
    others_r, others_t = [R.Size(), R.CustomSql("COUNT(a)")], [T.Size(), T.CustomSql("COUNT(a)")]
    ref, port = _run(others_r, others_t + [T.CustomSql("COUNT(s)")], data)
    assert port.metric(T.CustomSql("COUNT(s)")).value.get() == 2.0
    for ra, ta in zip(others_r, others_t):
        assert_metric_equal(ref.metric(ra), port.metric(ta), repr(ta))


def test_state_merges_in_the_other_package(tmp_path):
    data = table(400, seed=3)
    first = {k: v[:250] for k, v in data.items()}
    second = {k: v[250:] for k, v in data.items()}
    exprs = ["SUM(a) / COUNT(*)", "MIN(a) + MAX(b)", "AVG(f)", "COUNT(b) - SUM(flag)"]

    # the JAX package persists, the port merges
    provider = FileSystemStateProvider(str(tmp_path))
    with rconfig.configure(batch_size=BATCH):
        R.AnalysisRunner.do_analysis_run(
            R.Dataset.from_pydict(first), [R.CustomSql(e) for e in exprs], save_states_with=provider)
        whole = R.AnalysisRunner.do_analysis_run(
            R.Dataset.from_pydict(data), [R.CustomSql(e) for e in exprs])
    carried = InMemoryStateProvider()
    for e in exprs:
        with np.load(tmp_path / provider._key(R.CustomSql(e))) as arrays:
            state = states_from_numpy(str(arrays["__type__"]), arrays, "cpu")
        assert isinstance(state, CustomSqlState)
        carried._states[repr(R.CustomSql(e))] = state
    with tconfig.configure(device="cpu", batch_size=BATCH):
        merged = T.AnalysisRunner.do_analysis_run(
            T.Dataset.from_pydict(second), [T.CustomSql(e) for e in exprs],
            aggregate_with=_ByReferenceRepr(carried))
    for e in exprs:
        got = merged.metric(T.CustomSql(e)).value.get()
        assert got == pytest.approx(whole.metric(R.CustomSql(e)).value.get(), rel=_rtol(e)), e

    # the port persists, the JAX package merges
    keep = InMemoryStateProvider()
    with tconfig.configure(device="cpu", batch_size=BATCH):
        T.AnalysisRunner.do_analysis_run(
            T.Dataset.from_pydict(first), [T.CustomSql(e) for e in exprs], save_states_with=keep)
    out = tmp_path / "port"
    out.mkdir()
    back = FileSystemStateProvider(str(out))
    for e in exprs:
        arrays = states_to_numpy(keep._states[repr(T.CustomSql(e))])
        assert str(arrays["__type__"]) == "CustomSqlState" and int(arrays["__version__"]) == 1
        np.savez(out / back._key(R.CustomSql(e)), **arrays)
    with rconfig.configure(batch_size=BATCH):
        ref_merged = R.AnalysisRunner.do_analysis_run(
            R.Dataset.from_pydict(second), [R.CustomSql(e) for e in exprs], aggregate_with=back)
    for e in exprs:
        got = ref_merged.metric(R.CustomSql(e)).value.get()
        assert got == pytest.approx(whole.metric(R.CustomSql(e)).value.get(), rel=_rtol(e)), e


class _ByReferenceRepr:
    """A loader keyed by the JAX package's analyzer repr."""

    def __init__(self, provider):
        self.provider = provider

    def load(self, analyzer):
        return self.provider._states.get(repr(analyzer).replace("deequ_tpu_torch.", "deequ_tpu."))


def test_state_identity_and_merge_match_reference():
    from deequ_tpu.analyzers.custom import CustomSqlState as RState

    r, t = RState.identity(3), CustomSqlState.identity(3)
    for f in RState._fields:
        np.testing.assert_array_equal(getattr(t, f).numpy(), np.asarray(getattr(r, f)))
        assert getattr(t, f).numpy().dtype == np.asarray(getattr(r, f)).dtype
    a = (np.array([1.0, 2.0]), np.array([3, 4]), np.array([np.nan, 1.0]), np.array([0.0, -np.inf]))
    b = (np.array([0.5, 0.0]), np.array([1, 0]), np.array([2.0, np.nan]), np.array([5.0, np.nan]))
    rm = RState.merge(RState(*a), RState(*b))
    tm = CustomSqlState.merge(*(CustomSqlState(*(torch.as_tensor(x) for x in s)) for s in (a, b)))
    for f in RState._fields:
        np.testing.assert_array_equal(getattr(tm, f).numpy(), np.asarray(getattr(rm, f)))


# -- Applicability


SCHEMA_DATA = {
    "x": [1.0], "s": ["a"], "n": [3], "flag": [True],
    "t": np.array(["2024-01-01"], dtype="datetime64[ms]"),
}


def _checks(pkg):
    good = pkg.Check(pkg.CheckLevel.ERROR, "good").is_complete("x").has_mean("x", lambda m: m > 0)
    bad = pkg.Check(pkg.CheckLevel.ERROR, "bad").has_mean("s", lambda m: m > 0)
    mixed = (
        pkg.Check(pkg.CheckLevel.ERROR, "mixed")
        .has_min_length("s", lambda v: v > 0)
        .has_min_length("x", lambda v: v > 0)
        .has_completeness("missing", lambda v: v > 0)
        .satisfies("x > 0 AND n < 5", "ok")
        .satisfies("x >>> 1", "malformed")
        .has_approx_count_distinct("t", lambda v: v > 0)
        .has_sum("flag", lambda v: v >= 0)
        .is_unique("n")
        .has_pattern("n", r"\d")
        .has_size(lambda v: v == 2)
        .has_mean("x", lambda v: v > 0).where("s = 'v0'")
    )
    return {"good": good, "bad": bad, "mixed": mixed}


def _normalize(failures):
    return {k.replace("deequ_tpu_torch.", "deequ_tpu."): v for k, v in failures.items()}


@pytest.mark.parametrize("name", ["good", "bad", "mixed"])
def test_check_applicability_matches_reference(name):
    rschema = R.Dataset.from_pydict(SCHEMA_DATA).schema
    tschema = T.Dataset.from_pydict(SCHEMA_DATA).schema
    ref = R.Applicability().is_applicable(_checks(R)[name], rschema)
    with tconfig.configure(device="cpu"):
        port = T.Applicability().is_applicable(_checks(T)[name], tschema)
    assert port.is_applicable == ref.is_applicable
    assert list(port.failures.values()) == list(ref.failures.values())
    assert _normalize(port.failures) == _normalize(ref.failures)
    assert port.is_applicable == (name == "good")


def _analyzer_sets(pkg):
    return [
        [pkg.Mean("x"), pkg.Mean("missing")],
        [pkg.Mean("x"), pkg.Completeness("s"), pkg.CustomSql("SUM(x) / COUNT(*)")],
        [pkg.MaxLength("x"), pkg.Mean("s"), pkg.CustomSql("SUM(s)"), pkg.Histogram("t"),
         pkg.DataType("n"), pkg.ApproxQuantile("x", 0.5), pkg.Mean("x", where="nope > 1")],
    ]


@pytest.mark.parametrize("index", range(3))
def test_analyzer_applicability_matches_reference(index):
    rschema = R.Dataset.from_pydict(SCHEMA_DATA).schema
    tschema = T.Dataset.from_pydict(SCHEMA_DATA).schema
    ref = R.Applicability().are_applicable(_analyzer_sets(R)[index], rschema)
    with tconfig.configure(device="cpu"):
        port = T.Applicability().are_applicable(_analyzer_sets(T)[index], tschema)
    assert port.is_applicable == ref.is_applicable
    assert list(port.failures.values()) == list(ref.failures.values())
    assert _normalize(port.failures) == _normalize(ref.failures)
