"""Constraint suggestion of deequ_tpu_torch against the JAX package.

The same seeded columns go through ``ConstraintSuggestionRunner`` of
both packages with ``DEFAULT_RULES``. Held exactly: the suggestions and
their order, every field of each but ``apply_to_check`` (the
``code_for_constraint`` strings included); the rows each package holds
out (row for row, every column); and the holdout ``VerificationResult``:
the status, each check's status, and each constraint's string, status
and message. Constraint metric values agree within 1e-12 relative. The
rules alone are held to the reference's on the boundary profiles of
``tests/test_suggestions.py``, and the flow of
``examples/profiling_and_suggestion.py`` runs through both packages and
is compared apart from its timings. ``Dataset.select`` and
``filter_rows`` give the reference's rows.
"""

import math

import numpy as np
import pyarrow as pa
import pytest

import deequ_tpu as R
from deequ_tpu import config as rconfig
from deequ_tpu.data.table import Kind as RKind
from deequ_tpu.metrics.distribution import Distribution as RDist
from deequ_tpu.metrics.distribution import DistributionValue as RValue
from deequ_tpu.profiles import profiler as rprof
from deequ_tpu.suggestions import rules as rrules
from deequ_tpu.suggestions.runner import ConstraintSuggestionRunner as RRunner

import deequ_tpu_torch as T
from deequ_tpu_torch import config as tconfig
from deequ_tpu_torch.data.table import ColumnRequest
from deequ_tpu_torch.data.table import Kind as TKind
from deequ_tpu_torch.metrics.distribution import Distribution as TDist
from deequ_tpu_torch.metrics.distribution import DistributionValue as TValue
from deequ_tpu_torch.profiles import profiler as tprof
from deequ_tpu_torch.suggestions import rules as trules
from deequ_tpu_torch.suggestions.runner import ConstraintSuggestionRunner as TRunner

from test_torch_profiles import assert_profiles_equal, store_sales_table

BATCH = 512
FIELDS = ("constraint_description", "column_name", "current_value", "description",
          "suggesting_rule", "code_for_constraint")


def runner_table(n=400, seed=7):
    rng = np.random.default_rng(seed)
    return {
        "id": list(range(n)),
        "cat": list(rng.choice(["x", "y", "z"], n)),
        "maybe": [float(i) if i % 4 else None for i in range(n)],
        "skewed": list(rng.choice(["a", "b", "c", "d"], n, p=[0.7, 0.25, 0.03, 0.02])),
        "neg": list(rng.normal(0, 1, n)),
        "num_str": [str(v) for v in rng.integers(0, 5, n)],
    }


def example_table():
    """The columns of examples/profiling_and_suggestion.py."""
    rng = np.random.default_rng(3)
    n = 50_000
    return {
        "order_id": np.arange(n),
        "status": rng.choice(["open", "shipped", "done"], n),
        "amount": np.abs(rng.normal(80.0, 30.0, n)),
        "discount_code": [None if i % 5 else f"D{i % 7}" for i in range(n)],
        "qty_as_string": [str(int(q)) for q in rng.integers(1, 9, n)],
    }


def _datasets(data):
    if isinstance(data, pa.Table):
        return R.Dataset.from_arrow(data), T.Dataset.from_arrow(data)
    return R.Dataset.from_pydict(data), T.Dataset.from_pydict(data)


def _run_both(data, ratio=None, seed=42, batch=BATCH):
    rds, tds = _datasets(data)
    rb = RRunner().on_data(rds).add_constraint_rules(rrules.DEFAULT_RULES)
    tb = TRunner().on_data(tds).add_constraint_rules(trules.DEFAULT_RULES)
    if ratio is not None:
        rb = rb.use_train_test_split_with_testset_ratio(ratio, seed)
        tb = tb.use_train_test_split_with_testset_ratio(ratio, seed)
    with rconfig.configure(batch_size=batch):
        ref = rb.run()
        rsplit = rb._split()
    with tconfig.configure(device="cpu", batch_size=batch):
        port = tb.run()
        tsplit = tb.split()
    return ref, port, rsplit, tsplit


def _port_rows(ds, column):
    mask = ds.materialize(ColumnRequest(column, "mask"))
    if ds.schema.kind_of(column) == TKind.STRING:
        codes, dictionary = ds.materialize(ColumnRequest(column, "codes")), ds.dictionary(column)
        return [dictionary[k] if k >= 0 else None for k in codes]
    values = ds.materialize(ColumnRequest(column, "values"))
    return [v.item() if m else None for v, m in zip(values, mask)]


def assert_same_rows(rds, tds):
    assert tds.num_rows == rds.num_rows
    assert tds.schema.column_names == rds.table.schema.names
    for c in rds.table.schema.names:
        assert _port_rows(tds, c) == rds.table.column(c).to_pylist(), c


def assert_suggestions_equal(ref, port):
    assert list(port.constraint_suggestions) == list(ref.constraint_suggestions)
    got = [[getattr(s, f) for f in FIELDS] for s in port.all_suggestions()]
    want = [[getattr(s, f) for f in FIELDS] for s in ref.all_suggestions()]
    assert got == want


def assert_verification_equal(rv, tv):
    if rv is None:
        assert tv is None
        return
    assert tv.status.value == rv.status.value
    for (rc, rres), (tc, tres) in zip(rv.check_results.items(), tv.check_results.items()):
        assert (tc.description, tres.status.value) == (rc.description, rres.status.value)
        assert len(tres.constraint_results) == len(rres.constraint_results)
        for rcr, tcr in zip(rres.constraint_results, tres.constraint_results):
            key = str(rcr.constraint)
            assert str(tcr.constraint) == key
            assert (tcr.status.value, tcr.message) == (rcr.status.value, rcr.message), key
            rval, tval = rcr.metric.value, tcr.metric.value
            assert tval.is_success == rval.is_success, key
            if rval.is_success and isinstance(rval.get(), float):
                assert math.isclose(tval.get(), rval.get(), rel_tol=1e-12), key


@pytest.mark.parametrize("ratio", [None, 0.2, 0.25])
def test_runner_matches_reference(ratio):
    ref, port, rsplit, tsplit = _run_both(runner_table(), ratio)
    assert_profiles_equal(ref.column_profiles, port.column_profiles)
    assert_suggestions_equal(ref, port)
    assert_verification_equal(ref.verification_result, port.verification_result)
    if ratio is None:
        assert tsplit[1] is None and rsplit[1] is None
    else:
        assert port.verification_result is not None
        assert port.verification_result.status.value in ("Success", "Warning")
    by_rule = {s.suggesting_rule for s in port.all_suggestions()}
    assert {"CompleteIfCompleteRule", "UniqueIfApproximatelyUniqueRule", "CategoricalRangeRule",
            "RetainCompletenessRule", "NonNegativeNumbersRule", "RetainTypeRule",
            "FractionalCategoricalRangeRule"} <= by_rule


@pytest.mark.parametrize("seed", [42, 0, 9])
def test_held_out_rows_match_reference(seed):
    _, _, (rtrain, rtest), (ttrain, ttest) = _run_both(runner_table(), 0.2, seed)
    assert_same_rows(rtrain, ttrain)
    assert_same_rows(rtest, ttest)


def test_store_sales_shaped_holdout_matches_reference():
    ref, port, (rtrain, rtest), (ttrain, ttest) = _run_both(store_sales_table(), 0.2)
    assert_profiles_equal(ref.column_profiles, port.column_profiles,
                          float32_columns={"ss_wholesale_cost"})
    assert_suggestions_equal(ref, port)
    assert port.verification_result is not None
    assert_verification_equal(ref.verification_result, port.verification_result)
    assert_same_rows(rtest, ttest)
    # the held-out dictionary column keeps its whole dictionary, as the
    # reference keeps the Arrow dictionary
    assert list(ttest.dictionary("i_category")) == ["Books", "Home", "Music", "Shoes"]


def test_example_flow_matches_reference():
    """examples/profiling_and_suggestion.py through both packages: the
    profiles (but their timings), the suggestions and the holdout."""
    data = example_table()
    rds, tds = _datasets(data)
    rprofiles = R.ColumnProfilerRunner().on_data(rds).run()
    with tconfig.configure(device="cpu"):
        tprofiles = T.ColumnProfilerRunner().on_data(tds).run()
    assert_profiles_equal(rprofiles, tprofiles)
    ref, port, _, _ = _run_both(data, 0.2, batch=None)
    assert_suggestions_equal(ref, port)
    assert_verification_equal(ref.verification_result, port.verification_result)
    assert [s.code_for_constraint for s in port.all_suggestions()]


def test_rule_exception_does_not_kill_run():
    class ExplodingRule(trules.CompleteIfCompleteRule):
        def should_be_applied(self, profile, num_records):
            raise RuntimeError("boom")

    with tconfig.configure(device="cpu"):
        result = (
            TRunner().on_data(T.Dataset.from_pydict(runner_table()))
            .add_constraint_rule(ExplodingRule())
            .add_constraint_rule(trules.CompleteIfCompleteRule()).run()
        )
    assert {s.suggesting_rule for s in result.all_suggestions()} == {"CompleteIfCompleteRule"}


def test_split_ratio_is_checked():
    for ratio in (0.0, 1.0):
        with pytest.raises(ValueError):
            TRunner().on_data(T.Dataset.from_pydict({"x": [1]})).use_train_test_split_with_testset_ratio(ratio)


# -- the rules alone, on the boundary profiles of tests/test_suggestions.py


def _profiles(pkg_prof, kind, dist, value, numeric, **kwargs):
    base = dict(column="col", completeness=1.0, approximate_num_distinct_values=10.0,
                data_type=kind.STRING, is_data_type_inferred=False, type_counts={},
                histogram=None)
    if numeric:
        base.update(data_type=kind.FRACTIONAL, mean=1.0, maximum=5.0, minimum=0.0, sum=10.0,
                    std_dev=1.0)
    for k, v in kwargs.items():
        if k == "data_type":
            v = getattr(kind, v)
        elif k == "histogram":
            total = sum(v.values())
            v = dist({c: value(n, n / total) for c, n in v.items()}, len(v))
        base[k] = v
    cls = pkg_prof.NumericColumnProfile if numeric else pkg_prof.StandardColumnProfile
    return cls(**base)


CASES = [
    (False, {"completeness": 1.0}, 100),
    (False, {"completeness": 0.99}, 100),
    (False, {"completeness": 0.5}, 100),
    (False, {"completeness": 0.2}, 100),
    (False, {"completeness": 0.19}, 100),
    (False, {"is_data_type_inferred": True, "data_type": "INTEGRAL"}, 10),
    (False, {"is_data_type_inferred": True, "data_type": "FRACTIONAL"}, 10),
    (False, {"is_data_type_inferred": True, "data_type": "BOOLEAN"}, 10),
    (False, {"is_data_type_inferred": True, "data_type": "STRING"}, 10),
    (False, {"histogram": {"a": 60, "b": 40}, "approximate_num_distinct_values": 2.0}, 1000),
    (False, {"histogram": {"a": 1, "b": 1}, "approximate_num_distinct_values": 500.0}, 1000),
    (False, {"histogram": {"a": 600, "b": 380, "junk": 20}}, 1000),
    (False, {"histogram": {"a": 50, "b": 50}}, 100),
    (False, {"histogram": {"b": 45, "a": 45, "NullValue": 10}}, 100),
    (True, {"minimum": 0.0}, 10),
    (True, {"minimum": -0.1}, 10),
    (False, {"approximate_num_distinct_values": 95.0}, 100),
    (False, {"approximate_num_distinct_values": 80.0}, 100),
    (False, {"approximate_num_distinct_values": 100.0, "completeness": 0.9}, 100),
    (False, {}, 0),
]


@pytest.mark.parametrize("numeric, overrides, num_records", CASES)
def test_rules_match_reference_on_boundary_profiles(numeric, overrides, num_records):
    rp = _profiles(rprof, RKind, RDist, RValue, numeric, **overrides)
    tp = _profiles(tprof, TKind, TDist, TValue, numeric, **overrides)
    assert [type(r).__name__ for r in trules.DEFAULT_RULES] == [
        type(r).__name__ for r in rrules.DEFAULT_RULES]
    for rr, tr in zip(rrules.DEFAULT_RULES, trules.DEFAULT_RULES):
        fires = rr.should_be_applied(rp, num_records)
        assert tr.should_be_applied(tp, num_records) == fires, type(rr).__name__
        if fires:
            rs, ts = rr.candidate(rp, num_records), tr.candidate(tp, num_records)
            assert [getattr(ts, f) for f in FIELDS] == [getattr(rs, f) for f in FIELDS]


@pytest.mark.parametrize("columns", [["cat"], ["num_str", "id"], ["maybe", "cat", "skewed"]])
def test_select_matches_reference(columns):
    rds, tds = _datasets(runner_table())
    assert_same_rows(rds.select(columns), tds.select(columns))
    keep = np.arange(400) % 3 == 0
    assert_same_rows(rds.select(columns).filter_rows(keep), tds.select(columns).filter_rows(keep))
