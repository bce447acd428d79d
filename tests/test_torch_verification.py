"""Whole-suite differential: deequ_tpu_torch against the JAX package.

One small mixed table (int, float, string and bool columns with nulls)
goes through a VerificationSuite on both packages at the same batch
geometry (two batches). Statuses and constraint results must be equal;
integer-valued metrics and states (counts, min/max, HLL registers) must
be equal exactly. Float sums, means and standard deviations reduce in
another order inside a batch (XLA's reduction tree vs PyTorch's), so
they are compared with a stated relative tolerance: 1e-12 for float64
columns and for integral columns (which widen to float64 per element),
1e-5 for float32 columns, which reduce in float32 inside a batch.

A second suite differential runs ``where=`` filters on every group
family (stats, completeness, numeric and string HLL, lengths) and
Compliance through the Check methods (``satisfies``, sign, comparison,
containment and range checks), with correlation and min/max length.
Correlation is a float like Mean and takes the same tolerance.

Also: a malformed ``where=`` filter or predicate yields that analyzer's
failure metric without touching the analyzers scheduled beside it, and
states carried across from the JAX package (its persisted ``.npz``
arrays) merge with the port's states into whole-table metrics, the
correlation, ratio-of-sums and length states included.
"""

import numpy as np
import pytest
import torch

import deequ_tpu as R
from deequ_tpu import config as rconfig
from deequ_tpu.analyzers import states as rstates
from deequ_tpu.io.state_provider import FileSystemStateProvider, InMemoryStateProvider

import deequ_tpu_torch as T
from deequ_tpu_torch import config as tconfig
from deequ_tpu_torch.analyzers import states as tstates
from deequ_tpu_torch.interop import states_from_numpy, states_to_numpy

N = 3000
BATCH = 2000
RTOL = {"f64": 1e-12, "f32": 1e-5}
FLOAT32_COLUMNS = {"cost"}


def _data(rng, n):
    null = lambda share=0.05: rng.random(n) < share  # noqa: E731
    z = rng.standard_normal(n)
    z[:6] = [np.nan, np.inf, -np.inf, -0.0, 0.0, np.nan]
    cats = np.array(["Books", "Music", "Home", "Shoes", None], dtype=object)
    return {
        "id": rng.integers(-(2**62), 2**62, n),
        "q": np.ma.array(rng.integers(1, 101, n).astype(np.int32), mask=null()),
        "s": rng.integers(-300, 300, n).astype(np.int16),
        "price": np.ma.array(rng.random(n) * 100 + 5, mask=null()),
        "cost": np.ma.array((rng.random(n) * 50 + 1).astype(np.float32), mask=null()),
        "z": z,
        "flag": rng.random(n) < 0.3,
        "cat": list(cats[rng.integers(0, 5, n)]),
    }


def _checks(pkg):
    stats = pkg.Check(pkg.CheckLevel.ERROR, "stats")
    for c in ["id", "q", "s", "price", "cost"]:
        stats = (
            stats.has_mean(c, lambda v: v == v)
            .has_min(c, lambda v: v == v)
            .has_max(c, lambda v: v == v)
            .has_sum(c, lambda v: v == v)
            .has_standard_deviation(c, lambda v: v >= 0)
        )
    stats = stats.has_min("z", lambda v: v < 0).has_max("z", lambda v: v > 0)
    shape = (
        pkg.Check(pkg.CheckLevel.WARNING, "shape")
        .has_size(lambda n: n == N)
        .is_complete("id")
        .is_complete("q")  # fails: q has nulls
        .has_completeness("price", lambda c: c > 0.9)
        .has_completeness("cat", lambda c: c > 0.5)
        .has_completeness("flag", lambda c: c == 1.0)
    )
    sketches = pkg.Check(pkg.CheckLevel.ERROR, "sketches")
    for c in ["id", "q", "s", "price", "z", "flag", "cat"]:
        sketches = sketches.has_approx_count_distinct(c, lambda v: v > 0)
    sketches = sketches.has_approx_count_distinct("cat", lambda v: v > 100)  # fails
    return [stats, shape, sketches]


def _float_kind(analyzer):
    return "f32" if getattr(analyzer, "column", None) in FLOAT32_COLUMNS else "f64"


def _assert_metrics_match(ref_metrics, port_metrics):
    ref = {repr(a): (a, m) for a, m in ref_metrics.items()}
    port = {repr(a): m for a, m in port_metrics.items()}
    assert set(ref) == set(port)
    for key, (analyzer, rm) in ref.items():
        pm = port[key]
        assert rm.value.is_success == pm.value.is_success, key
        if not rm.value.is_success:
            continue
        want, got = rm.value.get(), pm.value.get()
        if type(analyzer).__name__ in ("Mean", "Sum", "StandardDeviation", "Correlation"):
            np.testing.assert_allclose(
                got, want, rtol=RTOL[_float_kind(analyzer)], equal_nan=True, err_msg=key
            )
        else:  # counts, ratios of counts, min/max, HLL estimates: exact
            np.testing.assert_array_equal(got, want, err_msg=key)


class _Keep:
    def __init__(self):
        self.states = {}

    def persist(self, analyzer, state):
        self.states[repr(analyzer)] = state

    def load(self, analyzer):
        return self.states.get(repr(analyzer))


def _run_reference(data, checks, **kwargs):
    with rconfig.configure(batch_size=BATCH):
        return R.VerificationSuite.do_verification_run(
            R.Dataset.from_pydict(data), checks, **kwargs
        )


def _run_port(data, checks, **kwargs):
    with tconfig.configure(device="cpu", batch_size=BATCH):
        return T.VerificationSuite.do_verification_run(
            T.Dataset.from_pydict(data), checks, **kwargs
        )


def test_suite_matches_reference():
    data = _data(np.random.default_rng(0), N)
    rkeep, tkeep = InMemoryStateProvider(), _Keep()
    rchecks, tchecks = _checks(R), _checks(T)
    ref = _run_reference(data, rchecks, save_states_with=rkeep)
    port = _run_port(data, tchecks, save_states_with=tkeep)

    assert port.status.value == ref.status.value == "Error"
    for rc, tc in zip(rchecks, tchecks):
        rres, tres = ref.check_results[rc], port.check_results[tc]
        assert tres.status.value == rres.status.value, rc.description
        assert [str(c.constraint) for c in tres.constraint_results] == [
            str(c.constraint) for c in rres.constraint_results
        ]
        assert [c.status.value for c in tres.constraint_results] == [
            c.status.value for c in rres.constraint_results
        ], rc.description
    _assert_metrics_match(ref.metrics, port.metrics)

    # states: integer leaves and registers exact, float leaves in tolerance
    for analyzer in ref.metrics:
        key = repr(analyzer)
        rstate, tstate = rkeep.load(analyzer), tkeep.states[key]
        assert type(tstate).__name__ == type(rstate).__name__, key
        for field in rstate._fields:
            want = np.asarray(getattr(rstate, field))
            got = getattr(tstate, field).numpy()
            assert got.dtype == want.dtype, (key, field)
            if want.dtype.kind == "f" and field not in ("min_value", "max_value", "n"):
                np.testing.assert_allclose(
                    got, want, rtol=RTOL[_float_kind(analyzer)], err_msg=f"{key}.{field}"
                )
            else:
                np.testing.assert_array_equal(got, want, err_msg=f"{key}.{field}")


def test_where_filter_yields_failure_metric():
    """A malformed filter fails its own analyzer at planning time; a
    well-formed one filters; neither touches the analyzers beside it."""
    data = _data(np.random.default_rng(1), 500)
    check = (
        T.Check(T.CheckLevel.ERROR, "filtered")
        .has_size(lambda n: n == 500)
        .has_mean("price", lambda m: m > 0)
        .where("q >>> 5")
        .has_approx_count_distinct("id", lambda v: v > 0)
        .where("q > 5")
        .has_sum("price", lambda v: v > 0)
        .where("nope > 1")
        .satisfies("q BETWEEN", "broken predicate")
    )
    result = _run_port(data, [check])
    statuses = [c.status.value for c in result.check_results[check].constraint_results]
    assert statuses == ["Success", "Failure", "Success", "Failure", "Failure"]
    metric = result.metrics[T.Mean("price", where="q >>> 5")]
    assert metric.value.is_failure
    assert "PredicateParseError" in str(metric.value.exception)
    assert "unknown column" in str(result.metrics[T.Sum("price", where="nope > 1")].value.exception)
    assert result.metrics[T.Size()].value.get() == 500.0
    q = data["q"]
    kept = int(((np.ma.getmaskarray(q) == 0) & (q.filled(0) > 5)).sum())
    assert 0 < result.metrics[T.ApproxCountDistinct("id", "q > 5")].value.get() < 1.1 * kept


def _filter_checks(pkg):
    """where= on every group family, Compliance through the Check
    methods, correlation and lengths; a malformed predicate rides along
    and fails alone."""
    books = "cat = 'Books'"
    filtered = (
        pkg.Check(pkg.CheckLevel.ERROR, "filtered")
        .has_size(lambda n: n > 0).where(books)
        .is_complete("q").where("price > 50")
        .has_completeness("price", lambda c: c > 0.5).where("q > 50")
        .has_completeness("cat", lambda c: c > 0.5).where("q > 50")
    )
    for c in ["id", "q", "price", "cost"]:
        filtered = (
            filtered.has_mean(c, lambda v: v == v).where(books)
            .has_sum(c, lambda v: v == v).where(books)
            .has_min(c, lambda v: v == v).where("q > 50")
            .has_max(c, lambda v: v == v).where("q > 50")
            .has_standard_deviation(c, lambda v: v >= 0).where(books)
        )
    for c in ["id", "q", "price", "cat"]:
        filtered = filtered.has_approx_count_distinct(c, lambda v: v > 0).where("q > 50")
    compliance = (
        pkg.Check(pkg.CheckLevel.WARNING, "compliance")
        .satisfies("q BETWEEN 1 AND 100", "q in range")
        .is_non_negative("price")
        .is_positive("q")
        .is_positive("z")  # fails: z has negatives
        .is_contained_in("cat", ["Books", "Music", "Home"], lambda v: v > 0.5)
        .is_in_range("price", 5.0, 60.0, hint="price band")
        .is_less_than("cost", "price", lambda v: v > 0.5)
        .is_less_than_or_equal_to("q", "id", lambda v: v >= 0)
        .is_greater_than("price", "cost", lambda v: v > 0.5)
        .is_greater_than_or_equal_to("price", "q", lambda v: v >= 0)
        .satisfies(f"{books} AND price < 50", "cheap books", lambda v: v > 0)
        .satisfies("cat = 'Books' OR q > 90", "books or bulk", lambda v: v > 0).where("price > 20")
        .satisfies("q >>> 1", "malformed")
        .has_correlation("price", "q", lambda r: -1 <= r <= 1)
        .has_min_length("cat", lambda n: n == 4)
        .has_max_length("cat", lambda n: n == 5).where("q > 10")
    )
    return [filtered, compliance]


def test_filtered_suite_matches_reference():
    data = _data(np.random.default_rng(5), N)
    rchecks, tchecks = _filter_checks(R), _filter_checks(T)
    ref = _run_reference(data, rchecks)
    port = _run_port(data, tchecks)
    assert port.status.value == ref.status.value
    for rc, tc in zip(rchecks, tchecks):
        rres, tres = ref.check_results[rc], port.check_results[tc]
        assert tres.status.value == rres.status.value, rc.description
        assert [c.status.value for c in tres.constraint_results] == [
            c.status.value for c in rres.constraint_results
        ], rc.description
        assert [c.message for c in tres.constraint_results] == [
            c.message for c in rres.constraint_results
        ], rc.description
    _assert_metrics_match(ref.metrics, port.metrics)
    bad = T.Compliance("malformed", "q >>> 1")
    assert port.metrics[bad].value.is_failure
    assert sum(m.value.is_failure for m in port.metrics.values()) == 1


def _interop_analyzers(pkg):
    analyzers = [pkg.Size(), pkg.Completeness("q"), pkg.Completeness("cat")]
    for c in ["id", "q", "price", "cost"]:
        analyzers += [
            pkg.Mean(c), pkg.Sum(c), pkg.Minimum(c), pkg.Maximum(c),
            pkg.StandardDeviation(c),
        ]
    analyzers += [pkg.ApproxCountDistinct(c) for c in ["id", "q", "price", "cat"]]
    return analyzers


def _halves(data):
    def half(sl):
        return {k: v[sl] for k, v in data.items()}

    return half(slice(0, N // 2)), half(slice(N // 2, N))


def test_interop_states_carry_across(tmp_path):
    data = _data(np.random.default_rng(2), N)
    first, second = _halves(data)
    provider = FileSystemStateProvider(str(tmp_path))
    with rconfig.configure(batch_size=BATCH):
        R.AnalysisRunner.do_analysis_run(
            R.Dataset.from_pydict(first), _interop_analyzers(R),
            save_states_with=provider,
        )
        whole = R.AnalysisRunner.do_analysis_run(
            R.Dataset.from_pydict(data), _interop_analyzers(R)
        )

    carried = _Keep()
    for analyzer in _interop_analyzers(R):
        with np.load(tmp_path / provider._key(analyzer)) as arrays:
            state = states_from_numpy(str(arrays["__type__"]), arrays, "cpu")
        carried.states[repr(analyzer)] = state

    with tconfig.configure(device="cpu", batch_size=BATCH):
        merged = T.AnalysisRunner.do_analysis_run(
            T.Dataset.from_pydict(second), _interop_analyzers(T),
            aggregate_with=carried,
        )
    _assert_metrics_match(whole.metric_map, merged.metric_map)


def test_states_to_numpy_loads_in_reference():
    data = _data(np.random.default_rng(3), 400)
    keep = _Keep()
    with tconfig.configure(device="cpu"):
        T.AnalysisRunner.do_analysis_run(
            T.Dataset.from_pydict(data), _interop_analyzers(T), save_states_with=keep
        )
    assert tstates.STATE_FORMAT_VERSIONS == rstates.STATE_FORMAT_VERSIONS
    for key, state in keep.states.items():
        arrays = states_to_numpy(state)
        name = str(arrays["__type__"])
        assert int(arrays["__version__"]) == rstates.STATE_FORMAT_VERSIONS.get(name, 1)
        cls = rstates.STATE_TYPES[name]
        ref_state = cls(**{f: arrays[f] for f in cls._fields})
        back = states_from_numpy(name, arrays, "cpu")
        merged = cls.merge(ref_state, ref_state)
        port_merged = type(back).merge(back, back)
        for f in cls._fields:
            np.testing.assert_array_equal(
                getattr(port_merged, f).numpy(), np.asarray(getattr(merged, f)), err_msg=key
            )


@pytest.mark.parametrize("version", [None, 1, 3])
def test_interop_rejects_other_hll_format_versions(version):
    arrays = {"registers": np.zeros(16384, np.int8)}
    if version is not None:
        arrays["__version__"] = np.int64(version)
    with pytest.raises(TypeError, match="format v"):
        states_from_numpy("ApproxCountDistinctState", arrays)
    arrays["__version__"] = np.int64(2)
    state = states_from_numpy("ApproxCountDistinctState", arrays)
    assert state.registers.dtype == torch.int8


def test_from_arrow_matches_from_pydict():
    """``Dataset.from_arrow`` (the one place the port imports pyarrow)
    builds the same columns as ``from_pydict``, dictionary strings
    included."""
    import pyarrow as pa

    data = _data(np.random.default_rng(4), 700)
    table = pa.table(
        {
            k: pa.array(v.data, mask=np.ma.getmaskarray(v))
            if isinstance(v, np.ma.MaskedArray)
            else pa.array(v)
            for k, v in data.items()
        }
    )
    table = table.set_column(
        table.schema.get_field_index("cat"), "cat", pa.compute.dictionary_encode(table["cat"])
    )
    from_arrow, from_dict = T.Dataset.from_arrow(table), T.Dataset.from_pydict(data)
    assert from_arrow.schema == from_dict.schema
    with tconfig.configure(device="cpu"):
        a = T.AnalysisRunner.do_analysis_run(from_arrow, _interop_analyzers(T))
        b = T.AnalysisRunner.do_analysis_run(from_dict, _interop_analyzers(T))
    for analyzer in _interop_analyzers(T):
        assert a.metric(analyzer).value == b.metric(analyzer).value, analyzer


def _new_state_analyzers(pkg):
    return [
        pkg.Correlation("price", "q"),
        pkg.Correlation("cost", "id", where="cat = 'Music'"),
        pkg.RatioOfSums("price", "q"),
        pkg.RatioOfSums("cost", "s", where="q > 20"),
        pkg.MinLength("cat"),
        pkg.MaxLength("cat", where="price > 30"),
        pkg.Compliance("books", "cat = 'Books'"),
        pkg.Mean("price", where="cat IN ('Home', 'Shoes')"),
    ]


def test_new_states_carry_across(tmp_path):
    """Correlation, ratio-of-sums, length and filtered states persisted
    by the JAX package merge in the port into whole-table metrics, and
    the port's persisted arrays load and merge in the JAX package."""
    data = _data(np.random.default_rng(6), N)
    first, second = _halves(data)
    provider = FileSystemStateProvider(str(tmp_path))
    with rconfig.configure(batch_size=BATCH):
        R.AnalysisRunner.do_analysis_run(
            R.Dataset.from_pydict(first), _new_state_analyzers(R), save_states_with=provider
        )
        whole = R.AnalysisRunner.do_analysis_run(
            R.Dataset.from_pydict(data), _new_state_analyzers(R)
        )
    carried = _Keep()
    for analyzer in _new_state_analyzers(R):
        with np.load(tmp_path / provider._key(analyzer)) as arrays:
            carried.states[repr(analyzer)] = states_from_numpy(
                str(arrays["__type__"]), arrays, "cpu"
            )
    keep = _Keep()
    with tconfig.configure(device="cpu", batch_size=BATCH):
        merged = T.AnalysisRunner.do_analysis_run(
            T.Dataset.from_pydict(second), _new_state_analyzers(T),
            aggregate_with=carried, save_states_with=keep,
        )
    for ra, ta in zip(_new_state_analyzers(R), _new_state_analyzers(T)):
        want, got = whole.metric(ra).value.get(), merged.metric(ta).value.get()
        if type(ta).__name__ in ("Correlation", "RatioOfSums", "Mean"):
            # float states merged across halves vs one pass over the whole
            np.testing.assert_allclose(got, want, rtol=RTOL["f32"], err_msg=repr(ta))
        else:
            assert got == want, ta
    for key, state in keep.states.items():
        arrays = states_to_numpy(state)
        cls = rstates.STATE_TYPES[str(arrays["__type__"])]
        ref_state = cls(**{f: arrays[f] for f in cls._fields})
        merged_ref = cls.merge(ref_state, ref_state)
        back = states_from_numpy(str(arrays["__type__"]), arrays, "cpu")
        port_merged = type(back).merge(back, back)
        for f in cls._fields:
            np.testing.assert_array_equal(
                getattr(port_merged, f).numpy(), np.asarray(getattr(merged_ref, f)), err_msg=key
            )
