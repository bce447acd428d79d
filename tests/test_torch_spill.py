"""The device sort path of deequ_tpu_torch (``analyzers/spill.py``)
against the JAX package, mirroring the single-device cases of
``tests/test_spill.py`` and ``tests/test_one_pass_spill.py``.

Both packages run on the CPU at the same ``batch_size`` and take the
same path. Exact: group counts, distinct counts, ratios, the fetched
groups (keys in the JAX package's u64 key order, and counts), Histogram
bins (ties at the cap in key order); the port's collector and deferred
forms against each other (bit for bit, entropy included). Within
``ENTROPY_REL`` = 1e-12: Entropy of a single-column spill plan, a
float64 sum on the device in another order than XLA's (the JAX package
pads its buffer to a power of two; the port does not).
"""

import numpy as np
import pyarrow as pa
import pytest
import torch

import deequ_tpu as R
from deequ_tpu import config as rconfig
from deequ_tpu.analyzers import grouping as rgrouping
from deequ_tpu.analyzers import spill as rspill

import deequ_tpu_torch as T
from deequ_tpu_torch import config as tconfig
from deequ_tpu_torch.analyzers.base import GroupingAnalyzer
from deequ_tpu_torch.analyzers import grouping as tgrouping
from deequ_tpu_torch.analyzers import spill as tspill

BATCH = 700
ENTROPY_REL = 1e-12
I64 = np.iinfo(np.int64)


def _run(table, make, names, **options):
    analyzers_r = [make(R, n) for n in names]
    analyzers_t = [make(T, n) for n in names]
    with rconfig.configure(batch_size=BATCH, **options):
        ref = R.AnalysisRunner.do_analysis_run(R.Dataset.from_arrow(table), analyzers_r)
    with tconfig.configure(device="cpu", batch_size=BATCH, **options):
        port = T.AnalysisRunner.do_analysis_run(T.Dataset.from_arrow(table), analyzers_t)
    return [(ref.metric(a), port.metric(b), n) for a, b, n in zip(analyzers_r, analyzers_t, names)]


def _assert_metrics(pairs, entropy_rel=ENTROPY_REL):
    for r, p, name in pairs:
        assert r.value.is_success and p.value.is_success, (name, r, p)
        rv, pv = r.value.get(), p.value.get()
        if hasattr(rv, "values"):
            assert rv.number_of_bins == pv.number_of_bins
            assert list(pv.values) == list(rv.values), name
            assert {k: (v.absolute, v.ratio) for k, v in pv.values.items()} == {
                k: (v.absolute, v.ratio) for k, v in rv.values.items()
            }
        elif name == "Entropy" and entropy_rel is not None:
            assert pv == pytest.approx(rv, rel=entropy_rel, abs=0.0)
        else:
            assert pv == rv, name


COUNT_KINDS = ["CountDistinct", "Uniqueness", "Distinctness", "UniqueValueRatio", "Entropy"]


def _single(column, where=None):
    return lambda pkg, name: getattr(pkg, name)([column], where)


def _frequencies(table, columns, where=None, include_nulls=False, **options):
    rplan = rgrouping.FrequencyPlan(tuple(columns), where, include_nulls)
    tplan = tgrouping.FrequencyPlan(tuple(columns), where, include_nulls)
    revents, tevents = [], []
    with rconfig.configure(batch_size=BATCH, **options):
        ref = rgrouping.compute_many_frequencies(
            R.Dataset.from_arrow(table), [rplan], events=revents
        )[rplan]
    with tconfig.configure(device="cpu", batch_size=BATCH, **options):
        engine = T.AnalysisEngine(device="cpu")
        port = tgrouping.compute_many_frequencies(
            T.Dataset.from_arrow(table), [tplan], engine, tevents
        )[tplan]
    paths = lambda ev: [e["path"] for e in ev if e.get("event") == "grouping_spill"]  # noqa: E731
    assert paths(tevents) == paths(revents)
    return ref, port, paths(tevents)


def _keys(state):
    return [
        tuple(("nan",) if isinstance(v, float) and v != v else (type(v).__name__, v) for v in row)
        for row in state.keys
    ]


def _assert_state(ref, port):
    assert port.num_rows == ref.num_rows
    assert port.num_groups == ref.num_groups
    assert _keys(port) == _keys(ref)
    assert port.counts.tolist() == ref.counts.tolist()


def _int_table(seed=11, n=6000):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 1500, n, dtype=np.int64) * 7919
    ids[::97] = I64.max  # shares the sentinel's lane: the correction keeps it
    ids[::101] = I64.min
    ids[::103] = -1
    return pa.table({
        "id": pa.array(ids, mask=rng.random(n) < 0.04),
        "flag": pa.array(rng.integers(0, 2, n)),
    })


@pytest.mark.parametrize("where", [None, "flag = 1"])
def test_int_keys_with_extremes(where):
    table = _int_table()
    _assert_metrics(_run(table, _single("id", where), COUNT_KINDS))
    ref, port, paths = _frequencies(table, ["id"], where)
    assert paths == ["device-sort"]
    assert isinstance(port, tspill.DeviceFrequencies)
    _assert_state(ref, port)
    assert I64.max in [k[0] for k in port.keys] and I64.min in [k[0] for k in port.keys]


def test_only_int64_max_keys_and_nulls():
    """Every contributing key equals the sentinel's lane."""
    table = pa.table({"id": pa.array([I64.max] * 5 + [None] * 3 + [I64.max], pa.int64())})
    for include_nulls in (False, True):
        ref, port, _ = _frequencies(table, ["id"], include_nulls=include_nulls)
        _assert_state(ref, port)
    _assert_metrics(_run(table, _single("id"), COUNT_KINDS))


def _float_table(seed=2, n=6000):
    rng = np.random.default_rng(seed)
    f64 = rng.normal(size=n).round(3)
    f64[::7] = np.nan
    f64[1::11] = 0.0
    f64[2::13] = -0.0
    f64[3::17] = np.frombuffer(np.uint64(0xFFF8000000000abc).tobytes(), np.float64)[0]
    f64[4::19] = np.inf
    f32 = rng.normal(size=n).round(2).astype(np.float32)
    f32[::9] = np.float32(0.0)
    f32[1::9] = np.float32(-0.0)
    f32[2::9] = np.float32("nan")
    f32[3::29] = -np.inf
    null = rng.random(n) < 0.05
    return pa.table({
        "f64": pa.array(f64, mask=null),
        "f32": pa.array(f32, mask=np.roll(null, 1)),
        "gate": pa.array(rng.integers(0, 2, n)),
    })


@pytest.mark.parametrize("column", ["f64", "f32"])
@pytest.mark.parametrize("where", [None, "gate = 1"])
def test_float_keys_with_nan_and_signed_zero(column, where):
    table = _float_table()
    _assert_metrics(_run(table, _single(column, where), COUNT_KINDS))
    ref, port, paths = _frequencies(table, [column], where)
    assert paths == ["device-sort"]
    _assert_state(ref, port)


@pytest.mark.parametrize("column", ["f64", "f32", "id"])
@pytest.mark.parametrize("where", [None, "gate = 1"])
@pytest.mark.parametrize("bins", [1000, 5])
def test_include_nulls_histogram(column, where, bins):
    table = _float_table()
    if column == "id":
        table = _int_table().rename_columns(["id", "gate"])
    make = lambda pkg, _n: pkg.Histogram(column, max_detail_bins=bins, where=where)  # noqa: E731
    _assert_metrics(_run(table, make, ["Histogram"]))
    ref, port, paths = _frequencies(table, [column], where, include_nulls=True)
    assert paths == ["device-sort"]
    _assert_state(ref, port)


def test_topk_ties_resolve_in_key_order():
    """Equal counts across the cap: ``lax.top_k`` keeps the lower index,
    i.e. the smaller key; so does the port's stable sort."""
    keys = np.array([9, 4, 7, 1, 8, 2] * 3 + [50, 50, 60], dtype=np.int64) * 10**6
    table = pa.table({"k": keys})
    for bins in (1, 2, 3, 4, 5, 7):
        make = lambda pkg, _n, b=bins: pkg.Histogram("k", max_detail_bins=b)  # noqa: E731
        _assert_metrics(_run(table, make, ["Histogram"]))


def test_topk_fn_against_numpy():
    rng = np.random.default_rng(4)
    counts = torch.as_tensor(rng.integers(0, 4, 300), dtype=torch.int32)
    keys = torch.arange(300, dtype=torch.int64) * 3
    for k in (1, 10, 299):
        tc, tk = tspill._topk_fn(counts, keys, 250, k)
        masked = np.where(np.arange(300) < 250, counts.numpy(), -1)
        order = np.argsort(-masked, kind="stable")[:k]
        assert tc.tolist() == masked[order].tolist()
        assert tk.tolist() == (order * 3).tolist()


def _joint_table(seed, n, card, cols):
    rng = np.random.default_rng(seed)
    data = {}
    for j in range(cols):
        v = rng.integers(0, card, n)
        data[f"c{j}"] = pa.array(v, mask=rng.random(n) < 0.03)
    data["gate"] = pa.array(rng.integers(0, 2, n))
    return pa.table(data)


JOINT_KINDS = ["CountDistinct", "Uniqueness", "Distinctness", "UniqueValueRatio", "Entropy"]
SMALL_BUDGET = {"dense_grouping_budget_bytes": 4 * 1024}


@pytest.mark.parametrize("where", [None, "gate = 1"])
def test_joint_one_lane(where):
    table = _joint_table(7, 6000, 300, 2)
    make = lambda pkg, name: getattr(pkg, name)(["c0", "c1"], where)  # noqa: E731
    # joint plans fold entropy on the host over the fetched groups: exact
    _assert_metrics(_run(table, make, JOINT_KINDS, **SMALL_BUDGET), entropy_rel=None)
    mi = lambda pkg, _n: pkg.MutualInformation(["c0", "c1"], where)  # noqa: E731
    _assert_metrics(_run(table, mi, ["MutualInformation"], **SMALL_BUDGET))
    ref, port, paths = _frequencies(table, ["c0", "c1"], where, **SMALL_BUDGET)
    assert paths == ["device-sort-joint"]
    assert tspill.joint_fits_one_lane([len(port._joint[0][0]) + 1, len(port._joint[0][1]) + 1])
    _assert_state(ref, port)


def test_joint_two_lanes():
    """Four ~55k-cardinality columns: the joint radix product passes one
    lane, so the keys ride two lanes sorted lexicographically."""
    table = _joint_table(8, 60000, 500000, 4)
    names = ["c0", "c1", "c2", "c3"]
    sizes = [len(T.Dataset.from_arrow(table).dictionary(c)) + 1 for c in names]
    assert int(np.prod([float(s) for s in sizes])) >= 2**62
    split = tspill.split_joint_lanes(tuple(sizes))
    assert split is not None and split < len(names)
    make = lambda pkg, name: getattr(pkg, name)(names)  # noqa: E731
    _assert_metrics(_run(table, make, JOINT_KINDS, **SMALL_BUDGET), entropy_rel=None)
    ref, port, paths = _frequencies(table, names, **SMALL_BUDGET)
    assert paths == ["device-sort-joint"]
    assert isinstance(port, tspill.TwoLaneDeviceFrequencies)
    _assert_state(ref, port)


def test_split_joint_lanes_matches_reference():
    big = 2**40
    for sizes in [(10, 10), (big, big), (big, big, big, big), (2**63,), (2**61, 3, 5),
                  (7, 2**60, 2**30), (1,), ()]:
        assert tspill.split_joint_lanes(sizes) == rspill.split_joint_lanes(sizes), sizes
        if sizes:
            assert tspill.joint_fits_one_lane(sizes) == rspill.joint_fits_one_lane(sizes)


def _one_pass_vs_deferred(table, analyzers, **options):
    out = []
    for one_pass in (True, False):
        with tconfig.configure(device="cpu", batch_size=BATCH, one_pass_spill=one_pass, **options):
            engine = T.AnalysisEngine(device="cpu")
            ctx = T.AnalysisRunner.do_analysis_run(
                T.Dataset.from_arrow(table), analyzers, engine=engine
            )
        values = {}
        for a in analyzers:
            value = ctx.metric(a).value
            assert value.is_success, (a, value)
            values[a] = value.get()
        out.append((values, engine.data_passes, engine.device_fetches))
    return out


@pytest.mark.parametrize("case", ["int", "f64", "f32", "histogram", "where", "joint1", "joint2"])
def test_collector_equals_deferred(case):
    if case in ("joint1", "joint2"):
        cols = 2 if case == "joint1" else 4
        table = _joint_table(9, 60000, 300 if cols == 2 else 500000, cols)
        names = [f"c{j}" for j in range(cols)]
        analyzers = [T.Uniqueness(names), T.Distinctness(names), T.Entropy(names)]
        options = SMALL_BUDGET
    else:
        table = _float_table()
        column = {"int": "id", "f64": "f64", "f32": "f32"}.get(case, "f64")
        if case == "int":
            table = _int_table()
        where = "gate = 1" if case == "where" else None
        analyzers = [T.Uniqueness([column], where), T.CountDistinct([column], where),
                     T.Entropy([column], where)]
        if case == "histogram":
            analyzers.append(T.Histogram(column, max_detail_bins=25))
        options = {}
    (one, p1, f1), (per, p0, f0) = _one_pass_vs_deferred(table, analyzers, **options)
    for a in analyzers:
        if hasattr(one[a], "values"):
            assert one[a] == per[a]
        else:
            assert np.float64(one[a]).tobytes() == np.float64(per[a]).tobytes(), a
    # one-pass: the shared scan; deferred: one re-read a plan (no other
    # analyzer rides a scan here)
    assert p1 == 1 and p0 == len(tgrouping.plans_for(analyzers))
    # fetches: the scan's and one finalize against one a plan; the groups
    # fetched on demand (Histogram's top-k, a joint plan's entropy) are
    # the same in both forms
    assert f1 - f0 == 2 - len(tgrouping.plans_for(analyzers))


def _mixed_table(n=20000, seed=0):
    rng = np.random.default_rng(seed)
    return pa.table({
        "id_a": rng.integers(0, 2**40, n),
        "id_b": rng.integers(0, 2**40, n),
        "price": rng.normal(size=n),
        "cat": rng.integers(0, 5, n),
        "x": rng.normal(size=n),
        "q": rng.integers(0, 10**6, n).astype(np.float32),
    })


def _mixed(pkg):
    return [
        pkg.Size(), pkg.Mean("x"), pkg.Completeness("price"),
        pkg.KLLSketch("x"), pkg.ApproxCountDistinct("id_a"),
        pkg.Uniqueness(["id_a"]), pkg.Distinctness(["id_b"]),
        pkg.CountDistinct(["price"]), pkg.UniqueValueRatio(["q"]),
        pkg.Histogram("cat"), pkg.Entropy(["cat"]),
    ]


def test_mixed_suite_costs_one_pass():
    """Scalars, KLL, HLL, a dense plan and four spill plans: one data
    pass; two fetches (the scan's, the collectors' finalize)."""
    table = _mixed_table()
    with tconfig.configure(device="cpu", batch_size=4096):
        engine = T.AnalysisEngine(device="cpu")
        events = []
        dataset = T.Dataset.from_arrow(table)
        grouping = [a for a in _mixed(T) if isinstance(a, GroupingAnalyzer)]
        dense, collectors, deferred = tgrouping.plan_frequency_passes(
            dataset, list(tgrouping.plans_for(grouping)), engine, events
        )
        assert len(dense) == 2 and len(collectors) == 4 and not deferred
        ctx = T.AnalysisRunner.do_analysis_run(dataset, _mixed(T), engine=engine)
    assert engine.data_passes == 1
    assert engine.device_fetches == 2
    with rconfig.configure(batch_size=4096):
        ref = R.AnalysisRunner.do_analysis_run(R.Dataset.from_arrow(table), _mixed(R))
    for a, b in zip(_mixed(R), _mixed(T)):
        r, p = ref.metric(a).value.get(), ctx.metric(b).value.get()
        if isinstance(r, float) and b.name == "Entropy":
            assert p == r
        elif isinstance(r, float) and b.name in ("Mean",):
            assert p == pytest.approx(r, rel=1e-12)
        elif isinstance(r, float):
            assert p == r, b


def test_finalize_against_numpy_unique():
    """The port's sort + segment count against ``np.unique`` on random
    lanes with sentinel rows, legit int64.max keys and one-key runs."""
    rng = np.random.default_rng(13)
    for n in (1, 2, 17, 5000):
        lanes = rng.integers(-50, 50, n).astype(np.int64) * 10**15
        lanes[rng.random(n) < 0.1] = I64.max  # legit keys at the sentinel's value
        sentinel = rng.random(n) < 0.2
        lanes_with = np.where(sentinel, I64.max, lanes)
        scalars, group_keys, counts = tspill._finalize_fn(
            torch.as_tensor(lanes_with), torch.tensor(int(sentinel.sum()))
        )
        kept = lanes[~sentinel]
        uniq, ucounts = np.unique(kept, return_counts=True)
        s = int(scalars["num_segments"])
        got_keys = group_keys[:s].numpy()
        got_counts = counts[:s].numpy()
        live = got_counts > 0
        assert got_keys[live].tolist() == uniq.tolist()
        assert got_counts[live].tolist() == ucounts.tolist()
        assert int(scalars["num_groups"]) == len(uniq)
        assert int(scalars["total"]) == len(kept)
        assert int(scalars["unique"]) == int((ucounts == 1).sum())
        if len(kept):
            p = ucounts / len(kept)
            assert float(scalars["entropy"]) == pytest.approx(-(p * np.log(p)).sum(), rel=1e-12)


def test_segment_counts_equal_scatter_add_form():
    """The boundary-difference counts equal a scatter_add_ of ones per
    segment (the form the smoke times beside it)."""
    rng = np.random.default_rng(3)
    keys = torch.as_tensor(np.sort(rng.integers(0, 300, 20000)))
    boundary = torch.cat([torch.ones(1, dtype=torch.bool), keys[1:] != keys[:-1]])
    seg = torch.cumsum(boundary, 0) - 1
    n = keys.shape[0]
    starts = tspill._segment_starts(boundary, seg)
    counts = torch.cat([starts[1:], starts.new_full((1,), n)]) - starts
    plain = torch.zeros(n + 1, dtype=torch.int32).scatter_add_(
        0, seg, torch.ones(n, dtype=torch.int32)
    )
    assert counts.tolist() == plain.tolist()


def test_f64_lanes_match_host_keys():
    """The device float64 lane, XORed back, is the JAX package's u64 key
    (``host_f64_u64_keys``, which mirrors its device builder)."""
    rng = np.random.default_rng(31)
    vals = rng.normal(0, 1e300, 4096)
    vals[::5] = np.nan
    vals[::7] = -0.0
    vals[::11] = 0.0
    vals[::13] = np.inf
    vals[::17] = np.frombuffer(np.uint64(0xFFF0000000000001).tobytes(), np.float64)[0]
    mask = rng.random(4096) < 0.9
    rows = rng.random(4096) < 0.95
    for include_nulls in (False, True):
        lane = tspill._single_lane(torch.as_tensor(vals), "f64")
        keys, ns, nn = tspill._finish_keys(
            lane, torch.as_tensor(mask), torch.as_tensor(rows), include_nulls
        )
        hk, hns, hnn = tspill.host_f64_u64_keys(vals, mask, rows, include_nulls)
        rk, rns, rnn = rspill.host_f64_u64_keys(vals, mask, rows, include_nulls)
        assert (tspill._u64_of(keys.numpy()) == hk).all() and (hk == rk).all()
        assert int(ns) == hns == rns and int(nn) == hnn == rnn


def test_spec_build_failure_keeps_the_deferred_twin(monkeypatch):
    table = _int_table()

    def broken(*args, **kwargs):
        raise RuntimeError("no spec")

    monkeypatch.setattr(tspill, "single_collector_spec", broken)
    plan = tgrouping.FrequencyPlan(("id",), None, False)
    with tconfig.configure(device="cpu", batch_size=BATCH):
        engine = T.AnalysisEngine(device="cpu")
        dataset = T.Dataset.from_arrow(table)
        dense, collectors, deferred = tgrouping.plan_frequency_passes(dataset, [plan], engine)
        assert not dense and not collectors and plan in deferred
        state = deferred[plan]()
    assert isinstance(state, tspill.DeviceFrequencies)
    assert engine.data_passes == 1


def test_gates_match_reference():
    """The port picks the JAX package's path for every plan shape."""
    table = pa.table({
        "narrow": pa.array(np.arange(5000) % 4000),
        "wide": pa.array(np.arange(5000) * 3),
        "f": pa.array(np.arange(5000) * 0.5),
        "b": pa.array(np.arange(5000) % 2 == 0),
        "u": pa.array(np.arange(5000, dtype=np.uint64) * 10**15),
        "s": pa.array([str(i) for i in range(5000)]),
        "d": pa.array(np.arange(5000) * 3).dictionary_encode(),
    })
    rds, tds = R.Dataset.from_arrow(table), T.Dataset.from_arrow(table)
    for col in table.column_names:
        for include_nulls in (False, True):
            rp = rgrouping.FrequencyPlan((col,), None, include_nulls)
            tp = tgrouping.FrequencyPlan((col,), None, include_nulls)
            for opts in ({}, {"device_spill_grouping": False}, {"device_cache_bytes": 5000 * 63}):
                with rconfig.configure(**opts), tconfig.configure(**opts):
                    assert tspill.device_spill_eligible(tds, tp) == rspill.device_spill_eligible(
                        rds, rp
                    ), (col, opts)
