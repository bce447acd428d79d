"""The grouping analyzers of deequ_tpu_torch against the JAX package.

The same Arrow table (numpy from a seed) goes through both packages at
the same batch geometry (``batch_size`` 700). Both pick the same path
for every plan (dense scatter-add, device sort, host group-by), and:

- counts, distinct counts, ratios, Histogram bins (labels, counts,
  ratios, number of bins) and MutualInformation are equal exactly;
  Entropy too on the dense and host paths (host sums over the same
  counts in the same order);
- Entropy on the device sort path (a float64 sum on the device, in
  another order than XLA's) is within ``SPILL_ENTROPY_REL`` = 1e-12;
- ``FrequenciesAndNumRows`` keys (in order) and counts are equal on the
  dense path; the host group-by and ``merge`` give first-seen order
  (held against a pure-Python oracle) and the same groups and counts as
  the JAX package's Arrow group-by and merge, whose hash order is
  first-seen only up to collisions in its hash table
  (``test_arrow_group_order_is_not_always_first_seen`` pins that), so on
  the host path Entropy and MutualInformation hold to 1e-12;
- the nine grouping Check methods give the same statuses, messages and
  metrics through ``VerificationSuite``, and no public ``Check`` method
  of the JAX package is missing from the port.

Covered key types: int64 (bounded range: dense; wide: device sort),
float32 and float64 (NaN payloads, -0.0), boolean, timestamp and string,
with nulls and ``where=``.
"""

import datetime

import numpy as np
import pyarrow as pa
import pytest

import deequ_tpu as R
from deequ_tpu import config as rconfig
from deequ_tpu.analyzers import grouping as rgrouping

import deequ_tpu_torch as T
from deequ_tpu_torch import config as tconfig
from deequ_tpu_torch.analyzers import grouping as tgrouping

N = 2000
BATCH = 700
SPILL_ENTROPY_REL = 1e-12

_NAN2 = np.frombuffer(np.uint64(0xFFF8000000000123).tobytes(), dtype=np.float64)[0]


def _columns(seed, n=N):
    """Every key type, each with nulls."""
    rng = np.random.default_rng(seed)
    null = rng.random(n) < 0.05
    small = rng.integers(0, 40, n)
    wide = rng.integers(-(2**40), 2**40, n)
    wide[::37] = wide[5]  # repeats, so some groups hold more than one row
    f64 = rng.normal(size=n).round(2)
    f64[::11] = np.nan
    f64[::13] = _NAN2
    f64[::17] = -0.0
    f64[::19] = 0.0
    f32 = (rng.normal(size=n).round(1)).astype(np.float32)
    f32[::7] = np.float32("nan")
    f32[::9] = np.float32(-0.0)
    epoch = datetime.datetime(2024, 1, 1)
    stamps = [epoch + datetime.timedelta(hours=int(h)) for h in rng.integers(0, 30, n)]
    words = np.array(["alpha", "beta", "gamma", "delta", "eps"], dtype=object)
    return {
        "small": pa.array(small, mask=null),
        "small2": pa.array(rng.integers(0, 7, n), mask=np.roll(null, 3)),
        "wide": pa.array(wide, mask=np.roll(null, 5)),
        "f64": pa.array(f64, mask=np.roll(null, 7)),
        "f32": pa.array(f32, mask=np.roll(null, 9)),
        "flag": pa.array(rng.random(n) < 0.3, mask=np.roll(null, 11)),
        "ts": pa.array(stamps, type=pa.timestamp("us"), mask=np.roll(null, 13)),
        "word": pa.array(list(words[rng.integers(0, 5, n)]), mask=np.roll(null, 15)),
        "gate": pa.array(rng.integers(0, 3, n)),
    }


TABLE = pa.table(_columns(3))

# (port analyzer, reference analyzer) factories by name
KINDS = {
    "CountDistinct": (T.CountDistinct, R.CountDistinct),
    "Distinctness": (T.Distinctness, R.Distinctness),
    "Uniqueness": (T.Uniqueness, R.Uniqueness),
    "UniqueValueRatio": (T.UniqueValueRatio, R.UniqueValueRatio),
    "Entropy": (T.Entropy, R.Entropy),
}

# the columns whose single-column plans take the device sort
SPILL_COLUMNS = {"wide", "f64", "f32"}


def _run(table, analyzers_t, analyzers_r, **options):
    with rconfig.configure(batch_size=BATCH, **options):
        ref = R.AnalysisRunner.do_analysis_run(R.Dataset.from_arrow(table), analyzers_r)
    with tconfig.configure(device="cpu", batch_size=BATCH, **options):
        port = T.AnalysisRunner.do_analysis_run(T.Dataset.from_arrow(table), analyzers_t)
    return ref, port


def _histogram_dict(dist):
    return (
        dist.number_of_bins,
        {k: (v.absolute, v.ratio) for k, v in dist.values.items()},
    )


def _assert_same(ref_metric, port_metric, rel=None):
    assert ref_metric.value.is_success == port_metric.value.is_success, (
        ref_metric, port_metric,
    )
    if not ref_metric.value.is_success:
        assert type(port_metric.value.exception).__name__ == type(
            ref_metric.value.exception
        ).__name__
        return
    r, p = ref_metric.value.get(), port_metric.value.get()
    if hasattr(r, "values"):
        assert list(p.values) == list(r.values)  # bin order too
        assert _histogram_dict(p) == _histogram_dict(r)
    elif rel is not None:
        assert p == pytest.approx(r, rel=rel, abs=0.0)
    else:
        assert np.float64(p).tobytes() == np.float64(r).tobytes(), (r, p)


COLUMN_SETS = [
    ("small",), ("wide",), ("f64",), ("f32",), ("flag",), ("ts",), ("word",),
    ("word", "small"), ("flag", "ts"), ("small", "small2", "word"),
]


@pytest.mark.parametrize("where", [None, "gate = 1"])
@pytest.mark.parametrize("columns", COLUMN_SETS, ids=["+".join(c) for c in COLUMN_SETS])
def test_frequency_analyzers_match_reference(columns, where):
    names = list(KINDS)
    cols = list(columns)
    analyzers_t = [KINDS[k][0](cols, where) for k in names]
    analyzers_r = [KINDS[k][1](cols, where) for k in names]
    ref, port = _run(TABLE, analyzers_t, analyzers_r)
    spill = len(cols) == 1 and cols[0] in SPILL_COLUMNS
    for name, at, ar in zip(names, analyzers_t, analyzers_r):
        rel = SPILL_ENTROPY_REL if (spill and name == "Entropy") else None
        _assert_same(ref.metric(ar), port.metric(at), rel)


@pytest.mark.parametrize("column", ["small", "wide", "f64", "f32", "flag", "ts", "word"])
@pytest.mark.parametrize("bins", [1000, 3])
@pytest.mark.parametrize("where", [None, "gate = 2"])
def test_histogram_matches_reference(column, bins, where):
    at = T.Histogram(column, max_detail_bins=bins, where=where)
    ar = R.Histogram(column, max_detail_bins=bins, where=where)
    ref, port = _run(TABLE, [at], [ar])
    _assert_same(ref.metric(ar), port.metric(at))


PAIRS = [("small", "small2"), ("word", "small"), ("flag", "ts"), ("small", "f64")]


@pytest.mark.parametrize("pair", PAIRS, ids=["+".join(p) for p in PAIRS])
@pytest.mark.parametrize("where", [None, "gate <> 0"])
def test_mutual_information_matches_reference(pair, where):
    at = T.MutualInformation(list(pair), where)
    ar = R.MutualInformation(list(pair), where)
    ref, port = _run(TABLE, [at], [ar])
    _assert_same(ref.metric(ar), port.metric(at))


def _frequencies(table, plan_cols, where=None, include_nulls=False, **options):
    """The frequency state of one plan in each package."""
    rplan = rgrouping.FrequencyPlan(tuple(plan_cols), where, include_nulls)
    tplan = tgrouping.FrequencyPlan(tuple(plan_cols), where, include_nulls)
    with rconfig.configure(batch_size=BATCH, **options):
        ref = rgrouping.compute_many_frequencies(R.Dataset.from_arrow(table), [rplan])[rplan]
    with tconfig.configure(device="cpu", batch_size=BATCH, **options):
        engine = T.AnalysisEngine(device="cpu")
        port = tgrouping.compute_many_frequencies(
            T.Dataset.from_arrow(table), [tplan], engine
        )[tplan]
    return ref, port


def _identity(v):
    if isinstance(v, float) and v != v:
        return ("nan",)
    return (type(v).__name__, v)


def _key_list(state):
    return [tuple(_identity(v) for v in row) for row in state.keys]


def _assert_state_equal(ref, port):
    assert port.num_rows == ref.num_rows
    assert _key_list(port) == _key_list(ref)
    assert port.counts.tolist() == ref.counts.tolist()


def _first_seen_oracle(table, columns, keep):
    """Groups of the kept rows in first-seen order, in pure Python (float
    keys normalised: every NaN one key, -0.0 as 0.0)."""
    lists = [table.column(c).to_pylist() for c in columns]
    groups = {}
    for i in np.nonzero(keep)[0]:
        row = tuple(
            0.0 if (isinstance(col[i], float) and col[i] == 0.0) else col[i]
            for col in lists
        )
        ident = tuple(_identity(v) for v in row)
        groups[ident] = groups.get(ident, 0) + 1
    return list(groups), list(groups.values())


def _assert_host_state(ref, port, oracle):
    """The port's host group-by equals the first-seen oracle in order;
    the JAX package's Arrow group-by holds the same groups and counts
    (its order is first-seen only up to hash-table collisions)."""
    keys, counts = oracle
    assert _key_list(port) == keys
    assert port.counts.tolist() == counts
    assert port.num_rows == ref.num_rows == sum(counts)
    assert sorted(zip(_key_list(ref), ref.counts.tolist()), key=repr) == sorted(
        zip(keys, counts), key=repr
    )


FORCE_HOST = {"dense_grouping_budget_bytes": 8, "device_spill_grouping": False}
SMALL_TABLE = pa.table(_columns(5, 120))


def _kept(table, columns, where, include_nulls=False):
    keep = np.ones(table.num_rows, dtype=bool)
    if where is not None:  # "gate = 1", the one filter of these tests
        keep &= np.asarray(table.column("gate")) == 1
    if not include_nulls:
        valid = np.zeros(table.num_rows, dtype=bool)
        for c in columns:
            valid |= np.asarray(table.column(c).is_valid())
        keep &= valid
    return keep


@pytest.mark.parametrize("columns", COLUMN_SETS, ids=["+".join(c) for c in COLUMN_SETS])
@pytest.mark.parametrize("include_nulls", [False, True])
def test_dense_frequencies_in_reference_order(columns, include_nulls):
    if set(columns) & SPILL_COLUMNS and len(columns) == 1:
        options = {"device_spill_grouping": False}  # the dense path
    else:
        options = {}
    ref, port = _frequencies(TABLE, columns, "gate <> 1", include_nulls, **options)
    _assert_state_equal(ref, port)


@pytest.mark.parametrize("columns", COLUMN_SETS, ids=["+".join(c) for c in COLUMN_SETS])
@pytest.mark.parametrize("where", [None, "gate = 1"])
def test_host_frequencies_match_reference(columns, where):
    """The numpy host group-by against the JAX package's Arrow group-by,
    both forced (a tiny dense budget, no device sort)."""
    for table in (SMALL_TABLE, TABLE):
        ref, port = _frequencies(table, columns, where, **FORCE_HOST)
        _assert_host_state(ref, port, _first_seen_oracle(table, columns, _kept(table, columns, where)))


@pytest.mark.parametrize("columns", [("small",), ("word", "small"), ("f64",), ("flag", "ts")])
def test_host_metrics_match_reference(columns):
    """Metrics on the host path: counts and ratios exact; Entropy and
    MutualInformation sum in group order, which Arrow's hash order may
    change, so they hold to 1e-12 where the orders differ."""
    cols = list(columns)
    analyzers_t = [KINDS[k][0](cols) for k in KINDS]
    analyzers_r = [KINDS[k][1](cols) for k in KINDS]
    if len(cols) == 2:
        analyzers_t.append(T.MutualInformation(cols))
        analyzers_r.append(R.MutualInformation(cols))
    ref, port = _run(TABLE, analyzers_t, analyzers_r, **FORCE_HOST)
    for at, ar in zip(analyzers_t, analyzers_r):
        rel = 1e-12 if at.name in ("Entropy", "MutualInformation") else None
        _assert_same(ref.metric(ar), port.metric(at), rel)


def test_host_path_is_taken_and_counted():
    plan = tgrouping.FrequencyPlan(("word", "small"), None, False)
    events = []
    with tconfig.configure(device="cpu", **FORCE_HOST):
        engine = T.AnalysisEngine(device="cpu")
        tgrouping.compute_many_frequencies(
            T.Dataset.from_arrow(SMALL_TABLE), [plan], engine, events
        )
    assert [e["path"] for e in events if e["event"] == "grouping_spill"] == ["host"]
    assert engine.data_passes == 1


def test_arrow_group_order_is_not_always_first_seen():
    """Pins the JAX package's behaviour that the port does not follow:
    Arrow's hash group-by (its host fallback and merge) leaves
    first-seen order on larger inputs, while the port's numpy group-by
    keeps first-seen order (Arrow's dictionary_encode order, which the
    dense paths of both packages use). Groups and counts still agree."""
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 5000, 20000)
    table = pa.table({"k": keys})
    ref, port = _frequencies(table, ("k",), **FORCE_HOST)
    ref_keys = [k[0] for k in ref.keys]
    port_keys = [k[0] for k in port.keys]
    first_seen = list(dict.fromkeys(keys.tolist()))
    assert port_keys == first_seen
    assert ref_keys != first_seen
    assert sorted(zip(ref_keys, ref.counts.tolist())) == sorted(
        zip(port_keys, port.counts.tolist())
    )


@pytest.mark.parametrize("columns", [("small",), ("word", "small"), ("f64",), ("wide",)])
def test_merge_matches_reference_merge(columns):
    """A state of each half of the table, merged in each package: the
    groups of a first, then the new groups of b, in first-seen order in
    the port; the same groups and counts as the JAX package's merge."""
    a_tab, b_tab = TABLE.slice(0, 1200), TABLE.slice(1200)
    ref_a, port_a = _frequencies(a_tab, columns)
    ref_b, port_b = _frequencies(b_tab, columns)
    ref = rgrouping.FrequenciesAndNumRows.merge(ref_a, ref_b)
    port = tgrouping.FrequenciesAndNumRows.merge(port_a, port_b)
    expected = {}
    for state in (port_a, port_b):
        for key, count in zip(_key_list(state), state.counts.tolist()):
            expected[key] = expected.get(key, 0) + count
    _assert_host_state(ref, port, (list(expected), list(expected.values())))
    # a merged state gives the metrics of the union in both packages
    for kind in ("CountDistinct", "Uniqueness", "Distinctness"):
        at, ar = KINDS[kind][0](list(columns)), KINDS[kind][1](list(columns))
        assert at.compute_metric_from_state(port).value.get() == (
            ar.compute_metric_from_state(ref).value.get()
        )


def test_merge_of_empty_states():
    empty = tgrouping.FrequenciesAndNumRows(
        ("x",), np.empty((0, 1), dtype=object), np.zeros(0, dtype=np.int64), 3
    )
    merged = tgrouping.FrequenciesAndNumRows.merge(empty, empty)
    assert merged.num_groups == 0 and merged.num_rows == 6


@pytest.mark.parametrize("column", ["small", "word", "wide"])
def test_histogram_ties_across_the_bin_cap(column):
    """Equal counts on both sides of max_detail_bins: the kept bins are
    the reference's (stored order on the dense path, key order on the
    device sort)."""
    values = {
        "small": [5, 3, 9, 1, 7, 2] * 4 + [5, 3],
        "word": ["e", "c", "i", "a", "g", "b"] * 4 + ["e", "c"],
        "wide": [v * 10**9 for v in [5, 3, 9, 1, 7, 2]] * 4 + [5 * 10**9, 3 * 10**9],
    }[column]
    table = pa.table({column: values})
    for bins in (1, 2, 3, 4):
        at = T.Histogram(column, max_detail_bins=bins)
        ar = R.Histogram(column, max_detail_bins=bins)
        ref, port = _run(table, [at], [ar])
        _assert_same(ref.metric(ar), port.metric(at))


def _check_results(table, make_check, **options):
    with rconfig.configure(batch_size=BATCH, **options):
        ref = (
            R.VerificationSuite().on_data(R.Dataset.from_arrow(table))
            .add_check(make_check(R.Check(R.CheckLevel.ERROR, "g"))).run()
        )
    with tconfig.configure(device="cpu", batch_size=BATCH, **options):
        port = (
            T.VerificationSuite().on_data(T.Dataset.from_arrow(table))
            .add_check(make_check(T.Check(T.CheckLevel.ERROR, "g"))).run()
        )
    return ref, port


CHECKS = {
    "is_unique": lambda c: c.is_unique("wide").is_unique("small").where("gate = 1"),
    "is_primary_key": lambda c: c.is_primary_key("wide", "small").is_primary_key("small"),
    "has_uniqueness": lambda c: c.has_uniqueness(["word", "small"], lambda v: v > 0.01),
    "has_distinctness": lambda c: c.has_distinctness("f64", lambda v: v > 0.5).where("gate = 0"),
    "has_unique_value_ratio": lambda c: c.has_unique_value_ratio(["f32"], lambda v: v < 0.5),
    "has_number_of_distinct_values": lambda c: c.has_number_of_distinct_values(
        "small", lambda v: v == 40
    ),
    "has_histogram_values": lambda c: c.has_histogram_values(
        "word", lambda d: d["alpha"].ratio > 0.1, max_bins=3
    ),
    "has_entropy": lambda c: c.has_entropy("word", lambda v: 1.0 < v < 2.0),
    "has_mutual_information": lambda c: c.has_mutual_information(
        "small", "small2", lambda v: v < 0.1
    ),
}


@pytest.mark.parametrize("method", sorted(CHECKS))
def test_check_methods_match_reference(method):
    ref, port = _check_results(TABLE, CHECKS[method])
    assert port.status.value == ref.status.value
    [ref_check] = ref.check_results.values()
    [port_check] = port.check_results.values()
    assert len(port_check.constraint_results) == len(ref_check.constraint_results)
    for r, p in zip(ref_check.constraint_results, port_check.constraint_results):
        assert p.status.value == r.status.value
        assert p.message == r.message
        assert str(p.constraint) == str(r.constraint)
        _assert_same(r.metric, p.metric, SPILL_ENTROPY_REL)


def test_no_public_check_method_is_missing():
    public = lambda cls: {n for n in dir(cls) if not n.startswith("_")}  # noqa: E731
    assert public(R.Check) - public(T.Check) == set()


def test_grouping_rides_the_one_scan():
    """Scalars, a dense plan and a spill plan: one pass, and the scan's
    fetch plus the collectors' finalize fetch."""
    analyzers = [T.Size(), T.Mean("f64"), T.Histogram("word"), T.Uniqueness(["wide"])]
    with tconfig.configure(device="cpu", batch_size=BATCH):
        engine = T.AnalysisEngine(device="cpu")
        ctx = T.AnalysisRunner.do_analysis_run(
            T.Dataset.from_arrow(TABLE), analyzers, engine=engine
        )
    assert all(ctx.metric(a).value.is_success for a in analyzers)
    assert engine.data_passes == 1
    assert engine.device_fetches == 2


def test_grouping_analyzer_failures_stay_their_own():
    """A missing column or a bad predicate fails only its analyzer."""
    good = T.CountDistinct(["small"])
    missing = T.CountDistinct(["nope"])
    bad_where = T.Uniqueness(["wide"], where="nope > 1")
    with tconfig.configure(device="cpu", batch_size=BATCH):
        ctx = T.AnalysisRunner.do_analysis_run(
            T.Dataset.from_arrow(TABLE), [good, missing, T.Size()]
        )
    assert ctx.metric(good).value.is_success
    assert not ctx.metric(missing).value.is_success
    assert ctx.metric(T.Size()).value.is_success
    with tconfig.configure(device="cpu", batch_size=BATCH):
        ctx = T.AnalysisRunner.do_analysis_run(
            T.Dataset.from_arrow(TABLE), [bad_where, T.Size()]
        )
    assert not ctx.metric(bad_where).value.is_success
    assert ctx.metric(T.Size()).value.is_success


@pytest.mark.parametrize("column", ["small", "f64", "f32", "flag", "ts", "word", "wide"])
def test_dictionary_matches_reference(column):
    """First-seen dictionaries (float keys normalised) in the JAX
    package's dtype, and the same codes."""
    ref = R.Dataset.from_arrow(TABLE)
    port = T.Dataset.from_arrow(TABLE)
    rd, pd = ref.dictionary(column), port.dictionary(column)
    if rd.dtype.kind == "f":
        assert pd.dtype == rd.dtype
        assert pd.tobytes() == rd.tobytes()
    else:
        assert pd.dtype == rd.dtype or (rd.dtype.kind in "iu" and pd.dtype.kind == "i")
        assert pd.tolist() == rd.tolist()
    from deequ_tpu.data.table import ColumnRequest as RReq
    from deequ_tpu_torch.data.table import ColumnRequest as TReq

    assert port.materialize(TReq(column, "codes")).tolist() == (
        ref.materialize(RReq(column, "codes")).astype(np.int32).tolist()
    )


def test_integral_range_and_dictionary_size():
    port = T.Dataset.from_arrow(TABLE)
    ref = R.Dataset.from_arrow(TABLE)
    for column in ("small", "wide", "f64", "word"):
        assert port.integral_range(column) == ref.integral_range(column)
        for cap in (3, 10**6):
            assert port.dictionary_size_within(column, cap) == ref.dictionary_size_within(
                column, cap
            )
    dict_table = pa.table({"d": pa.array([3, 1, 3]).dictionary_encode()})
    assert T.Dataset.from_arrow(dict_table).integral_range("d") is None
    assert R.Dataset.from_arrow(dict_table).integral_range("d") is None


def _merge_analyzers(pkg):
    return [
        pkg.CountDistinct(["word", "small"]), pkg.Uniqueness(["wide"]),
        pkg.Distinctness(["f64"]), pkg.Entropy(["word"]),
        pkg.Histogram("flag"), pkg.MutualInformation(["small", "small2"]),
    ]


def _metric_value(metric):
    value = metric.value.get()
    if hasattr(value, "values"):
        return value.number_of_bins, {k: v.absolute for k, v in value.values.items()}
    return value


def _assert_union(merged, whole, analyzers_merged, analyzers_whole):
    """A carried state merged with this run's equals the whole table's
    run: counts exact; Entropy and MutualInformation within 1e-12 (the
    merged state holds the groups in another order)."""
    for am, aw in zip(analyzers_merged, analyzers_whole):
        got, want = _metric_value(merged.metric(am)), _metric_value(whole.metric(aw))
        if am.name in ("Entropy", "MutualInformation"):
            assert got == pytest.approx(want, rel=1e-12, abs=0.0), am
        else:
            assert got == want, am


def test_persisted_frequencies_carry_across(tmp_path):
    """A frequency state persisted by either package (the JAX package's
    state-provider form) merges in the other to the whole table's
    metrics; device spill states persist their fetched groups."""
    from deequ_tpu.io.state_provider import FileSystemStateProvider, InMemoryStateProvider

    from deequ_tpu_torch.interop import states_from_numpy, states_to_numpy

    first, second = TABLE.slice(0, 1100), TABLE.slice(1100)
    with rconfig.configure(batch_size=BATCH):
        whole = R.AnalysisRunner.do_analysis_run(R.Dataset.from_arrow(TABLE), _merge_analyzers(R))

    # JAX package -> port
    provider = FileSystemStateProvider(str(tmp_path / "ref"))
    with rconfig.configure(batch_size=BATCH):
        R.AnalysisRunner.do_analysis_run(
            R.Dataset.from_arrow(first), _merge_analyzers(R), save_states_with=provider
        )
    carried = InMemoryStateProvider()
    for ra, ta in zip(_merge_analyzers(R), _merge_analyzers(T)):
        with np.load(tmp_path / "ref" / provider._key(ra)) as arrays:
            assert str(arrays["__type__"]) == "FrequenciesAndNumRows"
            carried.persist(ta, states_from_numpy("FrequenciesAndNumRows", arrays))
    with tconfig.configure(device="cpu", batch_size=BATCH):
        merged = T.AnalysisRunner.do_analysis_run(
            T.Dataset.from_arrow(second), _merge_analyzers(T), aggregate_with=carried
        )
    _assert_union(merged, whole, _merge_analyzers(T), _merge_analyzers(R))

    # port -> JAX package, through the JAX package's own loader
    keep = InMemoryStateProvider()
    with tconfig.configure(device="cpu", batch_size=BATCH):
        T.AnalysisRunner.do_analysis_run(
            T.Dataset.from_arrow(first), _merge_analyzers(T), save_states_with=keep
        )
    target = FileSystemStateProvider(str(tmp_path / "port"))
    (tmp_path / "port").mkdir(exist_ok=True)
    for ra, ta in zip(_merge_analyzers(R), _merge_analyzers(T)):
        state = keep.load(ta)
        np.savez(tmp_path / "port" / target._key(ra), **states_to_numpy(state))
        back = states_from_numpy("FrequenciesAndNumRows", states_to_numpy(state))
        assert back.counts.tolist() == state.counts.tolist()
    with rconfig.configure(batch_size=BATCH):
        merged_ref = R.AnalysisRunner.do_analysis_run(
            R.Dataset.from_arrow(second), _merge_analyzers(R), aggregate_with=target
        )
    _assert_union(merged_ref, whole, _merge_analyzers(R), _merge_analyzers(R))


EDGE_TABLE = pa.table({
    "u": pa.array(np.array([0, 2**64 - 1, 5, 5, 2**63], dtype=np.uint64)),
    "ns": pa.array(np.array([1, 2, 2, 3, 1], dtype="datetime64[ns]")),
    "d": pa.array([datetime.date(2020, 1, 1)] * 3 + [datetime.date(2021, 5, 5), None],
                  pa.date32()),
    "h": pa.array(np.array([1.5, 2.5, 1.5, 0.1, 0.1], dtype=np.float16)),
})


@pytest.mark.parametrize("column", ["u", "ns", "d", "h"])
def test_edge_key_types_match_reference(column):
    """uint64 (dense: it cannot widen to the sort's int64 lane),
    nanosecond timestamps and dates (dense, keys decoded in the column's
    unit), float16 (the device sort on its float32 widening)."""
    names = ["CountDistinct", "Uniqueness", "Entropy"]
    analyzers_t = [KINDS[k][0]([column]) for k in names] + [T.Histogram(column)]
    analyzers_r = [KINDS[k][1]([column]) for k in names] + [R.Histogram(column)]
    ref, port = _run(EDGE_TABLE, analyzers_t, analyzers_r)
    for at, ar in zip(analyzers_t, analyzers_r):
        rel = SPILL_ENTROPY_REL if (column == "h" and at.name == "Entropy") else None
        _assert_same(ref.metric(ar), port.metric(at), rel)
