"""The port's incremental path against the JAX package: state providers,
``run_on_aggregated_states`` and repository reuse.

- The repr, and so the state file key, of every analyzer type is equal
  in both packages (a differing repr would turn a saved state into a
  missing one without an error).
- Every state type (each analyzer type's NamedTuple state, the KLL
  sketch, frequency states from the dense and from the device-spill
  path), saved by either package's ``FileSystemStateProvider``, loads
  in the other and merges with the other's own state: metrics over the
  two partitions equal the other package's (integers and counts
  exactly, floats within 1e-12 relative: sums in another order). The
  ``index.json`` files are equal, and every state file holds the same
  arrays (integers exactly, floats within 1e-12 relative).
- ``run_on_aggregated_states`` of the analysis and of the verification
  suite equal the JAX package's; ``reuse_existing_results_for_key`` runs
  no data pass when the repository holds every metric, and
  ``fail_if_results_missing`` raises as the JAX package does.
- The flow of ``examples/incremental_metrics.py`` gives equal metrics.
"""

import contextlib
import io
import json
import math
import os

import numpy as np
import pytest

import deequ_tpu as R
from deequ_tpu import config as rconfig
from deequ_tpu.io.state_provider import FileSystemStateProvider as RFsp
from deequ_tpu.io.state_provider import InMemoryStateProvider as RMsp

import deequ_tpu_torch as T
from deequ_tpu_torch import config as tconfig
from deequ_tpu_torch.io.state_provider import FileSystemStateProvider as TFsp
from deequ_tpu_torch.io.state_provider import InMemoryStateProvider as TMsp
from deequ_tpu_torch.io.state_provider import state_key
from deequ_tpu_torch.data.table import ColumnRequest as TReq

from test_torch_repository import analyzers, table

RTOL = 1e-12


@pytest.fixture(autouse=True)
def _cpu():
    with tconfig.configure(device="cpu"):
        yield


def _stateful(P):
    # ColumnCount is answered from the schema and keeps no state
    return [a for a in analyzers(P) if type(a).__name__ != "ColumnCount"]


def test_every_analyzer_type_has_the_reference_repr_and_key():
    ref, port = analyzers(R), analyzers(T)
    assert [type(a).__name__ for a in port] == [type(a).__name__ for a in ref]
    for r, t in zip(ref, port):
        assert repr(t) == repr(r)
        assert state_key(t) == RFsp("mem://unused")._key(r)
    extra = [
        (R.ApproxQuantile("x", 0.25, relative_error=0.05, where="i > 2"),
         T.ApproxQuantile("x", 0.25, relative_error=0.05, where="i > 2")),
        (R.KLLSketch("f", params=R.KLLParameters(64, 0.5, 10)),
         T.KLLSketch("f", params=T.KLLParameters(64, 0.5, 10))),
        (R.Histogram("s", max_detail_bins=3, where="x > 1"),
         T.Histogram("s", max_detail_bins=3, where="x > 1")),
        (R.Compliance("c", "s = 'a1' OR x IS NULL"), T.Compliance("c", "s = 'a1' OR x IS NULL")),
    ]
    for r, t in extra:
        assert repr(t) == repr(r)


def _metric(m):
    if m.value.is_failure:
        return ("failure", type(m.value.exception).__name__)
    v = m.value.get()
    if hasattr(v, "buckets"):
        return ("kll", [(b.low_value, b.high_value, b.count) for b in v.buckets])
    if hasattr(v, "number_of_bins"):
        return ("hist", v.number_of_bins, {k: (d.absolute, d.ratio) for k, d in v.values.items()})
    return v


def _close(got, want, path=""):
    if isinstance(want, float) and not isinstance(want, bool):
        if math.isnan(want):
            assert math.isnan(got), path
        else:
            assert got == pytest.approx(want, rel=RTOL, abs=1e-300), path
    elif isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _close(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{path}[{i}]")
    else:
        assert got == want, path


def assert_contexts_close(port_ctx, ref_ctx):
    got = {repr(a): _metric(m) for a, m in port_ctx.metric_map.items()}
    want = {repr(a): _metric(m) for a, m in ref_ctx.metric_map.items()}
    assert list(got) == list(want)
    for k in want:
        _close(got[k], want[k], k)


GROUPING = {
    "dense": {},
    "spill": {"dense_grouping_budget_bytes": 8},
}


def _partitions():
    a, b = table(seed=1, n=700), table(seed=2, n=500)
    return a, b


def _save(P, cfg, provider, data):
    with cfg:
        P.AnalysisRunner.do_analysis_run(P.Dataset.from_pydict(data), _stateful(P),
                                         save_states_with=provider)


def _arrays(raw):
    with np.load(io.BytesIO(raw), allow_pickle=False) as data:
        return {k: data[k] for k in data.files}


@pytest.mark.parametrize("grouping", sorted(GROUPING))
def test_states_saved_by_either_package_load_and_merge_in_the_other(grouping, tmp_path):
    opts = GROUPING[grouping]
    part_a, part_b = _partitions()
    dirs = {(pkg, part): str(tmp_path / f"{pkg}-{part}") for pkg in "rt" for part in "ab"}
    for pkg, P, cfg_mod, prov in (("r", R, rconfig, RFsp), ("t", T, tconfig, TFsp)):
        for part, data in (("a", part_a), ("b", part_b)):
            _save(P, cfg_mod.configure(**opts), prov(dirs[(pkg, part)]), data)

    # the files: the same index, the same keys, the same arrays
    for part in "ab":
        rdir, tdir = dirs[("r", part)], dirs[("t", part)]
        assert sorted(os.listdir(tdir)) == sorted(os.listdir(rdir))
        assert json.load(open(f"{tdir}/index.json")) == json.load(open(f"{rdir}/index.json"))
        for name in os.listdir(rdir):
            if not name.endswith(".npz"):
                continue
            ra, ta = _arrays(open(f"{rdir}/{name}", "rb").read()), _arrays(open(f"{tdir}/{name}", "rb").read())
            assert list(ta) == list(ra), name
            for k in ra:
                assert ta[k].dtype == ra[k].dtype, (name, k)
                if ra[k].dtype.kind == "f":
                    np.testing.assert_allclose(ta[k], ra[k], rtol=RTOL, atol=0, err_msg=f"{name} {k}")
                else:
                    np.testing.assert_array_equal(ta[k], ra[k], err_msg=f"{name} {k}")

    schema_r = R.Dataset.from_pydict(part_a).schema
    schema_t = T.Dataset.from_pydict(part_a).schema
    # each package merges its own partition a with the other's partition b
    ref = R.AnalysisRunner.run_on_aggregated_states(
        schema_r, _stateful(R), [RFsp(dirs[("r", "a")]), RFsp(dirs[("t", "b")])])
    port = T.AnalysisRunner.run_on_aggregated_states(
        schema_t, _stateful(T), [TFsp(dirs[("t", "a")]), TFsp(dirs[("r", "b")])])
    assert_contexts_close(port, ref)
    # and the whole run over both partitions gives the same metrics
    union = {k: (np.ma.concatenate([part_a[k], part_b[k]]) if isinstance(part_a[k], np.ndarray)
                 else part_a[k] + part_b[k]) for k in part_a}
    with tconfig.configure(**opts):
        whole = T.AnalysisRunner.do_analysis_run(T.Dataset.from_pydict(union), _stateful(T))
    kll_free = {a: m for a, m in whole.metric_map.items()
                if type(a).__name__ not in ("KLLSketch", "ApproxQuantile", "ApproxQuantiles")}
    assert_contexts_close(T.AnalyzerContext({a: port.metric_map[a] for a in kll_free}),
                          T.AnalyzerContext(kll_free))


def test_aggregate_with_merges_a_reference_state_into_a_run(tmp_path):
    part_a, part_b = _partitions()
    _save(R, rconfig.configure(), RFsp(str(tmp_path / "r")), part_a)
    _save(T, tconfig.configure(), TFsp(str(tmp_path / "t")), part_a)
    ref = R.AnalysisRunner.do_analysis_run(R.Dataset.from_pydict(part_b), _stateful(R),
                                           aggregate_with=RFsp(str(tmp_path / "t")))
    port = T.AnalysisRunner.do_analysis_run(T.Dataset.from_pydict(part_b), _stateful(T),
                                            aggregate_with=TFsp(str(tmp_path / "r")))
    assert_contexts_close(port, ref)


def test_in_memory_provider_round_trip():
    part_a, part_b = _partitions()
    providers = []
    for data in (part_a, part_b):
        p = TMsp()
        T.AnalysisRunner.do_analysis_run(T.Dataset.from_pydict(data), _stateful(T), save_states_with=p)
        providers.append(p)
    rproviders = []
    for data in (part_a, part_b):
        p = RMsp()
        R.AnalysisRunner.do_analysis_run(R.Dataset.from_pydict(data), _stateful(R), save_states_with=p)
        rproviders.append(p)
    schema = T.Dataset.from_pydict(part_a).schema
    merged = TMsp()
    port = T.AnalysisRunner.run_on_aggregated_states(schema, _stateful(T), providers,
                                                     save_states_with=merged)
    ref = R.AnalysisRunner.run_on_aggregated_states(R.Dataset.from_pydict(part_a).schema,
                                                    _stateful(R), rproviders)
    assert_contexts_close(port, ref)
    assert merged.load(T.Size()) is not None
    assert repr(merged).startswith("InMemoryStateProvider(")


def test_aggregated_states_without_any_state_and_with_a_failed_precondition(tmp_path):
    empty_r, empty_t = RFsp(str(tmp_path / "r")), TFsp(str(tmp_path / "t"))
    schema = {"x": [1.0, 2.0], "s": ["a", "b"]}
    an = lambda P: [P.Size(), P.Mean("x"), P.Mean("s"), P.Mean("missing"),  # noqa: E731
                    P.ApproxCountDistinct("s"), P.Uniqueness(("s",))]
    ref = R.AnalysisRunner.run_on_aggregated_states(R.Dataset.from_pydict(schema).schema, an(R), [empty_r])
    port = T.AnalysisRunner.run_on_aggregated_states(T.Dataset.from_pydict(schema).schema, an(T), [empty_t])
    assert_contexts_close(port, ref)


def test_a_state_of_another_format_version_fails_as_a_metric(tmp_path):
    data = table(seed=3, n=50)
    p = TFsp(str(tmp_path / "t"))
    T.AnalysisRunner.do_analysis_run(T.Dataset.from_pydict(data), [T.Mean("x")], save_states_with=p)
    key = state_key(T.Mean("x"))
    arrays = _arrays(open(tmp_path / "t" / key, "rb").read())
    arrays["__version__"] = np.int64(99)
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    (tmp_path / "t" / key).write_bytes(buf.getvalue())
    schema = T.Dataset.from_pydict(data).schema
    ctx = T.AnalysisRunner.run_on_aggregated_states(schema, [T.Mean("x")], [p])
    assert ctx.metric(T.Mean("x")).value.is_failure
    with pytest.raises(TypeError):
        p.load(T.Mean("x"))
    rctx = R.AnalysisRunner.run_on_aggregated_states(
        R.Dataset.from_pydict(data).schema, [R.Mean("x")], [RFsp(str(tmp_path / "t"))])
    assert rctx.metric(R.Mean("x")).value.is_failure


def test_no_overwrite_refuses_a_second_state(tmp_path):
    p = TFsp(str(tmp_path / "t"), allow_overwrite=False)
    ds = T.Dataset.from_pydict({"x": [1.0, 2.0]})
    T.AnalysisRunner.do_analysis_run(ds, [T.Mean("x")], save_states_with=p)
    ctx = T.AnalysisRunner.do_analysis_run(ds, [T.Mean("x")], save_states_with=p)
    assert ctx.metric(T.Mean("x")).value.is_failure  # FileExistsError, as a metric


def test_mem_uri_provider(tmp_path):
    import uuid

    part_a, part_b = _partitions()
    uris = [f"mem://{uuid.uuid4().hex}/day{i}" for i in range(2)]
    for uri, data in zip(uris, (part_a, part_b)):
        T.AnalysisRunner.do_analysis_run(T.Dataset.from_pydict(data), _stateful(T),
                                         save_states_with=TFsp(uri))
    schema = T.Dataset.from_pydict(part_a).schema
    via_mem = T.AnalysisRunner.run_on_aggregated_states(schema, _stateful(T), [TFsp(u) for u in uris])
    dirs = [str(tmp_path / f"d{i}") for i in range(2)]
    for d, data in zip(dirs, (part_a, part_b)):
        T.AnalysisRunner.do_analysis_run(T.Dataset.from_pydict(data), _stateful(T),
                                         save_states_with=TFsp(d))
    via_disk = T.AnalysisRunner.run_on_aggregated_states(schema, _stateful(T), [TFsp(d) for d in dirs])
    assert_contexts_close(via_mem, via_disk)


def _checks(P):
    return [
        P.Check(P.CheckLevel.ERROR, "merged")
        .has_size(lambda s: s == 1200)
        .is_complete("i")
        .has_completeness("x", lambda c: c > 0.85)
        .has_mean("x", lambda m: 9.0 < m < 11.0)
        .has_approx_count_distinct("s", lambda d: d >= 5)
        .is_unique("i")
        .has_approx_quantile("f", 0.5, lambda q: 0.4 < q < 0.6)
        .has_max_length("s", lambda n: n == 3),
    ]


def _check_rows(result):
    return [(r["check"], r["check_status"], r["constraint"], r["constraint_status"],
             r["constraint_message"]) for r in result.check_results_as_records()]


def test_verification_on_aggregated_states_equals_the_reference(tmp_path):
    part_a, part_b = _partitions()
    rprov, tprov = [], []
    for i, data in enumerate((part_a, part_b)):
        rp, tp = RFsp(str(tmp_path / f"r{i}")), TFsp(str(tmp_path / f"t{i}"))
        R.VerificationSuite().on_data(R.Dataset.from_pydict(data)).add_checks(_checks(R)) \
            .save_states_with(rp).run()
        T.VerificationSuite().on_data(T.Dataset.from_pydict(data)).add_checks(_checks(T)) \
            .save_states_with(tp).run()
        rprov.append(rp)
        tprov.append(tp)
    ref = R.VerificationSuite.run_on_aggregated_states(
        R.Dataset.from_pydict(part_a).schema, _checks(R), rprov)
    port = T.VerificationSuite.run_on_aggregated_states(
        T.Dataset.from_pydict(part_a).schema, _checks(T), tprov)
    assert port.status.value == ref.status.value
    assert _check_rows(port) == _check_rows(ref)
    # crossed: the port over the reference's states
    crossed = T.VerificationSuite.run_on_aggregated_states(
        T.Dataset.from_pydict(part_a).schema, _checks(T),
        [TFsp(str(tmp_path / "r0")), TFsp(str(tmp_path / "r1"))])
    assert _check_rows(crossed) == _check_rows(ref)


def _repo_runs(P, repo, key, data, engine=None, **reuse):
    builder = P.AnalysisRunner.on_data(P.Dataset.from_pydict(data)).add_analyzers(_stateful(P)) \
        .use_repository(repo)
    if engine is not None:
        builder = builder.with_engine(engine)
    if reuse:
        builder = builder.reuse_existing_results_for_key(key, **reuse)
    else:
        builder = builder.save_or_append_result(key)
    return builder.run()


def test_reuse_runs_no_pass_when_every_metric_is_stored():
    data = table(seed=4, n=300)
    repo = T.InMemoryMetricsRepository()
    key = T.ResultKey.of(100, {"d": "x"})
    first = _repo_runs(T, repo, key, data)
    engine = T.AnalysisEngine()
    again = _repo_runs(T, repo, key, data, engine=engine, fail_if_results_missing=True)
    assert engine.data_passes == 0 and engine.device_fetches == 0
    assert {repr(a): _metric(m) for a, m in again.metric_map.items()} == \
        {repr(a): _metric(m) for a, m in first.metric_map.items()}
    # one more analyzer: only it is computed, in one pass
    engine = T.AnalysisEngine()
    ctx = T.AnalysisRunner.on_data(T.Dataset.from_pydict(data)).with_engine(engine) \
        .add_analyzers(_stateful(T) + [T.Sum("i")]).use_repository(repo) \
        .reuse_existing_results_for_key(key).run()
    assert engine.data_passes == 1
    assert ctx.metric(T.Sum("i")).value.get() == float(np.sum(data["i"]))


def test_fail_if_results_missing_raises_as_the_reference():
    data = table(seed=5, n=200)
    msgs = []
    for P in (R, T):
        repo = P.InMemoryMetricsRepository()
        key = P.ResultKey.of(7)
        P.AnalysisRunner.on_data(P.Dataset.from_pydict(data)).add_analyzers([P.Size()]) \
            .use_repository(repo).save_or_append_result(key).run()
        with pytest.raises(RuntimeError) as err:
            P.AnalysisRunner.on_data(P.Dataset.from_pydict(data)) \
                .add_analyzers([P.Size(), P.Mean("x")]).use_repository(repo) \
                .reuse_existing_results_for_key(key, fail_if_results_missing=True).run()
        msgs.append(str(err.value))
        # without a stored result at all
        with pytest.raises(RuntimeError):
            P.AnalysisRunner.on_data(P.Dataset.from_pydict(data)).add_analyzers([P.Size()]) \
                .use_repository(repo) \
                .reuse_existing_results_for_key(P.ResultKey.of(8), fail_if_results_missing=True).run()
    assert msgs[1] == msgs[0]


@contextlib.contextmanager
def reference_telemetry(enabled):
    """Both packages' telemetry switched on or off for a block. With it
    on (the default), a saved result also carries the run's operational
    records (``OperationalAnalyzer``), whose values are each run's own
    timings."""
    from deequ_tpu.telemetry import get_telemetry
    from deequ_tpu_torch.telemetry import get_telemetry as port_telemetry

    runtimes = (get_telemetry(), port_telemetry())
    before = [tm.enabled for tm in runtimes]
    for tm in runtimes:
        tm.configure(enabled=enabled)
    try:
        yield
    finally:
        for tm, was in zip(runtimes, before):
            tm.configure(enabled=was)


def test_save_or_append_appends_to_the_stored_result():
    data = table(seed=6, n=200)
    out = []
    for P in (R, T):
        repo = P.InMemoryMetricsRepository()
        key = P.ResultKey.of(9, {"t": "1"})
        with reference_telemetry(False):
            P.AnalysisRunner.on_data(P.Dataset.from_pydict(data)).add_analyzers([P.Size()]) \
                .use_repository(repo).save_or_append_result(key).run()
            P.AnalysisRunner.on_data(P.Dataset.from_pydict(data)).add_analyzers([P.Mean("x")]) \
                .use_repository(repo).save_or_append_result(key).run()
        stored = repo.load_by_key(key).analyzer_context
        out.append({repr(a): _metric(m) for a, m in stored.metric_map.items()})
    assert list(out[1]) == list(out[0]) == ["Size(where=None)", "Mean(column='x', where=None)"]
    _close(out[1], out[0])


def test_reference_operational_records_are_not_read_by_the_port(tmp_path):
    """Repaired: this pinned a divergence until the port had telemetry
    (its serde did not know ``OperationalAnalyzer``, so it read such a
    file as empty). With its telemetry on, the JAX package saves those
    records beside the metrics, and the port now reads them: every
    record, the operational ones included. Without them the file loads
    as before."""
    data = table(seed=7, n=100)
    for enabled in (True, False):
        path = str(tmp_path / f"metrics-{enabled}.json")
        with reference_telemetry(enabled):
            R.AnalysisRunner.on_data(R.Dataset.from_pydict(data)).add_analyzers([R.Size()]) \
                .use_repository(R.FileSystemMetricsRepository(path)) \
                .save_or_append_result(R.ResultKey.of(1)).run()
        stored = R.FileSystemMetricsRepository(path).load().get()
        assert len(stored) == 1
        assert any(type(a).__name__ == "OperationalAnalyzer"
                   for a in stored[0].analyzer_context.metric_map) == enabled
        got = T.FileSystemMetricsRepository(path).load().get()
        assert len(got) == 1
        assert sorted(repr(a) for a in got[0].analyzer_context.metric_map) == \
            sorted(repr(a) for a in stored[0].analyzer_context.metric_map)


def test_incremental_metrics_example_flow_equals_the_reference(tmp_path):
    """``examples/incremental_metrics.py``, cut to 3,000-4,500 rows a day."""
    def flow(P, root):
        an = [P.Size(), P.Mean("amount"), P.Completeness("amount"), P.ApproxCountDistinct("customer")]

        def day(seed, n):
            r = np.random.default_rng(seed)
            return P.Dataset.from_pydict(
                {"amount": r.gamma(2.0, 50.0, n), "customer": r.integers(0, 5000, n)})

        providers = []
        for i, n in enumerate((3_000, 4_500, 2_500)):
            provider = P.FileSystemStateProvider(os.path.join(root, f"day{i}"))
            P.AnalysisRunner.do_analysis_run(day(i, n), an, save_states_with=provider)
            providers.append(provider)
        ctx = P.AnalysisRunner.run_on_aggregated_states(day(0, 1).schema, an, providers)
        assert ctx.metric(P.Size()).value.get() == 10_000.0
        return ctx.success_metrics_as_records()

    ref = flow(R, str(tmp_path / "r"))
    port = flow(T, str(tmp_path / "t"))
    assert [(r["entity"], r["instance"], r["name"]) for r in port] == \
        [(r["entity"], r["instance"], r["name"]) for r in ref]
    for p, r in zip(port, ref):
        assert p["value"] == pytest.approx(r["value"], rel=RTOL)


def test_slice_rows_partitions_are_views_with_equal_metrics():
    """``Dataset.slice_rows`` (the smoke's daily partitions of one table):
    numeric columns are views of the table's arrays, and every metric of
    a slice equals that of a dataset built from the same rows."""
    data = table(seed=8, n=900)
    words = np.array(["p", "qq", "rrr", "ssss"], dtype=object)
    rng = np.random.default_rng(9)
    data["d"] = T.DictionaryColumn(rng.integers(-1, 4, 900).astype(np.int32), words)
    ds = T.Dataset.from_pydict(data)
    an = _stateful(T)
    empty = ds.slice_rows(900, 900)
    assert empty.num_rows == 0 and empty.schema == ds.schema
    for start, stop in ((0, 300), (300, 850), (850, 900), (-100, None)):
        part = ds.slice_rows(start, 900 if stop is None else stop)
        sl = slice(start, stop)
        sub = {k: (v[sl] if not isinstance(v, T.DictionaryColumn)
                   else T.DictionaryColumn(v.codes[sl], v.dictionary))
               for k, v in data.items()}
        ref = T.Dataset.from_pydict(sub)
        assert part.num_rows == ref.num_rows
        assert np.shares_memory(part.materialize(TReq("x", "values")),
                                    ds.materialize(TReq("x", "values")))
        assert_contexts_close(T.AnalysisRunner.do_analysis_run(part, an + [T.Histogram("d")]),
                              T.AnalysisRunner.do_analysis_run(ref, an + [T.Histogram("d")]))
