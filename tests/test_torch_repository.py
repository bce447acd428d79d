"""The port's metrics repositories and their JSON (``deequ_tpu_torch/
repository/``) against the JAX package's.

- Serde: the results of one analysis run over every analyzer type (27,
  one of each, plus failure metrics) serialize to EQUAL strings in both
  packages: JSON written by either package, loaded by the other and
  written again, is the same string byte for byte, and the metrics
  loaded are equal (floats exactly: JSON round-trips a double).
- Repositories: in-memory and file-system, on a path and on ``mem://``;
  a repository file written by either package loads in the other with
  equal metrics; every loader filter (``after``, ``before``,
  ``with_tag_values``, ``for_analyzers``, their combinations) returns the
  same results, records and JSON in both.
"""

import json
import math
import uuid

import numpy as np
import pytest

import deequ_tpu as R
from deequ_tpu.repository import serde as rserde
from deequ_tpu.repository.base import AnalysisResult as RResult
from deequ_tpu.repository.base import InMemoryMetricsRepository as RMem
from deequ_tpu.repository.base import ResultKey as RKey
from deequ_tpu.repository.fs import FileSystemMetricsRepository as RFs

import deequ_tpu_torch as T
from deequ_tpu_torch import config as tconfig
from deequ_tpu_torch.repository import serde as tserde
from deequ_tpu_torch.repository.base import AnalysisResult as TResult
from deequ_tpu_torch.repository.base import InMemoryMetricsRepository as TMem
from deequ_tpu_torch.repository.base import ResultKey as TKey
from deequ_tpu_torch.repository.fs import FileSystemMetricsRepository as TFs


@pytest.fixture(autouse=True)
def _cpu():
    with tconfig.configure(device="cpu"):
        yield


def table(seed=0, n=600):
    rng = np.random.default_rng(seed)
    x = rng.normal(10.0, 3.0, n)
    xmask = rng.random(n) < 0.1
    words = np.array(["a1", "b22", "a3", "ccc", "a5x"], dtype=object)
    s = [None if rng.random() < 0.08 else str(words[rng.integers(0, 5)]) for _ in range(n)]
    return {
        "x": np.ma.array(x, mask=xmask),
        "i": rng.integers(0, 40, n),
        "s": s,
        "f": rng.random(n).astype(np.float32),
    }


def analyzers(P):
    """One analyzer of every type the serde registry holds, several with
    ``where=``, and two that fail (a missing column, a string mean)."""
    return [
        P.Size(), P.Size(where="x > 10"), P.Completeness("x"), P.Completeness("s", where="i > 5"),
        P.Compliance("pos", "x > 10"), P.Sum("x"), P.Mean("x"), P.Minimum("i"), P.Maximum("f"),
        P.StandardDeviation("x"), P.ApproxCountDistinct("i"), P.ApproxCountDistinct("s"),
        P.CountDistinct(("i",)), P.Distinctness(("s",)), P.Uniqueness(("i",)),
        P.UniqueValueRatio(("s", "i")), P.Entropy(("s",)), P.MutualInformation(("s", "i")),
        P.Histogram("s"), P.Histogram("i", max_detail_bins=5), P.Correlation("x", "i"),
        P.RatioOfSums("x", "i"), P.MinLength("s"), P.MaxLength("s"),
        P.PatternMatch("s", r"a\d"), P.DataType("s"), P.KLLSketch("f"),
        P.ApproxQuantile("x", 0.5), P.ApproxQuantiles("f", (0.1, 0.5, 0.9)), P.ColumnCount(),
        P.CustomSql("SUM(x) / COUNT(*)"), P.Mean("missing"), P.Mean("s"),
    ]


def contexts():
    data = table()
    ref = R.AnalysisRunner.do_analysis_run(R.Dataset.from_pydict(data), analyzers(R))
    port = T.AnalysisRunner.do_analysis_run(T.Dataset.from_pydict(data), analyzers(T))
    return ref, port


@pytest.fixture(scope="module")
def both():
    with tconfig.configure(device="cpu"):
        return contexts()


def test_registry_holds_every_port_analyzer():
    # the registries are equal, telemetry's OperationalAnalyzer included
    assert set(tserde.ANALYZER_REGISTRY) == set(rserde.ANALYZER_REGISTRY)
    types = {type(a).__name__ for a in analyzers(T)}
    assert types == set(tserde.ANALYZER_REGISTRY) - {"OperationalAnalyzer"}


def test_every_metric_type_is_covered(both):
    _, port = both
    kinds = {type(m).__name__ for m in port.metric_map.values()}
    assert kinds == {"DoubleMetric", "KeyedDoubleMetric", "HistogramMetric", "KLLMetric"}
    assert any(m.value.is_failure for m in port.metric_map.values())


def _results(mod_result, mod_key, context, dates=(1, 2)):
    return [mod_result(mod_key.of(d, {"dataset": "t", "day": str(d)}), context) for d in dates]


def test_reference_json_reloads_and_rewrites_byte_equal_in_the_port(both):
    ref, _ = both
    text = rserde.serialize(_results(RResult, RKey, ref))
    loaded = tserde.deserialize(text)
    assert tserde.serialize(loaded) == text


def test_port_json_reloads_and_rewrites_byte_equal_in_the_reference(both):
    _, port = both
    text = tserde.serialize(_results(TResult, TKey, port))
    loaded = rserde.deserialize(text)
    assert rserde.serialize(loaded) == text


def _metric_value(metric):
    if metric.value.is_failure:
        return ("failure", str(metric.value.exception))
    v = metric.value.get()
    if isinstance(v, float):
        return ("nan",) if math.isnan(v) else v
    if isinstance(v, dict):
        return dict(v)
    if hasattr(v, "buckets"):
        return (
            [(b.low_value, b.high_value, b.count) for b in v.buckets],
            tuple(v.parameters), tuple(tuple(level) for level in v.data),
        )
    return (v.number_of_bins, {k: (d.absolute, d.ratio) for k, d in v.values.items()})


def _by_repr(context):
    return {repr(a): (type(m).__name__, m.entity.value, m.name, m.instance, _metric_value(m))
            for a, m in context.metric_map.items()}


def test_same_results_serialize_to_equal_strings(both):
    """The reference's results, carried into the port (the same metric
    values), serialize to the reference's string; and the port's own
    run, carried into the reference, to the port's."""
    ref, port = both
    for text in (rserde.serialize(_results(RResult, RKey, ref)),
                 tserde.serialize(_results(TResult, TKey, port))):
        assert tserde.serialize(tserde.deserialize(text)) == rserde.serialize(rserde.deserialize(text))
        assert [_by_repr(r.analyzer_context) for r in tserde.deserialize(text)] == \
            [_by_repr(r.analyzer_context) for r in rserde.deserialize(text)]


def test_port_run_serializes_like_the_reference_run(both):
    """The two packages' own runs over the same data: the same analyzer
    objects and metric names in the same order, and the same values
    (floats within 1e-12 relative: sums in another order)."""
    ref, port = both
    r = json.loads(rserde.serialize(_results(RResult, RKey, ref)))
    t = json.loads(tserde.serialize(_results(TResult, TKey, port)))
    assert len(r) == len(t)
    for re_, te in zip(r, t):
        assert te["result_key"] == re_["result_key"]
        assert [p["analyzer"] for p in te["analyzer_context"]] == \
            [p["analyzer"] for p in re_["analyzer_context"]]
        for rp, tp in zip(re_["analyzer_context"], te["analyzer_context"]):
            rm, tm = rp["metric"], tp["metric"]
            assert {k: v for k, v in tm.items() if k not in ("value", "error")} == \
                {k: v for k, v in rm.items() if k not in ("value", "error")}
            assert ("error" in tm) == ("error" in rm)
            _assert_close(tm.get("value"), rm.get("value"))


def _assert_close(got, want):
    if isinstance(want, float):
        assert got == pytest.approx(want, rel=1e-12, abs=1e-300, nan_ok=True)
    elif isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _assert_close(got[k], want[k])
    elif isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_close(g, w)
    else:
        assert got == want


def test_unknown_analyzer_type_fails_as_in_the_reference():
    text = json.dumps([{
        "result_key": {"dataset_date": 1, "tags": {}},
        "analyzer_context": [{"analyzer": {"type": "NoSuchAnalyzer", "column": "x"},
                              "metric": {"metric_type": "DoubleMetric", "entity": "Column",
                                         "name": "Mean", "instance": "x", "value": 1.0}}],
    }])
    with pytest.raises(ValueError, match="unknown analyzer type"):
        rserde.deserialize(text)
    with pytest.raises(ValueError, match="unknown analyzer type"):
        tserde.deserialize(text)


def test_unknown_metric_type_fails_as_in_the_reference():
    entry = {"type": "Mean", "column": "x", "where": None}
    metric = {"metric_type": "Weird", "entity": "Column", "name": "Mean", "instance": "x",
              "value": 1.0}
    for mod in (rserde, tserde):
        with pytest.raises(TypeError):
            mod.metric_from_json(metric)
        assert mod.analyzer_from_json(entry) is not None


# -- repositories -------------------------------------------------------------


def _repo(kind, mod_fs, mod_mem, tmp_path, name):
    if kind == "memory":
        return mod_mem()
    if kind == "path":
        return mod_fs(str(tmp_path / name / "metrics.json"))
    return mod_fs(f"mem://{uuid.uuid4().hex}/{name}/metrics.json")


HISTORY = [
    (10, {"dataset": "orders", "region": "eu"}),
    (20, {"dataset": "orders", "region": "us"}),
    (30, {"dataset": "orders", "region": "eu"}),
    (40, {"dataset": "users", "region": "eu"}),
    (50, {"dataset": "orders", "region": "eu"}),
]

QUERIES = [
    {},
    {"after": 20},
    {"before": 30},
    {"after": 20, "before": 40},
    {"tags": {"region": "eu"}},
    {"tags": {"dataset": "orders", "region": "eu"}, "after": 15},
    {"tags": {"region": "apac"}},
    {"analyzers": "mean-size"},
    {"analyzers": "none", "before": 25},
]


def _query(loader, q, P):
    if "after" in q:
        loader = loader.after(q["after"])
    if "before" in q:
        loader = loader.before(q["before"])
    if "tags" in q:
        loader = loader.with_tag_values(q["tags"])
    if q.get("analyzers") == "mean-size":
        loader = loader.for_analyzers([P.Mean("x"), P.Size()])
    elif q.get("analyzers") == "none":
        loader = loader.for_analyzers([])
    return loader


def _fill(repo, mod_result, mod_key, context, reverse=False):
    for date, tags in (reversed(HISTORY) if reverse else HISTORY):
        repo.save(mod_result(mod_key.of(date, tags), context))


@pytest.mark.parametrize("kind", ["memory", "path", "mem-uri"])
def test_loader_filters_equal_the_reference(kind, both, tmp_path):
    ref, port = both
    # the port's repository holds the reference's metrics (carried
    # through the JSON), so equal queries must give equal strings
    carried = tserde.deserialize(rserde.serialize([RResult(RKey.of(0), ref)]))[0].analyzer_context
    rrepo = _repo(kind, RFs, RMem, tmp_path, "ref")
    trepo = _repo(kind, TFs, TMem, tmp_path, "port")
    _fill(rrepo, RResult, RKey, ref, reverse=True)
    _fill(trepo, TResult, TKey, carried, reverse=True)
    for q in QUERIES:
        rget = _query(rrepo.load(), q, R).get()
        tget = _query(trepo.load(), q, T).get()
        assert [r.result_key.dataset_date for r in tget] == [r.result_key.dataset_date for r in rget]
        assert tserde.serialize(tget) == rserde.serialize(rget), q
        assert _query(trepo.load(), q, T).get_success_metrics_as_json() == \
            _query(rrepo.load(), q, R).get_success_metrics_as_json(), q
    assert trepo.load_by_key(TKey.of(30, HISTORY[2][1])) is not None
    assert trepo.load_by_key(TKey.of(31, HISTORY[2][1])) is None


def test_success_metrics_as_dataframe(both):
    pd = pytest.importorskip("pandas")
    _, port = both
    repo = TMem()
    _fill(repo, TResult, TKey, port)
    frame = repo.load().after(40).get_success_metrics_as_dataframe()
    assert isinstance(frame, pd.DataFrame)
    assert set(frame["dataset_date"]) == {40, 50}
    assert len(frame) == 2 * len(port.success_metrics_as_records())


@pytest.mark.parametrize("where", ["path", "mem-uri"])
@pytest.mark.parametrize("writer", ["reference", "port"])
def test_repository_file_loads_in_the_other_package(where, writer, both, tmp_path):
    """A file written by one package's FileSystemMetricsRepository loads
    in the other's with equal metrics (and on a path, the other's save
    of the same results rewrites the same bytes)."""
    ref, port = both
    if where == "path":
        path = str(tmp_path / "metrics.json")
    else:
        # the two packages' mem:// spaces are apart: copy the blob across
        path = f"mem://{uuid.uuid4().hex}/metrics.json"
    if writer == "reference":
        w, context, rd, rmod, wmod = RFs(path), ref, TFs, tserde, rserde
        _fill(w, RResult, RKey, context)
    else:
        w, context, rd, rmod, wmod = TFs(path), port, RFs, rserde, tserde
        _fill(w, TResult, TKey, context)
    if where == "mem-uri":
        from deequ_tpu.io import storage as rstorage
        from deequ_tpu_torch.io import storage as tstorage

        src, dst = (rstorage, tstorage) if writer == "reference" else (tstorage, rstorage)
        root, _, key = path.rpartition("/")
        dst.storage_for(root).write_bytes(key, src.storage_for(root).read_bytes(key))
    reader = rd(path)
    got = reader.load().get()
    want = w.load().get()
    assert [(r.result_key.dataset_date, r.result_key.tags) for r in got] == \
        [(r.result_key.dataset_date, r.result_key.tags) for r in want]
    for g, wnt in zip(got, want):
        assert _by_repr(g.analyzer_context) == _by_repr(wnt.analyzer_context)
    assert rmod.serialize(got) == wmod.serialize(want)
    if where == "path":
        before = open(path, "rb").read()
        # the reader saves the last result again: same bytes
        reader.save(got[-1])
        assert open(path, "rb").read() == before


def test_save_replaces_the_same_key_and_appends_others(tmp_path, both):
    _, port = both
    for repo in (TMem(), TFs(str(tmp_path / "m.json")),
                 TFs(f"mem://{uuid.uuid4().hex}/m.json")):
        key = TKey.of(5, {"a": "b"})
        repo.save(TResult(key, port))
        repo.save(TResult(key, T.AnalyzerContext({})))
        repo.save(TResult(TKey.of(6), port))
        results = repo.load().get()
        assert [r.result_key.dataset_date for r in results] == [5, 6]
        assert results[0].analyzer_context.metric_map == {}


def test_corrupt_file_reads_as_empty(tmp_path):
    path = tmp_path / "metrics.json"
    path.write_text('[{"result_key": ')
    repo = TFs(str(path))
    assert repo.load().get() == []
    assert repo.load_by_key(TKey.of(1)) is None


@pytest.mark.parametrize("bad", ["mem://metrics.json", "mem:///metrics.json"])
def test_uri_without_root_is_refused(bad):
    for mod in (RFs, TFs):
        with pytest.raises(ValueError):
            mod(bad)


def test_path_naming_a_directory_is_refused(tmp_path):
    for mod in (RFs, TFs):
        with pytest.raises(ValueError):
            mod(str(tmp_path) + "/")


def test_result_key_of_sorts_tags_and_stamps_now():
    k = TKey.of(7, {"b": "2", "a": "1"})
    assert k.tags == (("a", "1"), ("b", "2")) == RKey.of(7, {"b": "2", "a": "1"}).tags
    assert k.tags_dict == {"a": "1", "b": "2"}
    now = TKey.of()
    assert abs(now.dataset_date - TKey.current_milli_time()) < 60_000
