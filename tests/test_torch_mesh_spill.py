"""The sharded spill on the port's ``dp`` mesh against the JAX package.

High-cardinality grouping plans on W ranks of CPU torch over gloo: each
rank collects (or reads) the keys of its own rows, the keys are shuffled
by ``fmix64(key) % W`` over ``all_to_all_single`` with split sizes the
ranks exchange first, and each rank counts its own key range. Counts are
equal to the JAX package's one-device and 8-device ``cpu_mesh`` runs;
entropies are within 1e-12 relative. A rank that would receive more
keys than its device budget sorts makes EVERY rank raise
``SpillOverflow``, and every rank then takes the host group-by (the
JAX package's ``tests/test_multihost.py:39`` constant-key case, which
that package can run only on a real multi-host backend).
"""

import os

import numpy as np
import pytest

import test_torch_mesh_ranks as R
from deequ_tpu_torch.testing.mesh import run_ranks
from test_torch_mesh import REL, TIMEOUT, assert_same_metrics, mesh_run, reference, spec

SPILL_SET = [spec("CountDistinct", "id"), spec("Uniqueness", "id"), spec("Distinctness", "id"),
             spec("Entropy", "id"), spec("Histogram", "id", max_detail_bins=20)]


def _paths(result):
    return [e["path"] for e in result["events"] if e.get("event") == "grouping_spill"]


@pytest.mark.parametrize("world", [2, 3])
def test_sharded_spill_equals_single_device(world, cpu_mesh):
    """``tests/test_spill.py:204``: nulls, and int64.max keys that share
    the sentinel's lane; Histogram's 20 bins (the top-k of each rank's
    candidates, ties in key order as one device takes them) are the
    one-device bins."""
    from deequ_tpu.engine import AnalysisEngine

    source = ("spill_ids", {})
    results = mesh_run(world, source, SPILL_SET)
    assert _paths(results[0]) == ["device-sort", "device-sort"]
    got = results[0]["metrics"]
    assert_same_metrics(SPILL_SET, got, reference(source, SPILL_SET))
    mesh = reference(source, SPILL_SET, AnalysisEngine(mesh=cpu_mesh))
    assert_same_metrics(SPILL_SET[:4], got[:4], mesh[:4])
    # the JAX package's mesh takes its ties in device order: the bins' counts agree
    assert sorted(got[4][1].values()) == sorted(mesh[4][1].values())
    assert got[4][2] == mesh[4][2]


@pytest.mark.parametrize("source", [("spill_persist", {}), ("spill_ids", {})],
                         ids=["dense", "sharded"])
def test_sharded_state_persists_and_reloads(source, cpu_mesh, tmp_path):
    """``tests/test_spill.py:238``: a mesh run's states persisted once
    (rank 0 writes; a sharded state is first gathered by every rank) are
    the one-device run's files byte for byte, and the JAX package
    reloads them.
    ``spill_persist``'s 2,000-value key takes the dense path, as in the
    JAX package's test; ``spill_ids`` takes the sharded spill."""
    import deequ_tpu
    import deequ_tpu_torch as dq
    from deequ_tpu.analyzers import AnalysisRunner, CountDistinct
    from deequ_tpu.engine import AnalysisEngine

    specs = [spec("CountDistinct", "id"), spec("Histogram", "id", max_detail_bins=20)]
    mesh_dir, one_dir = str(tmp_path / "mesh"), str(tmp_path / "one")
    result = mesh_run(2, source, specs, persist_dir=mesh_dir)[0]
    got = result["metrics"]
    want_path = "device-sort" if source[0] == "spill_ids" else None
    assert want_path is None or want_path in _paths(result)
    dq.AnalysisRunner.do_analysis_run(
        dq.Dataset.from_pydict(R.data_of(source)), R.make_analyzers(dq, specs),
        engine=dq.AnalysisEngine(device="cpu"),
        save_states_with=dq.FileSystemStateProvider(one_dir))
    names = sorted(f for f in os.listdir(mesh_dir) if f.startswith("state-"))
    assert names == sorted(f for f in os.listdir(one_dir) if f.startswith("state-"))
    for name in names:  # the same file, byte for byte
        with open(os.path.join(mesh_dir, name), "rb") as m, \
                open(os.path.join(one_dir, name), "rb") as o:
            assert m.read() == o.read(), name
    a = CountDistinct("id")
    reloaded = deequ_tpu.FileSystemStateProvider(mesh_dir).load(a)
    assert reloaded is not None
    assert a.compute_metric_from_state(reloaded).value.get() == got[0]
    want = AnalysisRunner.do_analysis_run(
        deequ_tpu.Dataset.from_pydict(R.data_of(source)), [a],
        engine=AnalysisEngine(mesh=cpu_mesh)).metric(a).value.get()
    assert got[0] == want


def test_sharded_spill_with_where_filter(cpu_mesh):
    """``tests/test_spill.py:259``: the where filter evaluated on each
    rank's own rows before the shuffle."""
    from deequ_tpu.engine import AnalysisEngine

    source = ("spill_where", {})
    specs = [spec("CountDistinct", "id", where="flag = 1"),
             spec("Uniqueness", "id", where="flag = 1")]
    got = mesh_run(2, source, specs)[0]["metrics"]
    assert_same_metrics(specs, got, reference(source, specs))
    assert_same_metrics(specs, got, reference(source, specs, AnalysisEngine(mesh=cpu_mesh)))


def test_meshed_joint_spill_equals_host(cpu_mesh):
    """``tests/test_spill.py:427``: a one-lane joint plan's codes shuffle
    (the ranks share the table's dictionaries) and equal the host
    group-by; MutualInformation within 1e-12."""
    from deequ_tpu.engine import AnalysisEngine

    source = ("joint_ab", {})
    budget = {"dense_grouping_budget_bytes": 1024}
    freq = run_ranks(R.rank_frequencies, 2, source, ["a", "b"], budget, timeout=TIMEOUT)
    assert freq[0] == freq[1]
    assert freq[0]["paths"] == ["device-sort-joint"]
    specs = [spec("CountDistinct", ["a", "b"]), spec("Uniqueness", ["a", "b"]),
             spec("Entropy", ["a", "b"]), spec("MutualInformation", ["a", "b"])]
    got = mesh_run(2, source, specs, opts=budget)[0]["metrics"]
    host = reference(source, specs, dense_grouping_budget_bytes=1024,
                     device_spill_grouping=False)
    assert_same_metrics(specs, got, host)
    mesh = reference(source, specs, AnalysisEngine(mesh=cpu_mesh, batch_size=24_000),
                     dense_grouping_budget_bytes=1024)
    assert_same_metrics(specs, got, mesh)
    # the groups, read on every rank, are the one-device groups
    import deequ_tpu
    from deequ_tpu.analyzers.grouping import FrequencyPlan, compute_many_frequencies

    plan = FrequencyPlan(("a", "b"), None, False)
    ref = compute_many_frequencies(deequ_tpu.Dataset.from_pydict(R.data_of(source)), [plan])[plan]
    want = {tuple(k): int(c) for k, c in zip(ref.keys.tolist(), ref.counts.tolist())}
    assert freq[0]["groups"] == want


def test_collectors_on_a_mesh_equal_the_deferred_form(cpu_mesh):
    """``tests/test_one_pass_spill.py:255``: one pass (the collectors'
    buffers shuffled at finalize) and the deferred form (one more read)
    give the same metrics, equal to the JAX package's mesh."""
    from deequ_tpu.engine import AnalysisEngine

    source = ("one_pass", {})
    specs = [spec("Size"), spec("Mean", "x"), spec("Uniqueness", ["id"]),
             spec("CountDistinct", ["id"])]
    one = mesh_run(2, source, specs, opts={"one_pass_spill": True})[0]
    per = mesh_run(2, source, specs, opts={"one_pass_spill": False})[0]
    assert one["metrics"] == per["metrics"]
    assert one["data_passes"] == 1
    assert per["data_passes"] == 2
    assert_same_metrics(specs, one["metrics"], reference(source, specs,
                                                         AnalysisEngine(mesh=cpu_mesh)))


def _write_shards(tmp_path, source, split=0.4):
    """The table as two parquet shards, 40% and 60% of its rows (the
    JAX package's examples split them so)."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    data = R.data_of(source)
    table = pa.table(data)
    n = table.num_rows
    cut = int(n * split)
    paths = []
    for i, (off, length) in enumerate([(0, cut), (cut, n - cut)]):
        path = str(tmp_path / f"shard{i}.parquet")
        pq.write_table(table.slice(off, length), path)
        paths.append(path)
    return paths, data


def _host_groups(values):
    keys, counts = np.unique(values, return_counts=True)
    return dict(zip(keys.tolist(), counts.tolist()))


def test_cross_host_grouping_shuffle_equals_whole_table(tmp_path):
    """``tests/test_multihost.py:39``, which the JAX package marks xfail
    on the CPU: two processes, each with its own parquet shard (40/60),
    shuffle a 200,000-row high-cardinality int64 key and a float64 key;
    every count metric, the top groups and the groups read on every rank
    equal the whole-table numpy answer. The constant key sends every row
    to one rank, past its budget: ``SpillOverflow`` on BOTH ranks, and
    the host group-by, merged over the ranks, is exact."""
    source = ("cross_host", {})
    paths, data = _write_shards(tmp_path, source)
    results = run_ranks(R.rank_multihost_spill, 2, paths, ["k", "f"], timeout=TIMEOUT)
    assert results[0] == results[1]
    for column in ("k", "f"):
        want = _host_groups(data[column])
        for include_nulls in (False, True):
            got = results[0][column, include_nulls]
            assert got["type"] == "ShardedDeviceFrequencies"
            assert got["groups"] == {float(k): v for k, v in want.items()}
            assert got["num_groups"] == len(want)
            assert got["num_rows"] == len(data[column])
            assert got["unique"] == sum(1 for v in want.values() if v == 1)
            p = np.asarray(list(want.values()), dtype=np.float64) / len(data[column])
            assert got["entropy"] == pytest.approx(float(-(p * np.log(p)).sum()), rel=REL)
            # the top 12 by count, ties in the keys' u64 order (one
            # device's rule: a float key's u64 is its bits)
            def tie(key):
                return int(np.float64(key).view(np.uint64)) if column == "f" else key

            top = sorted(want.items(), key=lambda kv: (-kv[1], tie(kv[0])))[:12]
            assert got["top"] == [(float(k), v) for k, v in top]
    # the constant key: the whole table is one rank's, past its budget
    specs = [spec("CountDistinct", "c"), spec("Uniqueness", "c"), spec("Entropy", "c"),
             spec("Histogram", "c")]
    n = len(data["c"])
    opts = {"device_cache_bytes": n * 64 - 64}  # each shard fits, the whole table does not
    results = run_ranks(R.rank_analysis, 2, paths[0].rsplit("/", 1)[0], specs, opts,
                        timeout=TIMEOUT)
    assert results[0]["metrics"] == results[1]["metrics"]
    for r in results:
        assert "host-overflow" in [e["path"] for e in r["events"]
                                   if e.get("event") == "grouping_spill"]
    assert results[0]["metrics"][:3] == [1.0, 0.0, 0.0]
    assert results[0]["metrics"][3] == ("dist", {"7.5": n}, 1)


def test_receive_past_the_budget_raises_on_every_rank(tmp_path):
    """Trouble spot: ONE rank's receive count past its budget. With a
    budget that holds every rank's own rows and the uniform share but
    not a heavy key's, the planner spills, the counts exchange shows one
    rank over, and every rank raises ``SpillOverflow`` (no rank waits in
    the shuffle) and answers from the host group-by, exactly."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    rng = np.random.default_rng(13)
    n = 24_000
    ids = rng.integers(0, 10**9, n, dtype=np.int64)
    ids[rng.random(n) < 0.7] = 42  # a heavy hitter: 70% of the rows on one rank
    pq.write_table(pa.table({"id": ids[: n // 2]}), str(tmp_path / "a.parquet"))
    pq.write_table(pa.table({"id": ids[n // 2:]}), str(tmp_path / "b.parquet"))
    specs = [spec("CountDistinct", "id"), spec("Uniqueness", "id")]
    opts = {"device_cache_bytes": (n // 2) * 64 + 64}
    results = run_ranks(R.rank_analysis, 2, str(tmp_path), specs, opts, timeout=TIMEOUT)
    assert results[0]["metrics"] == results[1]["metrics"]
    for r in results:
        assert _paths(r) == ["host-overflow"]
    want = _host_groups(ids)
    assert results[0]["metrics"][0] == float(len(want))
    assert results[0]["metrics"][1] == sum(1 for v in want.values() if v == 1) / n


def test_keys_read_on_every_rank_gather_the_groups(tmp_path):
    """Trouble spot: ``keys``/``counts``/``top_groups`` of a sharded state
    are collectives every rank reaches; read so on every rank, they give
    every rank the whole table's groups, in key order."""
    source = ("spill_ids", {})
    results = run_ranks(R.rank_frequencies, 3, source, ["id"], None, timeout=TIMEOUT)
    assert results[0] == results[1] == results[2]
    assert results[0]["type"] == "ShardedDeviceFrequencies"
    ids = np.asarray([v for v in R.data_of(source)["id"] if v is not None], dtype=np.int64)
    want = _host_groups(ids)
    assert results[0]["groups"] == {(k,): v for k, v in want.items()}
    # key order: the u64 order of the keys, as one device sorts them
    keys = np.asarray([k[0] for k in results[0]["groups"]], dtype=np.int64)
    assert np.all(np.diff(keys.view(np.uint64) ^ np.uint64(1 << 63)) > 0)
