"""Process-sharded parquet on the port's ``dp`` mesh.

A mesh engine given a parquet source gives each rank its own row-group
shard (``ParquetDataset.shard_view``): the JAX package's balanced
assignment, a row count from the row groups' metadata, dictionaries of
its own and a fingerprint tagged with ``(index, count)``. The ranks
exchange their row counts before any scan; a shard of zero rows, or a
plan that one rank cannot make, raises on EVERY rank. States keyed by
values (HLL registers, DataType counts, sums) merge as they are; a
string grouping's counts, keyed by each shard's own codes, are decoded
on their rank and merged by value, so the result is the whole table's.
"""

import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import test_torch_mesh_ranks as R
from deequ_tpu_torch.testing.mesh import run_ranks
from test_torch_mesh import TIMEOUT, assert_same_metrics, reference, spec


@pytest.fixture(scope="module")
def pool_parquet(tmp_path_factory):
    """``tests/test_ingest_pool.py``'s four-file source: floats (one
    masked), small ints, and a string vocabulary that grows per file."""
    directory = tmp_path_factory.mktemp("meshpq")
    rng = np.random.default_rng(29)
    for i in range(4):
        n = 900 + i * 150
        vocab = np.array([f"tok{j:03d}" for j in range((i + 1) * 5)])
        flat = np.array(["red", "green", "blue"])
        x = rng.normal(0.0, 1.0, n)
        pq.write_table(
            pa.table({
                "f": pa.array(rng.normal(50.0, 9.0, n)),
                "x": pa.array(x, pa.float64(), mask=(rng.random(n) < 0.1)),
                "k": pa.array(rng.integers(0, 120, n, dtype=np.int64)),
                "s": pa.array(vocab[rng.integers(0, len(vocab), n)]),
                "t": pa.array(flat[rng.integers(0, 3, n)]),
            }),
            os.path.join(directory, f"part-{i}.parquet"),
            row_group_size=400,
        )
    return str(directory)


POOL_SET = [spec("Size"), spec("Mean", "f"), spec("Minimum", "f"), spec("Maximum", "f"),
            spec("Completeness", "x"), spec("Mean", "x"), spec("Minimum", "k"),
            spec("Maximum", "k"), spec("ApproxCountDistinct", "s"), spec("DataType", "s"),
            spec("ApproxCountDistinct", "t"), spec("DataType", "t")]


class TestShardPlanner:
    """``tests/test_ingest_pool.py:510``."""

    def test_assignment_equals_the_reference(self, pool_parquet):
        from deequ_tpu.data.parquet import ParquetDataset as RefParquet
        from deequ_tpu_torch.data.parquet import ParquetDataset

        ours, ref = ParquetDataset(pool_parquet), RefParquet(pool_parquet)
        for count in (1, 2, 3, 4, 5):
            for index in range(count):
                a = [(f.path, [rg.id for rg in f.row_groups])
                     for f in ours.shard_row_groups(index, count)]
                b = [(f.path, [rg.id for rg in f.row_groups])
                     for f in ref.shard_row_groups(index, count)]
                assert a == b, (index, count)
                assert ours.shard_view(index, count).num_rows == \
                    ref.shard_view(index, count).num_rows

    def test_shard_views_cover_disjointly(self, pool_parquet):
        from deequ_tpu_torch.data.parquet import ParquetDataset

        full = ParquetDataset(pool_parquet)
        views = [full.shard_view(i, 4) for i in range(4)]
        assert sum(v.num_rows for v in views) == full.num_rows
        assert len({v.fingerprint() for v in views}) == 4
        assert all(v.fingerprint() != full.fingerprint() for v in views)
        seen = set()
        for i in range(3):
            for f in full.shard_row_groups(i, 3):
                for rg in f.row_groups:
                    assert (f.path, rg.id) not in seen
                    seen.add((f.path, rg.id))
        assert len(seen) == sum(f.metadata.num_row_groups for f in
                                full._source.get_fragments())

    def test_bad_index_raises(self, pool_parquet):
        from deequ_tpu_torch.data.parquet import ParquetDataset

        full = ParquetDataset(pool_parquet)
        for index, count in ((3, 3), (-1, 3), (0, 0)):
            with pytest.raises(ValueError):
                full.shard_row_groups(index, count)

    def test_shard_checkpoint_fingerprints_differ(self, pool_parquet):
        """Trouble spot: two ranks' checkpoints of one source never share
        a key, and a shard's key is its ``(index, count)`` (the same
        shard of the same files keeps it)."""
        from deequ_tpu_torch.data.parquet import ParquetDataset

        full = ParquetDataset(pool_parquet)
        prints = {(i, w): full.shard_view(i, w).fingerprint() for w in (2, 3) for i in range(w)}
        assert len(set(prints.values())) == len(prints)
        assert ParquetDataset(pool_parquet).shard_view(1, 2).fingerprint() == prints[(1, 2)]
        assert full.shard_view(0, 1).fingerprint() != full.fingerprint()


def test_mesh_bit_identity_with_process_sharded_feed(pool_parquet, cpu_mesh):
    """``tests/test_ingest_pool.py:257``: each of two ranks streams its
    shard through the ordered ingest pool (one worker or four) with the
    one-pass dictionary deltas; with ``process_sharded_ingest`` off the
    ranks split the rows instead. Every form equals the JAX package's
    one-device and mesh runs (floats within 1e-12)."""
    from deequ_tpu.engine import AnalysisEngine

    base = {"device_cache_bytes": 0, "batch_size": 512, "dict_deltas": True}
    runs = {}
    for name, extra in (("one", {"ingest_workers": 1}), ("pool", {"ingest_workers": 4}),
                        ("rows", {"ingest_workers": 4, "process_sharded_ingest": False})):
        results = run_ranks(R.rank_analysis, 2, pool_parquet, POOL_SET, {**base, **extra},
                            timeout=TIMEOUT)
        assert results[0]["metrics"] == results[1]["metrics"]
        runs[name] = results[0]["metrics"]
    assert runs["one"] == runs["pool"]
    one = reference(pool_parquet, POOL_SET, **base)
    mesh = reference(pool_parquet, POOL_SET, AnalysisEngine(mesh=cpu_mesh), **base)
    for got in runs.values():
        assert_same_metrics(POOL_SET, got, one)
        assert_same_metrics(POOL_SET, got, mesh)


MULTIHOST_SET = [spec("Size"), spec("Mean", "x"), spec("StandardDeviation", "x"),
                 spec("Completeness", "x"), spec("CountDistinct", "k"), spec("Uniqueness", "k"),
                 spec("Entropy", "s"), spec("Histogram", "s"), spec("ApproxCountDistinct", "k"),
                 spec("ApproxCountDistinct", "s"), spec("ApproxQuantile", "x", 0.5),
                 spec("DataType", "s"), spec("CustomSql", "SUM(x) / COUNT(*)")]


def _multihost_table(tmp_path):
    """``examples/multihost_profiling.py``'s table: 60,000 rows as two
    shards of 40% and 60%, plus its columns for the rank bound."""
    rng = np.random.default_rng(3)
    n = 60_000
    x = rng.normal(10.0, 2.0, n).astype(object)
    x[::11] = None
    k = rng.integers(0, 20_000, n, dtype=np.int64)
    s = rng.choice(["1", "2.5", "x", "true", "", "seven"], n)
    table = pa.table({"x": pa.array(list(x), pa.float64()), "k": k, "s": s})
    split = int(n * 0.4)
    directory = tmp_path / "multihost"
    directory.mkdir()
    for i, (off, length) in enumerate([(0, split), (split, n - split)]):
        pq.write_table(table.slice(off, length), str(directory / f"shard{i}.parquet"))
    return str(directory), np.asarray([np.nan if v is None else v for v in x], dtype=float)


def test_two_process_merge_equals_whole_table(tmp_path):
    """``tests/test_multihost.py:14``: two processes, each reading only
    its own shard of unequal size, merge their states once; every
    metric equals the whole table's."""
    from test_torch_mesh import QUANTILE_RANK_BOUND, quantile_rank

    directory, x = _multihost_table(tmp_path)
    results = run_ranks(R.rank_analysis, 2, directory, MULTIHOST_SET, timeout=TIMEOUT)
    assert results[0]["metrics"] == results[1]["metrics"]
    got = results[0]["metrics"]
    want = reference(directory, MULTIHOST_SET)
    assert_same_metrics(MULTIHOST_SET, got, want, {"x": x})
    assert abs(quantile_rank(x, got[10]) - 0.5) < QUANTILE_RANK_BOUND


def test_string_grouping_over_shards_with_different_value_sets(tmp_path):
    """Trouble spot: two shards whose string columns hold different value
    sets code them against different dictionaries. Their dense counts
    are decoded on each rank and merged by value: every grouping metric
    equals the whole table's (a sum of the two count vectors by code
    would count ``a`` and ``f`` as one value)."""
    rng = np.random.default_rng(17)
    directory = tmp_path / "strings"
    directory.mkdir()
    parts = []
    for i, vocab in enumerate((list("abcde"), list("cdefgh"))):
        n = 3_000 + 1_000 * i
        s = np.asarray(vocab, dtype=object)[rng.integers(0, len(vocab), n)]
        t = np.asarray(["x", "y"], dtype=object)[rng.integers(0, 2, n)]
        s[rng.random(n) < 0.05] = None
        parts.append(pa.table({"s": pa.array(list(s), pa.string()), "t": pa.array(list(t))}))
        pq.write_table(parts[-1], str(directory / f"part-{i}.parquet"))
    specs = [spec("CountDistinct", "s"), spec("Uniqueness", "s"), spec("Entropy", "s"),
             spec("Histogram", "s"), spec("CountDistinct", ["s", "t"]),
             spec("MutualInformation", ["s", "t"]), spec("ApproxCountDistinct", "s"),
             spec("DataType", "s")]
    results = run_ranks(R.rank_analysis, 2, str(directory), specs, timeout=TIMEOUT)
    assert results[0]["metrics"] == results[1]["metrics"]
    got = results[0]["metrics"]
    assert_same_metrics(specs, got, reference(str(directory), specs))
    whole = pa.concat_tables(parts).column("s").to_pylist()
    counts = {}
    for v in whole:
        counts["NullValue" if v is None else v] = counts.get(
            "NullValue" if v is None else v, 0) + 1
    assert got[0] == 8.0
    assert got[3] == ("dist", counts, 9)


def test_a_plan_one_rank_cannot_make_raises_on_every_rank(tmp_path):
    """Trouble spot: a where-predicate that compiles on one rank and not
    on the other (a shard's own dictionaries can decide it) leaves the
    two ranks with different scans. Both raise ``MeshPlanMismatch``,
    within the timeout, instead of one rank waiting in the merge."""
    specs = [spec("Size"), spec("Completeness", "x", where="y > 5"), spec("Mean", "x")]
    results = run_ranks(R.rank_failure, 2, ("big_numeric", {"n": 4_000}), specs, None, 1,
                        "y > 5", timeout=TIMEOUT)
    assert [r[0] for r in results] == ["MeshPlanMismatch", "MeshPlanMismatch"]


def test_a_zero_row_shard_raises_on_every_rank(tmp_path):
    """Trouble spot: three ranks over a source of two row groups; the
    rank assigned none raises, and so do the two others, with the JAX
    package's message."""
    directory = tmp_path / "two"
    directory.mkdir()
    pq.write_table(pa.table({"x": np.arange(2_000.0)}), str(directory / "a.parquet"),
                   row_group_size=1_000)
    results = run_ranks(R.rank_failure, 3, str(directory), [spec("Size")], timeout=TIMEOUT)
    for name, message in results:
        assert name == "ValueError"
        assert "a process was assigned zero rows" in message


def test_a_scan_that_fails_on_one_rank_fails_every_rank():
    """Trouble spot: an update that raises on one rank only fails that
    rank's scan; its peer, done with its own scan, learns of it at the
    exchange before the merge, and every rank's analyzers fail alike
    instead of one rank waiting in the merge."""
    specs = [spec("Size"), spec("Mean", "x"), spec("Maximum", "y")]
    results = run_ranks(R.rank_scan_fault, 2, ("big_numeric", {"n": 4_000}), specs,
                        timeout=TIMEOUT)
    assert results[0] == results[1]
    assert results[0] == [("failure", "MetricCalculationException")] * 3 or all(
        v[0] == "failure" for v in results[0])


class TestRowShare:
    """The row share a rank of an in-memory table scans
    (``Dataset.row_share``): contiguous rows, the whole table's
    dictionaries and codes, the whole table's planner answers."""

    def _table(self):
        import deequ_tpu_torch as dq

        rng = np.random.default_rng(4)
        n = 1_001
        s = np.asarray(["a", "b", "c", None], dtype=object)[rng.integers(0, 4, n)]
        return dq.Dataset.from_pydict({"s": list(s), "k": rng.integers(0, 10_000, n)}), n

    def test_shares_cover_the_rows_in_order(self):
        from deequ_tpu_torch.data.table import ColumnRequest

        table, n = self._table()
        shares = [table.row_share(i, 3) for i in range(3)]
        assert [s.num_rows for s in shares] == [333, 334, 334]
        for c in ("k",):
            whole = table.materialize(ColumnRequest(c, "values"))
            parts = np.concatenate([s.materialize(ColumnRequest(c, "values")) for s in shares])
            assert np.array_equal(parts, whole)
        assert all(s.mesh_share == ("rows", i, 3) for i, s in enumerate(shares))
        assert len({s.fingerprint() for s in shares} | {table.fingerprint()}) == 4

    def test_codes_and_dictionaries_are_the_tables(self):
        from deequ_tpu_torch.data.table import ColumnRequest

        table, n = self._table()
        share = table.row_share(1, 2)
        lo = n // 2
        for c in ("s", "k"):  # a string column, and a numeric one encoded on demand
            assert share.dictionary(c) is table.dictionary(c)
            assert np.array_equal(share.materialize(ColumnRequest(c, "codes")),
                                  table.materialize(ColumnRequest(c, "codes"))[lo:])
        assert share.integral_range("k") == table.integral_range("k")
        assert share.shared_dictionaries

    def test_bad_rank_raises(self):
        table, _ = self._table()
        for index, count in ((2, 2), (-1, 2), (0, 0)):
            with pytest.raises(ValueError):
                table.row_share(index, count)
