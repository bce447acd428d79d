"""The port's parquet-table metrics repository
(``deequ_tpu_torch/repository/table.py``) against the JAX package's
``repository/table.py``, on the CPU.

Both write one parquet file of one row a save, with the same schema and
the same ``repository/serde.py`` JSON, so either package loads the
other's directory: the records one package saves, the other reloads
into results that serialize to the same string, key by key, with the
loader's filters, last-write-wins and the file-name order both apply.
The JAX package's telemetry is switched off around its runs: it saves
operational records the port's serde does not know yet.
"""

import os

import numpy as np
import pyarrow.parquet as pq
import pytest

import deequ_tpu as R
from deequ_tpu.repository import serde as rserde
from deequ_tpu.repository.base import AnalysisResult as RResult
from deequ_tpu.repository.base import ResultKey as RKey
from deequ_tpu.repository.table import TableMetricsRepository as RTable
from deequ_tpu.telemetry import get_telemetry

import deequ_tpu_torch as T
from deequ_tpu_torch import config as tconfig
from deequ_tpu_torch.repository import serde as tserde
from deequ_tpu_torch.repository.base import AnalysisResult as TResult
from deequ_tpu_torch.repository.base import ResultKey as TKey
from deequ_tpu_torch.repository.table import TableMetricsRepository as TTable
from deequ_tpu_torch.telemetry import get_telemetry as port_telemetry


@pytest.fixture(autouse=True)
def _cpu():
    # both packages' telemetry off: a saved run then carries no
    # operational records (each run's own timings)
    runtimes = (get_telemetry(), port_telemetry())
    before = [tm.enabled for tm in runtimes]
    for tm in runtimes:
        tm.configure(enabled=False)
    try:
        with tconfig.configure(device="cpu"):
            yield
    finally:
        for tm, was in zip(runtimes, before):
            tm.configure(enabled=was)


def _data(seed):
    rng = np.random.default_rng(seed)
    n = 400
    return {"x": rng.normal(5.0, 2.0, n), "i": rng.integers(0, 30, n),
            "s": [f"w{j % 7}" for j in range(n)]}


def _analyzers(P):
    return [P.Size(), P.Mean("x"), P.Maximum("i"), P.ApproxCountDistinct("s"),
            P.Histogram("s"), P.Completeness("x"), P.Mean("missing")]


def _save_days(P, Repo, Result, Key, path, days=3):
    repo = Repo(path)
    for day in range(days):
        ctx = P.AnalysisRunner.do_analysis_run(P.Dataset.from_pydict(_data(day)), _analyzers(P))
        repo.save(Result(Key.of(1_000 + day, {"env": "prod" if day % 2 else "dev"}), ctx))
    return repo


def _texts(serde, results):
    return [serde.serialize([r]) for r in results]


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_records_load_in_the_other_package(writer, tmp_path):
    path = str(tmp_path / "repo")
    if writer == "port":
        _save_days(T, TTable, TResult, TKey, path)
    else:
        _save_days(R, RTable, RResult, RKey, path)
    port, ref = TTable(path), RTable(path)
    assert len(os.listdir(path)) == 3 and all(f.endswith(".parquet") for f in os.listdir(path))
    tall, rall = port.load().get(), ref.load().get()
    assert _texts(tserde, tall) == _texts(rserde, rall)
    assert len(tall) == 3
    for day in range(3):
        tags = {"env": "prod" if day % 2 else "dev"}
        t = port.load_by_key(TKey.of(1_000 + day, tags))
        r = ref.load_by_key(RKey.of(1_000 + day, tags))
        assert tserde.serialize([t]) == rserde.serialize([r])
    assert port.load_by_key(TKey.of(999, {})) is None
    # the loader's filters read the same records
    assert _texts(tserde, port.load().after(1_001).with_tag_values({"env": "dev"}).get()) == \
        _texts(rserde, ref.load().after(1_001).with_tag_values({"env": "dev"}).get())
    assert port.load().get_success_metrics_as_json() == ref.load().get_success_metrics_as_json()


def test_same_results_write_the_same_rows(tmp_path):
    """The same result saved by each package: the rows agree column for
    column but for the write sequence, and the serialized contexts
    carry the same JSON."""
    ctx = R.AnalysisRunner.do_analysis_run(R.Dataset.from_pydict(_data(0)), _analyzers(R))
    result = RResult(RKey.of(7, {"a": "b"}), ctx)
    text = rserde.serialize([result])
    RTable(str(tmp_path / "r")).save(result)
    TTable(str(tmp_path / "t")).save(tserde.deserialize(text)[0])
    rows = {}
    for side in ("r", "t"):
        [name] = os.listdir(tmp_path / side)
        table = pq.read_table(tmp_path / side / name)
        rows[side] = table.to_pylist()[0]
        assert table.schema.names == ["result_key", "dataset_date", "tags", "seq",
                                      "serialized_context"]
    assert {k: v for k, v in rows["t"].items() if k != "seq"} == \
        {k: v for k, v in rows["r"].items() if k != "seq"}


def test_last_write_wins_across_packages(tmp_path):
    path = str(tmp_path / "repo")
    key_t, key_r = TKey.of(5, {}), RKey.of(5, {})
    first = T.AnalysisRunner.do_analysis_run(T.Dataset.from_pydict(_data(1)), [T.Size()])
    TTable(path).save(TResult(key_t, first))
    second = R.AnalysisRunner.do_analysis_run(R.Dataset.from_pydict(_data(2)), [R.Mean("x")])
    RTable(path).save(RResult(key_r, second))
    got, want = TTable(path).load_by_key(key_t), RTable(path).load_by_key(key_r)
    assert tserde.serialize([got]) == rserde.serialize([want])
    assert [type(a).__name__ for a in got.analyzer_context.metric_map] == ["Mean"]


def test_a_run_saves_through_the_suite_and_reloads(tmp_path):
    path = str(tmp_path / "suite")
    check = T.Check(T.CheckLevel.ERROR, "c").has_size(lambda n: n == 400).has_mean(
        "x", lambda m: 4.0 < m < 6.0)
    key = TKey.of(42, {"dataset": "d"})
    result = (T.VerificationSuite().on_data(T.Dataset.from_pydict(_data(3))).add_check(check)
              .use_repository(T.TableMetricsRepository(path)).save_or_append_result(key).run())
    assert result.status == T.CheckStatus.SUCCESS
    stored = RTable(path).load_by_key(RKey.of(42, {"dataset": "d"}))
    assert stored is not None
    assert tserde.serialize([TTable(path).load_by_key(key)]) == rserde.serialize([stored])
    assert tserde.serialize([TTable(path).load_by_key(key)]) == tserde.serialize(
        [TResult(key, T.AnalyzerContext(result.metrics))])


def test_half_written_and_stale_temporary_files_are_ignored(tmp_path):
    path = tmp_path / "repo"
    _save_days(T, TTable, TResult, TKey, str(path), days=1)
    (path / ".1000-x.parquet.tmp").write_bytes(b"partial")
    (path / "notes.txt").write_text("not a record")
    assert len(TTable(str(path)).load().get()) == 1
    old = path / ".old.parquet.tmp"
    old.write_bytes(b"x")
    os.utime(old, (0, 0))
    TTable(str(path))  # sweeps temporary files older than an hour
    assert not old.exists() and (path / ".1000-x.parquet.tmp").exists()
