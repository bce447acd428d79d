"""The port's row-level egress (``deequ_tpu_torch/egress/``) against the
JAX package's (``tests/test_egress.py``'s ``TestDifferentialAgainstOracle``,
``TestDegradationFoldIn`` and ``TestPlanningAndLimits``).

The same seeded fixture (``_make_data``: 1,000 rows, ``batch_size``
104) goes through ``VerificationSuite.do_verification_run(...,
row_level_sink=...)`` in both packages, resident (``device_cache_bytes``
1 GiB) and streamed (0), in both ``filtered_row_outcome`` modes, with
the scan families alone and with the deferred Uniqueness:

- the split is byte for byte the JAX package's
  (``clean/part-00000.parquet``, ``quarantine/part-00000.parquet``), the
  manifests are equal as JSON once each ``out_dir`` is taken out, and so
  are the ``EgressReport`` fields;
- the split equals the port's own oracle (``row_level_results``) row for
  row, and each constraint's failed rows match its aggregate metric;
- ``engine.data_passes`` is 1 for a scan-only suite and 2 with a
  deferred family, as the JAX package counts them;
- a batch that ``testing/faults.py`` makes fail lands in quarantine with
  ``BATCH_QUARANTINED`` and its error class;
- a checkpointing engine composes with a sink (and a run killed in the
  process resumes with no row written twice, byte-equal);
- a sink on a mesh engine raises on every rank (2 gloo ranks).

A run whose engine has no checkpointer writes the split directly (it can
never resume); with one, it goes through span segments and compaction:
both give the same bytes, dictionary-typed columns included.
"""

import json
import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import deequ_tpu as R
from deequ_tpu import config as rconfig
from deequ_tpu.egress import RowLevelSink as RSink
from deequ_tpu.engine.resilience import RetryPolicy as RRetryPolicy
from deequ_tpu.io.state_provider import ScanCheckpointer as RScanCheckpointer
from deequ_tpu.telemetry import get_telemetry
from deequ_tpu.testing.faults import FaultInjectingDataset as RFaults

import deequ_tpu_torch as T
import test_torch_mesh_ranks as ranks
from deequ_tpu_torch import config as tconfig
from deequ_tpu_torch.egress import BATCH_QUARANTINED, RowLevelSink
from deequ_tpu_torch.engine import scan
from deequ_tpu_torch.engine.resilience import RetryPolicy, ScanKilled
from deequ_tpu_torch.io.state_provider import ScanCheckpointer
from deequ_tpu_torch.testing.faults import FaultInjectingDataset
from deequ_tpu_torch.testing.mesh import run_ranks
from deequ_tpu_torch.verification.rowlevel import row_level_results

NO_SLEEP = RetryPolicy(max_attempts=1, sleep=lambda s: None)
RNO_SLEEP = RRetryPolicy(max_attempts=1, sleep=lambda s: None)
MODES = {"resident": {"device_cache_bytes": 1 << 30}, "streaming": {"device_cache_bytes": 0}}
OUTCOMES = ["true", "null"]


@pytest.fixture(autouse=True)
def _cpu():
    with tconfig.configure(device="cpu"):
        yield
    assert scan.active_prefetch_workers() == []


def _make_data(P, n=1000, seed=7):
    return P.Dataset.from_pydict(ranks.egress_data(n, seed))


def _scan_checks(P):
    """Mask and predicate, pattern and an asserted value: every family
    that rides the scan."""
    return [
        P.Check(P.CheckLevel.ERROR, "scan families")
        .is_complete("s")
        .satisfies("v < 90", "v_small")
        .where("v >= 10")
        .has_pattern("s", r"@ex\.com$")
        .has_min("v", lambda x: x >= 0)
    ]


def _full_checks(P):
    """The scan families and Uniqueness, which is always deferred."""
    return _scan_checks(P) + [P.Check(P.CheckLevel.WARNING, "deferred").is_unique("u")]


SUITES = {"scan": _scan_checks, "full": _full_checks}


def _run(P, data, checks, out_dir, outcome="true", engine=None, columns=None, **cfg):
    sink_type = RSink if P is R else RowLevelSink
    config = rconfig if P is R else tconfig
    sink = sink_type(str(out_dir), filtered_row_outcome=outcome, columns=columns,
                     tenant="acme", run_id="r1")
    with config.configure(batch_size=104, **cfg):
        result = P.VerificationSuite.do_verification_run(data, checks, engine=engine,
                                                         row_level_sink=sink)
    return result, result.row_level_egress


def _split_bytes(out_dir):
    out = {}
    for split in ("clean", "quarantine"):
        with open(os.path.join(out_dir, split, "part-00000.parquet"), "rb") as fh:
            out[split] = fh.read()
    return out


def _manifest(out_dir):
    with open(os.path.join(out_dir, "manifest.json"), encoding="utf-8") as fh:
        text = fh.read()
    return json.loads(text.replace(str(out_dir), "<out>"))


def _report(report, out_dir):
    fields = dict(vars(report))
    for key in ("clean_dir", "quarantine_dir", "manifest_path"):
        fields[key] = fields[key].replace(str(out_dir), "<out>")
    return fields


def _read_artifact(report):
    """The split read back in source order, after checking that clean
    and quarantine partition the input."""
    clean = pq.read_table(os.path.join(report.clean_dir, "part-00000.parquet"))
    quarantine = pq.read_table(os.path.join(report.quarantine_dir, "part-00000.parquet"))
    shared = [c for c in clean.schema.names if c in set(quarantine.schema.names)]
    merged = pa.concat_tables([clean.select(shared), quarantine.select(shared)])
    order = np.argsort(np.asarray(merged.column("__row_index__").to_pylist()))
    merged = merged.take(pa.array(order))
    assert merged.column("__row_index__").to_pylist() == list(range(report.rows_total))
    return clean, quarantine, merged


def _assert_same_artifact(ref_dir, got_dir, ref_report, got_report):
    assert _split_bytes(got_dir) == _split_bytes(ref_dir)
    assert _manifest(got_dir) == _manifest(ref_dir)
    assert _report(got_report, got_dir) == _report(ref_report, ref_dir)


def _data_passes(run):
    counter = get_telemetry().counter("engine.data_passes")
    before = counter.value
    out = run()
    return out, counter.value - before


class TestDifferentialAgainstReference:
    @pytest.mark.parametrize("suite", sorted(SUITES))
    @pytest.mark.parametrize("outcome", OUTCOMES)
    @pytest.mark.parametrize("mode", sorted(MODES))
    def test_split_equals_the_reference(self, tmp_path, mode, outcome, suite):
        checks = SUITES[suite]
        (_, ref), ref_passes = _data_passes(lambda: _run(
            R, _make_data(R), checks(R), tmp_path / "ref", outcome, **MODES[mode]))
        engine = T.AnalysisEngine()
        result, got = _run(T, _make_data(T), checks(T), tmp_path / "got", outcome,
                           engine=engine, **MODES[mode])
        assert got.status == "complete"
        assert got.rows_clean + got.rows_quarantined == 1000
        assert set(got.constraints.values()) == ({"scan"} if suite == "scan"
                                                 else {"scan", "deferred"})
        _assert_same_artifact(tmp_path / "ref", tmp_path / "got", ref, got)
        assert engine.data_passes == ref_passes == (1 if suite == "scan" else 2)
        # the split equals the port's own oracle, row for row
        oracle = row_level_results(result.check_results, _make_data(T),
                                   filtered_row_outcome=outcome).table
        _, _, merged = _read_artifact(got)
        assert len(oracle.schema.names) >= 4
        for name in oracle.schema.names:
            assert merged.column(name).to_pylist() == oracle.column(name).to_pylist(), name
        assert not os.path.exists(tmp_path / "got" / "spans")
        assert not os.path.exists(tmp_path / "got" / "_scan_bits.spool")

    def test_clean_rows_pass_everything(self, tmp_path):
        result, report = _run(T, _make_data(T), _full_checks(T), tmp_path / "e",
                              **MODES["streaming"])
        clean, quarantine, _ = _read_artifact(report)
        oracle = row_level_results(result.check_results, _make_data(T)).table
        for name in oracle.schema.names:
            assert all(clean.column(name).to_pylist())
        labels = quarantine.column("__failed_constraints__").to_pylist()
        assert all(labels)
        fail_any = np.zeros(len(quarantine), dtype=bool)
        for name in oracle.schema.names:
            fail_any |= np.array([x is False for x in quarantine.column(name).to_pylist()])
        assert fail_any.all()

    @pytest.mark.parametrize("mode", sorted(MODES))
    def test_failed_row_counts_match_aggregate_metrics(self, tmp_path, mode):
        n = 1000

        def checks(P):
            return [P.Check(P.CheckLevel.ERROR, "agg").is_complete("s")
                    .satisfies("v < 90", "v_small").is_unique("u")]

        _, ref = _run(R, _make_data(R, n), checks(R), tmp_path / "ref", **MODES[mode])
        result, report = _run(T, _make_data(T, n), checks(T), tmp_path / "got", **MODES[mode])
        _assert_same_artifact(tmp_path / "ref", tmp_path / "got", ref, report)
        _, _, merged = _read_artifact(report)

        def failed(fragment):
            (name,) = [c for c in merged.schema.names if fragment in c]
            return sum(1 for x in merged.column(name).to_pylist() if x is False)

        metrics = {type(a).__name__: m.value.get() for a, m in result.metrics.items()}
        assert failed("Completeness") == n - round(metrics["Completeness"] * n)
        assert failed("v_small") == n - round(metrics["Compliance"] * n)
        assert failed("Uniqueness") == n - round(metrics["Uniqueness"] * n)

    def test_column_projection_and_provenance(self, tmp_path):
        _, ref = _run(R, _make_data(R), _scan_checks(R), tmp_path / "ref", columns=["v"],
                      **MODES["streaming"])
        _, report = _run(T, _make_data(T), _scan_checks(T), tmp_path / "got", columns=["v"],
                         **MODES["streaming"])
        _assert_same_artifact(tmp_path / "ref", tmp_path / "got", ref, report)
        clean, quarantine, _ = _read_artifact(report)
        for split in (clean, quarantine):
            names = set(split.schema.names)
            assert "v" in names and "s" not in names and "u" not in names
            assert {"__row_index__", "__batch_seq__"} <= names
        assert {"__failed_constraints__", "__error_class__", "__tenant__",
                "__run_id__"} <= set(quarantine.schema.names)
        assert "__tenant__" not in clean.schema.names
        assert set(quarantine.column("__tenant__").to_pylist()) <= {"acme"}
        assert _manifest(tmp_path / "got")["status"] == "complete"

    def test_two_runs_on_one_engine_each_write_their_own_split(self, tmp_path):
        """The sink's op holds its run's writer: nothing carries it into
        the next run."""
        engine, data = T.AnalysisEngine(), _make_data(T)
        _, first = _run(T, data, _full_checks(T), tmp_path / "a", engine=engine,
                        **MODES["resident"])
        _, second = _run(T, data, _full_checks(T), tmp_path / "b", engine=engine,
                         **MODES["resident"])
        assert first.status == second.status == "complete"
        assert _split_bytes(tmp_path / "a") == _split_bytes(tmp_path / "b")


class TestDegradationFoldIn:
    @pytest.mark.parametrize("mode", sorted(MODES))
    def test_failed_unit_lands_in_quarantine(self, tmp_path, mode):
        ref_result, ref = _run(R, RFaults(_make_data(R), permanent={3}), _scan_checks(R),
                               tmp_path / "ref", scan_retry=RNO_SLEEP, **MODES[mode])
        result, report = _run(T, FaultInjectingDataset(_make_data(T), permanent={3}),
                              _scan_checks(T), tmp_path / "got", scan_retry=NO_SLEEP,
                              **MODES[mode])
        assert report.status == "complete"
        _assert_same_artifact(tmp_path / "ref", tmp_path / "got", ref, report)
        _, quarantine, _ = _read_artifact(report)
        labels = quarantine.column("__failed_constraints__").to_pylist()
        rows = quarantine.column("__row_index__").to_pylist()
        failed_rows = [i for i, lab in zip(rows, labels) if lab == BATCH_QUARANTINED]
        assert set(failed_rows) == set(range(312, 416))
        classes = quarantine.column("__error_class__").to_pylist()
        assert {c for c, lab in zip(classes, labels) if lab == BATCH_QUARANTINED} == {
            "ValueError"}
        for name in report.constraints:
            col = quarantine.column(name).to_pylist()
            assert all(col[i] is None for i, lab in enumerate(labels)
                       if lab == BATCH_QUARANTINED)
        manifest = _manifest(tmp_path / "got")
        assert manifest["scan_failures"][0]["error_class"] == "ValueError"
        assert result.degradation is not None and ref_result.degradation is not None


def _dictionary_table(P, n=700, seed=3):
    rng = np.random.default_rng(seed)
    cats = pa.array(["Books", "Home", "Music", "Shoes"])
    codes = rng.integers(0, 4, n).astype(np.int32)
    table = pa.table({
        "cat": pa.DictionaryArray.from_arrays(pa.array(codes, mask=rng.random(n) < 0.1), cats),
        "k": rng.integers(0, 300, n),
        "x": pa.array(rng.normal(size=n), mask=rng.random(n) < 0.05),
    })
    return P.Dataset.from_arrow(table)


def _dictionary_checks(P):
    return [P.Check(P.CheckLevel.ERROR, "dict").is_complete("cat")
            .satisfies("cat = 'Books' OR x > 0", "books_or_positive")
            .has_max("x", lambda v: v < 1.5).where("cat != 'Music'")]


class TestPlanningAndLimits:
    def test_no_row_level_constraints_reports_and_skips(self, tmp_path):
        sink = RowLevelSink(str(tmp_path / "egress"))
        result = T.VerificationSuite.do_verification_run(
            _make_data(T, 100), [T.Check(T.CheckLevel.ERROR, "agg only")
                                 .has_size(lambda s: s == 100)], row_level_sink=sink)
        report = result.row_level_egress
        assert report is sink.report
        assert report.status == "no_row_level_constraints"
        assert not os.path.exists(tmp_path / "egress" / "clean")

    @pytest.mark.parametrize("mode", sorted(MODES))
    def test_checkpointer_composes_with_a_sink(self, tmp_path, mode):
        _, ref = _run(R, _make_data(R), _scan_checks(R), tmp_path / "ref",
                      engine=R.AnalysisEngine(checkpointer=RScanCheckpointer(
                          str(tmp_path / "ref-ckpt"))),
                      checkpoint_every_batches=3, **MODES[mode])
        engine = T.AnalysisEngine(checkpointer=ScanCheckpointer(str(tmp_path / "ckpt")))
        result, report = _run(T, _make_data(T), _scan_checks(T), tmp_path / "got",
                              engine=engine, checkpoint_every_batches=3, **MODES[mode])
        assert report.status == "complete"
        assert [c["batch_index"] for c in engine.checkpoints] == [3, 6, 9]
        _assert_same_artifact(tmp_path / "ref", tmp_path / "got", ref, report)
        # the segments' compaction gives what a run without checkpoints
        # writes directly
        _, direct = _run(T, _make_data(T), _scan_checks(T), tmp_path / "direct",
                         **MODES[mode])
        assert _split_bytes(tmp_path / "direct") == _split_bytes(tmp_path / "got")
        oracle = row_level_results(result.check_results, _make_data(T)).table
        _, _, merged = _read_artifact(report)
        for name in oracle.schema.names:
            assert merged.column(name).to_pylist() == oracle.column(name).to_pylist()

    @pytest.mark.parametrize("mode", sorted(MODES))
    def test_dictionary_columns_direct_and_compacted(self, tmp_path, mode):
        _, ref = _run(R, _dictionary_table(R), _dictionary_checks(R), tmp_path / "ref",
                      **MODES[mode])
        _, direct = _run(T, _dictionary_table(T), _dictionary_checks(T), tmp_path / "direct",
                         **MODES[mode])
        _assert_same_artifact(tmp_path / "ref", tmp_path / "direct", ref, direct)
        engine = T.AnalysisEngine(checkpointer=ScanCheckpointer(str(tmp_path / "ckpt")))
        _, compacted = _run(T, _dictionary_table(T), _dictionary_checks(T),
                            tmp_path / "compacted", engine=engine, checkpoint_every_batches=2,
                            **MODES[mode])
        assert len(engine.checkpoints) == 3
        assert _split_bytes(tmp_path / "compacted") == _split_bytes(tmp_path / "direct")
        assert pq.read_table(tmp_path / "direct" / "clean").schema.field("cat").type == \
            pa.dictionary(pa.int32(), pa.string())

    @pytest.mark.parametrize("suite", sorted(SUITES))
    @pytest.mark.parametrize("mode", sorted(MODES))
    def test_a_killed_run_resumes_writing_no_row_twice(self, tmp_path, mode, suite):
        """Killed in the process at batch 7 with a checkpoint every 3
        batches, resumed in a fresh engine with a fresh sink: the scan
        starts at batch 6, and the split equals an uninterrupted run's.
        The killed run's sink aborts; a spooled one (the deferred
        family) then has no spool to trust and starts fresh, as the JAX
        package's does."""
        checks = SUITES[suite]
        _, whole = _run(T, _make_data(T), checks(T), tmp_path / "whole", **MODES[mode])
        ckpt = str(tmp_path / "ckpt")
        with pytest.raises(ScanKilled):
            _run(T, FaultInjectingDataset(_make_data(T), kill_at_batch=7), checks(T),
                 tmp_path / "got", engine=T.AnalysisEngine(checkpointer=ScanCheckpointer(ckpt)),
                 checkpoint_every_batches=3, **MODES[mode])
        assert _manifest(tmp_path / "got")["status"] == "aborted"
        engine = T.AnalysisEngine(checkpointer=ScanCheckpointer(ckpt))
        _, report = _run(T, _make_data(T), checks(T), tmp_path / "got", engine=engine,
                         checkpoint_every_batches=3, **MODES[mode])
        assert report.status == "complete"
        if suite == "scan":
            assert engine.resumed_at == 6 and engine.egress_rows_replayed == 0
        else:
            assert engine.resumed_at is None and engine.egress_rows_replayed is None
        assert _split_bytes(tmp_path / "got") == _split_bytes(tmp_path / "whole")
        assert _manifest(tmp_path / "got") == _manifest(tmp_path / "whole")

    def test_bad_filtered_row_outcome_rejected(self, tmp_path):
        with pytest.raises(ValueError, match="filtered_row_outcome"):
            RowLevelSink(str(tmp_path / "e"), filtered_row_outcome="drop")

    def test_a_sink_on_a_mesh_engine_raises_on_every_rank(self, tmp_path):
        results = run_ranks(ranks.rank_row_sink, 2, str(tmp_path), timeout=120)
        assert [r["raised"] for r in results] == ["ValueError", "ValueError"]
        assert all("mesh" in r["message"] for r in results)
        assert not os.path.exists(tmp_path / "rank0")


ASSERTIONS = [
    ("ge", lambda v: v >= 0),
    ("eq", lambda v: v == 1.0),
    ("partial", lambda v: 1.0 / v > 0),
    ("abs", lambda v: abs(v) < 3),
    ("chained", lambda v: 0 < v < 5),
    ("and", lambda v: v > 0 and v < 5),
    ("constant", lambda v: True),
    ("numpy", lambda v: np.abs(v) < 3),
    ("python_float", lambda v: float(v) > 0),
]


@pytest.mark.parametrize("dtype", ["float64", "float32", "int64", "int32"])
@pytest.mark.parametrize("name,assertion", ASSERTIONS, ids=[a[0] for a in ASSERTIONS])
def test_assertions_ride_the_scan_as_the_reference_decides(name, assertion, dtype):
    """The JAX package traces an assertion to decide whether it rides the
    scan; the port calls it on a tensor. Both classify each fixture
    alike."""
    from deequ_tpu.egress.plan import _assertion_traceable as reference_traceable

    from deequ_tpu_torch.egress.plan import _assertion_traceable

    assert _assertion_traceable(assertion, np.dtype(dtype)) == reference_traceable(
        assertion, np.dtype(dtype))


def test_record_batches_hold_what_slices_of_the_table_hold():
    """``Dataset.record_batches`` converts a chunk of 2^20 rows at a
    time; its batches equal ``table``'s slices, validity bitmaps (and so
    the writer's byte counts) included, for columns with nulls only in
    one chunk."""
    n = (1 << 20) + 5000
    rng = np.random.default_rng(5)
    late = np.ma.array(rng.integers(0, 9, n), mask=np.arange(n) > n - 10)
    early = np.ma.array(rng.normal(size=n), mask=np.arange(n) < 3)
    data = T.Dataset.from_pydict({
        "late": late, "early": early, "k": np.arange(n),
        "cat": T.DictionaryColumn(np.where(np.arange(n) == 7, -1, rng.integers(0, 3, n))
                                  .astype(np.int32), np.array(["a", "b", "c"], dtype=object)),
    })
    names = ["late", "early", "k", "cat"]
    got = list(data.record_batches(names, 1 << 16))
    want = data.table.select(names).to_batches(1 << 16)
    assert [b.num_rows for b in got] == [b.num_rows for b in want]
    for a, b in zip(got, want):
        assert a.equals(b)
        for x, y in zip(a.columns, b.columns):
            assert (x.buffers()[0] is None) == (y.buffers()[0] is None)
        assert a.nbytes == b.nbytes


def test_a_killed_pool_run_resumes_writing_no_row_twice(tmp_path):
    """The engine's egress hooks on the ordered ingest pool's path: a
    parquet source streamed by two workers, killed at batch 7 with a
    checkpoint every 3 batches, resumed in a fresh ``Dataset.from_parquet``
    at batch 6 with no row written again; its split equals an
    uninterrupted pool run's, and (its bytes) the in-memory run's."""
    source = tmp_path / "source.parquet"
    pq.write_table(_make_data(T).table, source, row_group_size=208)
    opts = dict(ingest_workers=2, checkpoint_every_batches=3, **MODES["streaming"])
    _, memory = _run(T, _make_data(T), _scan_checks(T), tmp_path / "memory", **opts)
    _, whole = _run(T, T.Dataset.from_parquet(str(source)), _scan_checks(T), tmp_path / "whole",
                    **opts)
    ckpt = str(tmp_path / "ckpt")
    engine = T.AnalysisEngine(checkpointer=ScanCheckpointer(ckpt))
    with pytest.raises(ScanKilled):
        _run(T, FaultInjectingDataset(T.Dataset.from_parquet(str(source)), kill_at_batch=7),
             _scan_checks(T), tmp_path / "got", engine=engine, **opts)
    assert engine.stream_stats.pool is not None
    engine = T.AnalysisEngine(checkpointer=ScanCheckpointer(ckpt))
    _, report = _run(T, T.Dataset.from_parquet(str(source)), _scan_checks(T), tmp_path / "got",
                     engine=engine, **opts)
    assert report.status == "complete" and engine.stream_stats.pool is not None
    assert engine.resumed_at == 6 and engine.egress_rows_replayed == 0
    assert _split_bytes(tmp_path / "got") == _split_bytes(tmp_path / "whole")
    assert _split_bytes(tmp_path / "got") == _split_bytes(tmp_path / "memory")
    assert _manifest(tmp_path / "got") == _manifest(tmp_path / "whole")
    _read_artifact(report)


@pytest.mark.parametrize("suite", sorted(SUITES))
def test_a_failed_write_fails_the_run_and_leaves_no_thread(tmp_path, monkeypatch, suite):
    """The parquet writes run on background threads, and every one is
    joined whatever happens. With a deferred family the split is written
    at finalize, and a write's error is raised by the run; without one it
    is written by the scan's folds, and a write's error fails the scan:
    its metrics fail and the sink reports the split aborted, as a failed
    scan does in the JAX package."""
    import threading

    def failing_write(self, table, row_group_size=None):
        raise OSError("no space left on device")

    monkeypatch.setattr(pq.ParquetWriter, "write_table", failing_write)
    if suite == "full":
        with pytest.raises(OSError, match="no space left"):
            _run(T, _make_data(T), _full_checks(T), tmp_path / "e", **MODES["streaming"])
    else:
        result, report = _run(T, _make_data(T), _scan_checks(T), tmp_path / "e",
                              **MODES["streaming"])
        assert report.status == "aborted"
        assert all(m.value.is_failure for m in result.metrics.values())
    assert not [t for t in threading.enumerate() if t.name.startswith("deequ-egress")]


@pytest.mark.parametrize("fault", ["out of memory", "device fault"])
def test_memory_pressure_in_finalize_fails_the_run(tmp_path, monkeypatch, fault):
    """The deferred Uniqueness runs at finalize, a key partition on the
    device at a time. Memory pressure or a device fault there fails the
    run, leaving no write thread: the column is never moved to
    ``unsupported`` with its failing rows published as clean."""
    import threading

    import torch

    from deequ_tpu_torch.verification import rowlevel

    error = (torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2 GiB")
             if fault == "out of memory"
             else RuntimeError("CUDA error: an illegal memory access was encountered"))

    def failing(*args, **kwargs):
        raise error

    monkeypatch.setattr(rowlevel, "_group_ids", failing)
    with pytest.raises(RuntimeError, match="CUDA"):
        _run(T, _make_data(T), _full_checks(T), tmp_path / "e", **MODES["streaming"])
    assert not [t for t in threading.enumerate() if t.name.startswith("deequ-egress")]
    assert not os.path.exists(tmp_path / "e" / "manifest.json")


# -- telemetry ------------------------------------------------------------------------


def _egress_counts(summary):
    names = ("engine.rows_clean", "engine.rows_quarantined", "engine.egress_bytes_encoded",
             "engine.egress_bytes_raw", "engine.egress_spans_flushed",
             "engine.egress_segments_compacted", "engine.egress_rows_replayed",
             "engine.data_passes")
    return {n: summary["counters"].get(n, 0) for n in names}


class TestEgressTelemetry:
    """The sink's counters and its ``rowlevel_egress`` event, against the
    JAX package's; a resumed run's ``egress_resumed`` event and its 0
    rows written again."""

    @pytest.mark.parametrize("suite", sorted(SUITES))
    @pytest.mark.parametrize("mode", sorted(MODES))
    def test_counters_and_event_equal_the_reference(self, tmp_path, mode, suite):
        from deequ_tpu_torch.telemetry import get_telemetry as port_telemetry

        checks = SUITES[suite]
        with get_telemetry().run("egress") as rcap:
            _run(R, _make_data(R), checks(R), tmp_path / "ref", **MODES[mode])
        with port_telemetry().run("egress") as cap:
            _, report = _run(T, _make_data(T), checks(T), tmp_path / "got", **MODES[mode])
        got = _egress_counts(cap.final)
        want = _egress_counts(rcap.final)
        # the JAX package always writes through span segments; the port
        # writes a run that cannot resume directly (named divergence)
        for name in ("engine.egress_spans_flushed", "engine.egress_segments_compacted"):
            assert want.pop(name) >= 1 and got.pop(name) == 0
        assert got == want
        assert got["engine.rows_clean"] + got["engine.rows_quarantined"] == 1000
        (event,) = [e for e in cap.final["events"] if e["event"] == "rowlevel_egress"]
        (ref_event,) = [e for e in rcap.final["events"] if e["event"] == "rowlevel_egress"]
        assert set(event) == set(ref_event)
        assert event["rows_quarantined"] == report.rows_quarantined

    def test_a_resumed_run_replays_no_row(self, tmp_path):
        from deequ_tpu_torch.telemetry import get_telemetry as port_telemetry

        ckpt = str(tmp_path / "ckpt")
        with pytest.raises(ScanKilled):
            _run(T, FaultInjectingDataset(_make_data(T), kill_at_batch=7), _scan_checks(T),
                 tmp_path / "got", engine=T.AnalysisEngine(checkpointer=ScanCheckpointer(ckpt)),
                 checkpoint_every_batches=3, **MODES["streaming"])
        with port_telemetry().run("resumed") as cap:
            engine = T.AnalysisEngine(checkpointer=ScanCheckpointer(ckpt))
            _run(T, _make_data(T), _scan_checks(T), tmp_path / "got", engine=engine,
                 checkpoint_every_batches=3, **MODES["streaming"])
        counters = cap.final["counters"]
        assert counters["engine.resumes"] == 1
        assert counters.get("engine.egress_rows_replayed", 0) == engine.egress_rows_replayed == 0
        assert counters["engine.egress_segments_compacted"] >= 1
        (event,) = [e for e in cap.final["events"] if e["event"] == "egress_resumed"]
        assert event["rows_replayed"] == 0 and event["span_seq"] >= 0
