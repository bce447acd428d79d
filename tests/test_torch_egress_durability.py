"""Exactly-once row-level egress of the port under process death
(``tests/test_egress_durability.py``'s ``TestKillPointDifferential`` and
``TestDeferredSpoolDurability``, through ``IsolatedRunner``).

A child that ``engine/subproc.py::IsolatedRunner`` spawns runs the port's
sink scan with a checkpointer (``batch_size`` 104, a checkpoint every 3
batches, CPU) and dies by ``testing/faults.py::hard_crash`` (SIGKILL) at
one of the design's kill points:

- ``mid_span``: producing batch 7, with rows in the OPEN span past the
  last cursor;
- ``post_flush_pre_cursor``: in the second checkpoint's save, after its
  span segment was published and before the cursor naming it was saved;
- ``mid_finalize``: in compaction, after the first segment went into the
  public split.

The runner relaunches the child, which resumes on the same ``out_dir``
and checkpoint (one crash, classified SIGKILL, then a crash resume): no row
is written twice (``engine.egress_rows_replayed`` 0 where the scan
resumed; a crash in finalize comes after the scan cleared its
checkpoint, so that run starts fresh), every row is written once, the
split is byte-identical to the port's uninterrupted run and to the JAX
package's, the manifests are equal, and ``spans/`` and
``_scan_bits.spool`` are gone. Each kill costs one crash across the two
children (a token file). Every test writes under ``tmp_path``.
"""

import json
import multiprocessing
import os
import signal

import pyarrow.parquet as pq
import pytest

from deequ_tpu_torch import config as tconfig
from deequ_tpu_torch.engine.subproc import IsolatedRunner, checkpoint_progress_probe
from deequ_tpu_torch.telemetry import get_telemetry

import test_torch_mesh_ranks as ranks

KILLS = ["mid_span", "post_flush_pre_cursor", "mid_finalize"]
MODES = {"resident": 1 << 30, "streaming": 0}
# seconds a child may take
CHILD_TIMEOUT = 240


@pytest.fixture(autouse=True)
def _cpu_and_reaped():
    with tconfig.configure(device="cpu"):
        yield
    assert multiprocessing.active_children() == []


def _checks(P, deferred=False):
    check = (
        P.Check(P.CheckLevel.ERROR, "durable egress")
        .is_complete("s")
        .satisfies("v < 90", "v_small")
        .where("v >= 10")
        .has_pattern("s", r"@ex\.com$")
    )
    checks = [check]
    if deferred:
        checks.append(P.Check(P.CheckLevel.WARNING, "deferred").is_unique("u"))
    return checks


def _crash_once(token):
    """One SIGKILL across the children: a marker file is fsync'd first,
    so the next child sees the crash was paid."""
    from deequ_tpu_torch.testing.faults import hard_crash

    if token is None or os.path.exists(token):
        return
    with open(token, "x", encoding="utf-8") as fh:
        fh.write("crashed\n")
        fh.flush()
        os.fsync(fh.fileno())
    hard_crash(signal.SIGKILL)


def _sink_scan(payload):
    """One sink-carrying verification run of the port in this process,
    with the payload's kill point armed; the report's counters and the
    engine's resume."""
    import deequ_tpu_torch as T
    from deequ_tpu_torch import config
    from deequ_tpu_torch.egress import RowLevelSink
    from deequ_tpu_torch.egress import writer as writer_mod
    from deequ_tpu_torch.io import state_provider
    from deequ_tpu_torch.testing.faults import FaultInjectingDataset

    ds = T.Dataset.from_pydict(ranks.egress_data())
    token = payload.get("token")
    kill = payload.get("kill")
    if kill == "mid_span":
        ds = FaultInjectingDataset(ds, crash_at_batch=7, crash_token_path=token,
                                   crash_signum=signal.SIGKILL)
    if kill == "post_flush_pre_cursor":
        real_save = state_provider.ScanCheckpointer.save
        calls = {"n": 0}

        def crashing_save(self, *args, **kwargs):
            calls["n"] += 1
            if calls["n"] == 2:
                _crash_once(token)
            return real_save(self, *args, **kwargs)

        state_provider.ScanCheckpointer.save = crashing_save
    if kill == "mid_finalize":
        real_read = writer_mod.QuarantineWriter._read_segment_payload
        calls = {"n": 0}

        def crashing_read(self, *args, **kwargs):
            calls["n"] += 1
            if calls["n"] == 2:
                _crash_once(token)
            return real_read(self, *args, **kwargs)

        writer_mod.QuarantineWriter._read_segment_payload = crashing_read

    engine = T.AnalysisEngine(
        device="cpu", checkpointer=state_provider.ScanCheckpointer(payload["ckpt"]))
    with config.configure(batch_size=104, checkpoint_every_batches=3,
                          device_cache_bytes=payload["budget"]):
        result = T.VerificationSuite.do_verification_run(
            ds, _checks(T, payload.get("deferred", False)), engine=engine,
            row_level_sink=RowLevelSink(payload["out"], tenant="acme", run_id="r1"))
    report = result.row_level_egress
    return {
        "status": report.status,
        "rows_total": report.rows_total,
        "rows_clean": report.rows_clean,
        "rows_quarantined": report.rows_quarantined,
        "rows_replayed": engine.egress_rows_replayed,
        "resumed_at": engine.resumed_at,
    }


def _split_bytes(out_dir):
    out = {}
    for split in ("clean", "quarantine"):
        with open(os.path.join(out_dir, split, "part-00000.parquet"), "rb") as fh:
            out[split] = fh.read()
    return out


def _manifest(out_dir):
    with open(os.path.join(out_dir, "manifest.json"), encoding="utf-8") as fh:
        payload = json.load(fh)
    payload.pop("clean", None)
    payload.pop("quarantine", None)
    return payload


def _assert_exactly_once(out_dir, rows_total):
    indexes = []
    for split in ("clean", "quarantine"):
        table = pq.read_table(os.path.join(out_dir, split, "part-00000.parquet"),
                              columns=["__row_index__"])
        indexes.extend(table.column("__row_index__").to_pylist())
    assert len(indexes) == len(set(indexes)), "a row was written twice"
    assert sorted(indexes) == list(range(rows_total))


def _reference_split(tmp_path, budget, deferred=False):
    """The JAX package's uninterrupted run with the same checkpointer."""
    import deequ_tpu as R
    from deequ_tpu import config as rconfig
    from deequ_tpu.egress import RowLevelSink as RSink
    from deequ_tpu.io.state_provider import ScanCheckpointer as RScanCheckpointer

    out = str(tmp_path / "reference")
    with rconfig.configure(batch_size=104, checkpoint_every_batches=3,
                           device_cache_bytes=budget):
        R.VerificationSuite.do_verification_run(
            R.Dataset.from_pydict(ranks.egress_data()), _checks(R, deferred),
            engine=R.AnalysisEngine(checkpointer=RScanCheckpointer(str(tmp_path / "ref-ckpt"))),
            row_level_sink=RSink(out, tenant="acme", run_id="r1"))
    return out


def _kill_and_resume(tmp_path, mode, kill, deferred=False):
    budget = MODES[mode]
    whole_out = str(tmp_path / "whole")
    whole = _sink_scan({"budget": budget, "ckpt": str(tmp_path / "whole-ckpt"),
                        "out": whole_out, "deferred": deferred})
    assert whole["status"] == "complete" and whole["rows_quarantined"] > 0
    payload = {"budget": budget, "ckpt": str(tmp_path / "ckpt"), "out": str(tmp_path / "out"),
               "deferred": deferred, "kill": kill, "token": str(tmp_path / "crash-token")}
    tm = get_telemetry()
    crashes = tm.counter("engine.child_crashes").value
    resumes = tm.counter("engine.crash_resumes").value
    runner = IsolatedRunner(key=f"egress:{mode}:{kill}", max_relaunches=3,
                            timeout_s=CHILD_TIMEOUT,
                            progress_probe=checkpoint_progress_probe(payload["ckpt"]),
                            use_breaker=False)
    with tm.run("egress-kill") as cap:
        got = runner.run(_sink_scan, payload)
    # the kill happened (SIGKILL), and one relaunch finished the run
    assert tm.counter("engine.child_crashes").value - crashes == 1
    assert tm.counter("engine.crash_resumes").value - resumes == 1
    crashed = [e for e in cap.final["events"] if e["event"] == "child_crashed"]
    assert [(e["signal"], e["exitcode"]) for e in crashed] == [("SIGKILL", -signal.SIGKILL)]
    assert got["status"] == "complete"
    for key in ("rows_total", "rows_clean", "rows_quarantined"):
        assert got[key] == whole[key]
    out = payload["out"]
    assert _split_bytes(out) == _split_bytes(whole_out)
    assert _split_bytes(out) == _split_bytes(_reference_split(tmp_path, budget, deferred))
    assert _manifest(out) == _manifest(whole_out)
    _assert_exactly_once(out, got["rows_total"])
    assert not os.path.exists(os.path.join(out, "spans"))
    assert not os.path.exists(os.path.join(out, "_scan_bits.spool"))
    return got


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("kill", KILLS)
def test_kill_then_resume_byte_identical(tmp_path, mode, kill):
    got = _kill_and_resume(tmp_path, mode, kill)
    if kill == "mid_finalize":
        # the scan had cleared its checkpoint: the artifact starts fresh
        assert got["resumed_at"] is None and got["rows_replayed"] is None
    else:
        # a streamed scan's prefetch thread produces batch 7 ahead of the
        # scan, which may not have reached the checkpoint after batch 5
        want = {3} if kill == "post_flush_pre_cursor" else {6} if mode == "resident" else {3, 6}
        assert got["resumed_at"] in want
        assert got["rows_replayed"] == 0


def test_streaming_deferred_kill_mid_span(tmp_path):
    """The spool of a deferred family (the bit planes spilled to
    ``_scan_bits.spool``) rides the same cursor: truncated to its durable
    offset on the resume, and the deferred outcomes still match."""
    got = _kill_and_resume(tmp_path, "streaming", "mid_span", deferred=True)
    assert got["resumed_at"] in (3, 6) and got["rows_replayed"] == 0
