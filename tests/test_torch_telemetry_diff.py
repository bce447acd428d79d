"""The port's telemetry against the JAX package's: one seeded
verification suite, resident and streamed, runs through both packages
with telemetry on, each into its own JSONL log.

Equal: the event names, each event kind's record keys, the span names,
the run summaries' keys, and the counter deltas of ``runner.runs``,
``engine.scans``, ``engine.data_passes``, ``engine.device_fetches``,
``checks.evaluated`` and (resident, where the widths agree)
``transfer.bytes``; in a kill-and-resume run ``engine.resumes`` and
``engine.checkpoints_written``. ``tools/obs_report.py`` and
``tools/trace_report.py`` read the port's log with exit 0 and print the
reference log's sections.

Named divergences, each asserted below as it stands:

- ``SCAN_PHASE_EXTRAS``: the port's ``scan_phases`` event carries its own
  split of the wall beside the JAX package's PhaseClock buckets
  (``resident_s``, ``scan_s``, ``fold_s``; streamed also ``pack_s`` and
  ``copy_s``).
- ``JAX_ONLY``: counters of machinery the port does not have: the plan
  cache and retraces (nothing is traced or compiled per plan). The
  plan-cache section of ``obs_report`` is therefore the reference's
  alone.
- ``LAYOUT``: counters whose bytes follow each package's own layout: the
  packed fetch (``engine.fetch_bytes``: on the CPU the port copies
  nothing), the collectors' buffers, dictionary codes (the reference
  narrows them to the dictionary's size, the port ships int32), and on
  the streamed path the wire (the port ships one row-mask byte a row and
  no codecs by default). ``transfer.bytes`` is held equal on a resident
  suite of float64 columns, whose widths agree.
"""

import json
import os

import numpy as np
import pytest

import deequ_tpu as R
from deequ_tpu import config as rconfig
from deequ_tpu import telemetry as rtelemetry
from deequ_tpu.engine.resilience import RetryPolicy as RRetryPolicy
from deequ_tpu.engine.resilience import ScanKilled as RScanKilled
from deequ_tpu.io.state_provider import ScanCheckpointer as RScanCheckpointer
from deequ_tpu.testing.faults import FaultInjectingDataset as RFaults

import deequ_tpu_torch as T
from deequ_tpu_torch import config as tconfig
from deequ_tpu_torch import telemetry as ttelemetry
from deequ_tpu_torch.engine.resilience import RetryPolicy, ScanKilled
from deequ_tpu_torch.io.state_provider import ScanCheckpointer
from deequ_tpu_torch.testing.faults import FaultInjectingDataset
from tools.obs_report import main as obs_main
from tools.trace_report import main as trace_main

MODES = {"resident": 1 << 30, "streaming": 0}
SCAN_PHASE_EXTRAS = {"resident": {"resident_s", "scan_s", "fold_s"},
                     "streaming": {"resident_s", "scan_s", "fold_s", "pack_s", "copy_s"}}
JAX_ONLY = ("engine.traces", "engine.plan_cache.")
LAYOUT = {"resident": {"engine.fetch_bytes", "engine.collector_bytes", "transfer.bytes"},
          "streaming": {"engine.fetch_bytes", "engine.collector_bytes", "transfer.bytes",
                        "engine.wire_bytes_encoded", "engine.wire_bytes_raw"}}
EQUAL_DELTAS = ("runner.runs", "engine.scans", "engine.data_passes", "engine.device_fetches",
                "checks.evaluated", "transfer.bytes")


@pytest.fixture(autouse=True)
def _cpu():
    with tconfig.configure(device="cpu"):
        yield


def _data(P, n=2048, seed=3):
    rng = np.random.default_rng(seed)
    return P.Dataset.from_pydict({
        "x": rng.normal(size=n), "y": rng.normal(size=n) * 3,
        "k": rng.integers(0, 50, n).astype(np.float64),
        "s": np.array(["a", "b", "c", "d"])[rng.integers(0, 4, n)].tolist(),
    })


def _check(P):
    return (P.Check(P.CheckLevel.ERROR, "telemetry")
            .is_complete("x").has_mean("x", lambda v: abs(v) < 1)
            .satisfies("y > 0", "positive").has_max("k", lambda v: v < 100)
            .is_unique("k").has_approx_count_distinct("s", lambda v: v > 1)
            .has_histogram_values("s", lambda h: h.number_of_bins == 4))


def _pkg(P):
    return (rtelemetry, rconfig) if P is R else (ttelemetry, tconfig)


def _run(P, path, mode, run):
    """``run()`` with ``P``'s telemetry writing to ``path``; returns the
    log's records and the process counters' deltas."""
    tel, _ = _pkg(P)
    tm = tel.get_telemetry()
    before = tm.metrics.counters_snapshot()
    tel.configure(jsonl_path=path)
    try:
        run()
    finally:
        tel.configure(jsonl_path=None)
    after = tm.metrics.counters_snapshot()
    deltas = {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}
    return tel.read_jsonl(path), deltas


def _suite(P, mode):
    _, config = _pkg(P)
    with config.configure(batch_size=256, device_cache_bytes=MODES[mode], wire_codecs=False):
        P.VerificationSuite().on_data(_data(P)).add_check(_check(P)).run()


def _shape(records):
    """(event kind -> keys, span names, run summary keys, summary counters)."""
    events, spans, keys, counters = {}, set(), set(), {}
    for r in records:
        if r["type"] == "event":
            events.setdefault(r["event"], set()).update(r)
        elif r["type"] == "span":
            spans.add(r["name"])
        elif r["type"] == "run_summary":
            keys |= set(r)
            counters = r["counters"]
    return events, spans, keys, counters


def _jax_only(name):
    return name.startswith(JAX_ONLY)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_events_spans_and_counters_match_the_reference(tmp_path, mode):
    ref, ref_deltas = _run(R, str(tmp_path / "ref.jsonl"), mode, lambda: _suite(R, mode))
    got, got_deltas = _run(T, str(tmp_path / "port.jsonl"), mode, lambda: _suite(T, mode))
    ref_events, ref_spans, ref_keys, ref_counters = _shape(ref)
    got_events, got_spans, got_keys, got_counters = _shape(got)
    assert set(got_events) == set(ref_events)
    assert "scan_phases" in got_events
    for kind, keys in ref_events.items():
        if kind == "scan_phases":
            assert got_events[kind] - keys == SCAN_PHASE_EXTRAS[mode]
            assert keys <= got_events[kind]
        else:
            assert got_events[kind] == keys, kind
    assert got_spans == ref_spans == {"run:analysis", "pass:scan"}
    assert got_keys == ref_keys
    # the listed counter deltas are equal (transfer.bytes where the
    # widths agree: resident)
    for name in EQUAL_DELTAS:
        if name in LAYOUT[mode]:
            continue
        assert got_deltas.get(name, 0) == ref_deltas.get(name, 0), name
    assert got_deltas["engine.data_passes"] == 1 and got_deltas["checks.evaluated"] == 1
    # every other counter of the run's summary is equal, but for the
    # named divergences
    ref_names = {k for k in ref_counters if not _jax_only(k)} - LAYOUT[mode]
    assert {k for k in got_counters} - LAYOUT[mode] == ref_names
    for name in ref_names:
        assert got_counters[name] == ref_counters[name], name


def _report_sections(path, capsys, *args):
    assert obs_main([path, *args]) == 0
    out = capsys.readouterr().out
    return [line.strip() for line in out.splitlines() if line.rstrip().endswith(":")]


@pytest.mark.parametrize("mode", sorted(MODES))
def test_obs_report_reads_the_port_log_section_for_section(tmp_path, capsys, mode):
    ref_path, got_path = str(tmp_path / "ref.jsonl"), str(tmp_path / "port.jsonl")
    _run(R, ref_path, mode, lambda: _suite(R, mode))
    _run(T, got_path, mode, lambda: _suite(T, mode))
    ref = _report_sections(ref_path, capsys)
    got = _report_sections(got_path, capsys)
    # the reference alone reports its plan cache
    assert got == [s for s in ref if s not in ("placement:", "plan cache per shape:")]
    assert "scan wall decomposition (1 scan(s)):" in got
    assert _report_sections(got_path, capsys, "--counters") == \
        [s for s in _report_sections(ref_path, capsys, "--counters")
         if s not in ("placement:", "plan cache per shape:")]


def test_trace_report_reads_a_traced_port_run(tmp_path, capsys):
    """The same traced run in both packages (one TraceContext each):
    ``tools/trace_report.py`` prints the same stages for both logs."""
    outputs = []
    for P in (R, T):
        tel, _ = _pkg(P)
        tm = tel.get_telemetry()
        ctx = tel.TraceContext.mint(f"diff-{P.__name__}")
        path = str(tmp_path / f"{P.__name__}.jsonl")

        def traced():
            with tm.trace_scope(ctx):
                _suite(P, "resident")
            tm.emit_span("ticket", 0.5, trace=ctx, span_id=ctx.span_id, parent_id=None)

        _run(P, path, "resident", traced)
        assert trace_main([path]) == 0
        out = capsys.readouterr().out
        stages = [line.split()[0] for line in out.splitlines()
                  if line.startswith("    ") and "%" in line]
        outputs.append(stages)
    assert outputs[1] == outputs[0]
    assert "scan" in outputs[0] and "compile" in outputs[0]


@pytest.mark.parametrize("mode", sorted(MODES))
def test_kill_and_resume_counts_as_the_reference(tmp_path, mode):
    """Killed at batch 7 with a checkpoint every 3 batches, then resumed:
    both packages count the same checkpoints, resumes and quarantines,
    and log the same checkpoint and resume events."""
    data = {"a": np.random.default_rng(0).normal(size=1000).tolist(),
            "g": (np.arange(1000) % 7).tolist()}

    def run(P, ckpt_dir):
        _, config = _pkg(P)
        Faults, Ckpt, Killed, Policy = (
            (RFaults, RScanCheckpointer, RScanKilled, RRetryPolicy) if P is R
            else (FaultInjectingDataset, ScanCheckpointer, ScanKilled, RetryPolicy))
        ds = Faults(P.Dataset.from_pydict(data), kill_at_batch=7, transient={2: 1})
        engine = P.AnalysisEngine(checkpointer=Ckpt(ckpt_dir))
        analyzers = [P.Size(), P.Mean("a"), P.Uniqueness(["g"])]
        with config.configure(batch_size=104, device_cache_bytes=MODES[mode],
                              checkpoint_every_batches=3,
                              scan_retry=Policy(max_attempts=3, sleep=lambda _s: None)):
            with pytest.raises(Killed):
                P.AnalysisRunner.do_analysis_run(ds, analyzers, engine=engine)
            ctx = P.AnalysisRunner.do_analysis_run(ds, analyzers, engine=engine)
        assert ctx.metric(P.Size()).value.get() == 1000

    results = []
    for P in (R, T):
        path = str(tmp_path / f"{P.__name__}.jsonl")
        records, deltas = _run(P, path, mode, lambda: run(P, str(tmp_path / P.__name__)))
        events = [(r["event"], r.get("batch_index")) for r in records
                  if r["type"] == "event" and r["event"] in ("scan_checkpoint", "scan_resumed")]
        results.append((events, {k: deltas.get(k, 0) for k in (
            "engine.resumes", "engine.checkpoints_written", "engine.batch_retries",
            "engine.batches_quarantined", "runner.runs")}))
    assert results[1] == results[0]
    events, counts = results[1]
    assert counts["engine.resumes"] == 1 and counts["engine.checkpoints_written"] == 3
    assert ("scan_resumed", 6) in events


def test_resident_transfer_bytes_match_where_widths_agree(tmp_path):
    """Float64 columns only, rows a multiple of the batch (the reference
    counts whole batches): the bytes a resident first run copies are
    equal, and a rerun on the resident columns copies none."""
    counts = {}
    for P in (R, T):
        _, config = _pkg(P)
        data = P.Dataset.from_pydict({c: np.random.default_rng(i).normal(size=2048)
                                      for i, c in enumerate("xyz")})
        check = P.Check(P.CheckLevel.ERROR, "f").has_min("x", lambda v: True) \
            .has_mean("y", lambda v: True).has_max("z", lambda v: True)

        def run():
            with config.configure(batch_size=256, device_cache_bytes=1 << 30):
                P.VerificationSuite().on_data(data).add_check(check).run()

        _, first = _run(P, str(tmp_path / f"{P.__name__}-1.jsonl"), "resident", run)
        _, again = _run(P, str(tmp_path / f"{P.__name__}-2.jsonl"), "resident", run)
        counts[P] = (first.get("transfer.bytes", 0), again.get("transfer.bytes", 0))
    assert counts[T] == counts[R] == (2048 * 3 * 8, 0)


def test_port_log_lines_are_plain_json(tmp_path):
    path = str(tmp_path / "port.jsonl")
    _run(T, path, "resident", lambda: _suite(T, "resident"))
    with open(path) as fh:
        lines = fh.read().splitlines()
    assert lines and all(isinstance(json.loads(line), dict) for line in lines)
    assert os.path.getsize(path) > 0
