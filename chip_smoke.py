#!/usr/bin/env python3
"""Smoke test of deequ_tpu_torch on one NVIDIA GPU (built for an H100).

Run from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py [--seed 0] [--rows 100000000]

or, on a machine with several cards, phase 10 alone over RANKS ranks
(NCCL, one rank a card; phases 1 and 2 and phase 10's inputs first):

    python3 chip_smoke.py --mesh-only RANKS

or phase 11 (a) over the whole table (``whole``), where the smoke runs
it over 12 batches, or (a)'s two write paths paired over 12 batches
(``pair``: direct, and through span segments):

    python3 chip_smoke.py --egress-only whole|pair

or phase 12 (crash isolation) alone, after phases 1 and 2:

    python3 chip_smoke.py --isolation-only

Phases, each of which exits non-zero when it fails:

1. device  — print the card's name and power limit (``nvidia-smi``);
2. build   — compile the CUDA kernels from ``deequ_tpu_torch/csrc`` into
             ``deequ_tpu_torch/_build`` (one ``nvcc`` per source, all
             started together) and print the compiler's report;
3. kernels — hold every kernel against its plain PyTorch version on the
             card, bit for bit, in the listed cases, and time the kernel,
             the plain version and the one library call that computes the
             same function, at the shapes the main path gives the kernel
             (the probe's, for a kernel off the main path).
             K1 has three entries: ``(idx, rho)``, timed at the probe's
             ``--prod`` shape, the fused update from raw values
             (``hll_update``), also timed against the parent's unfused
             chain, and the fused update from dictionary codes
             (``hll_update_codes``), also timed against the parent's
             presence path; one call of each entry runs under
             ``torch.cuda.set_sync_debug_mode("error")`` to show that
             none reads the device back. The probe kernels P1-P3 are
             held against theirs in every case; P1's, P2's and P3's
             plans are logged, one call of each runs under the sync
             debug mode, the host time of P2's launch path is split step
             by step, and their skip and load options are timed;
4. main    — run one VerificationSuite on a table shaped like TPC-DS
             ``store_sales`` (spec v3, section 2.3.12), generated on the
             host from ``--seed`` at 16 batches of 2^21 rows (33,554,432
             rows, or ``--rows`` when fewer: a cut of depth, for the time
             limit; no later phase reads this table), through the
             package's normal entry
             points: statistics, completeness, approximate distinct
             counts, ``where=`` filters on each group family, Compliance
             predicates, correlation and string lengths, KLL quantiles
             (filtered too), inferred types, patterns, the column count
             and the combined-completeness checks, and nine grouping
             constraints (distinct counts, distinctness, uniqueness,
             the TPC-DS primary key, a histogram, entropy, a unique-value
             ratio and mutual information), each against numpy: four
             dense plans ride the scan as scatter-adds, five spill plans
             collect their keys through it and are sorted after it.
             Check the launch counts of the K1 entries (the fused one
             four times a batch, the codes entry once, ``(idx, rho)``
             never), each grouping plan's path, one data pass and two
             fetches (the scan's states, the spill finalizes' scalars),
             HLL registers against the plain
             version over whole (filtered) columns, every metric against
             numpy, the KLL per-batch outputs of the first and the
             ragged last batch against a numpy version of the step, the
             sketches against a host replay of every batch's output,
             and each quantile's rank in the exact column against a
             stated rank-error bound; then time reruns on the resident
             columns without the filter and predicate constraints, with
             them, and with the sketch constraints too, and profile the
             first for device time by kernel, the idle share and the
             count of launches and ops (the hash's elementwise ops must
             be gone from it); then a rerun with the grouping
             constraints too, profiled (its sorts, scatters and peak
             memory), and the two forms of the spill segment count and
             of the dense scatter timed on the plans' own data. The full
             suite is rerun three times each with telemetry on (a JSONL
             log) and off, in ABBA turns: metrics bit-equal, one pass,
             two fetches and no byte copied each, the ``scan_phases``
             buckets inside the pass; once inside ``profiler_trace``,
             where every K1 launch must lie inside a ``deequ_tpu:``
             range. Telemetry's cost is that session's kernel ms,
             kernel launches and PyTorch ops against the grouping
             rerun's profile (telemetry off). The coalesced run: the
             suite split into two overlapping members, each run solo
             (``do_verification_run``), then both in ONE
             ``do_coalesced_verification_run`` on the resident columns:
             each member's metrics and check results equal its solo
             run's bit for bit, with the union's one pass, two fetches
             and K1 launches, and its wall against the solo runs'. The
             cross-dataset budget: the table's two halves (views with
             their own columns) scanned in turn after the table under a
             budget that holds one half: each scan evicts the datasets
             scanned before it, ``torch.cuda.memory_allocated`` drops
             and ``Dataset.global_device_cache_bytes`` stays within the
             budget. The phase logs its seconds by part;
5. probe   — run the scatter probe (``deequ_tpu_torch.tools
             .scatter_probe``) in-process in default mode (P1-P3 against
             the library scatter, B = 2^21) and in ``--prod`` mode (K1 at
             C = 40, B = 2^21); every variant must be bit-identical, and
             the P1-P3 and K1 ``(idx, rho)`` launches are counted from
             this run;
6. profile — free phase 4's table, then profile the full TPC-DS
             ``store_sales`` row (all 23 columns at SF100's key domains)
             with ``i_category``, ``i_item_id`` (about 102,000 ids) and
             ``ca_zip`` (five-digit strings, promoted to a number) joined
             in, ``--rows`` rows, through ``ColumnProfilerRunner``, and
             hold every field against a plain computation (the HLL
             registers against the plain build and each estimate against
             the exact count, the types and type counts and the two
             histograms by numpy, the stats by float64 reductions on the
             card over the resident columns, each of the 99 percentiles'
             ranks in an exact sort on the card within the bound of a
             replay of every batch's KLL output; each part's seconds
             logged); assert two passes, no
             third, and K1's launches against the planner's (the codes
             entry in its per-row form); rerun the profile on the
             resident columns; hold the per-row codes kernel against its
             plain version at the path's shape and time it; then run
             ``ConstraintSuggestionRunner`` with the default rules and a
             20% holdout and hold each suggested constraint's holdout
             result against numpy's evaluation of it on the same rows.
             Phases 4 and 6 run under a device budget large enough to
             keep their columns resident (``RESIDENT_BUDGET``), and assert
             that they did;
7. stream  — on phase 6's table, with its resident columns freed: (a)
             one VerificationSuite over the wide row (stats and
             completeness, one group filtered; HLL of the keys, the
             decimals, ``i_category`` and ``i_item_id``; three KLL
             quantiles; DataType and a pattern on ``ca_zip``; two
             Compliance predicates; a dense and a collector grouping
             plan), first resident under the raised budget (the oracle,
             its HLL registers held against the plain build), then
             streamed at the package's default 8 GiB budget (just under
             the estimate where a reduced ``--rows`` table fits 8 GiB),
             with codecs on, and with ``ingest_depth`` 4: each streamed
             run equals the oracle bit for bit (metrics, check results,
             every state), takes one data pass and the oracle's fetches,
             launches K1 as the planner says, leaves no device copy and no
             prefetch thread, and peaks under the budget that chose
             streaming; its wire bytes, host pack
             seconds, pinned copy rate and the unpack of one batch are
             logged; (b) the rows as four days (30%, 30%,
             30%, 10%; views of the table), each checked with its metrics
             saved to a file repository, its states to a directory and an
             anomaly check of its Size against the history: days 0-2
             pass and day 3 is flagged; the repository reloaded equals
             each day's metrics, a reuse run of day 2 reads no data, the
             four days' states aggregated equal the whole table's (Size,
             counts, min/max, HLL registers and grouping frequencies
             exact, sums and means within 1e-12, quantile ranks within
             ApproxQuantile's relative error), the same flow on a
             ``mem://`` repository stores the same records, and the
             days saved to a parquet-table repository
             (``TableMetricsRepository``) reload equal to the file
             repository's;
8. parquet — write phase 6's table as parquet files of 2^20-row row
             groups with statistics (the eleven float64 price columns as
             decimal(7,2), as TPC-DS declares them; ss_wholesale_cost as
             float32; the three joined columns as strings), after
             checking the free disk, logging the write's seconds and
             bytes, and holding one row group's decimals, read back,
             bit-equal to the in-memory cents; then stream phase 7a's
             suite over ``Dataset.from_parquet`` at 7a's budget: (a) at
             the default ``dict_delta_capacity``, where i_item_id's
             dictionary overflows with the JAX package's error; (b)
             with the capacity raised to 2^17 and one ingest thread,
             over the first quarter of the files (a cut of depth, for
             the time limit: over half of them it took 40-48 s), equal
             bit for bit to a resident run over the same rows of the
             in-memory table (7a's oracle at that depth, and (d)'s);
             (c) with the capacity raised and the ordered ingest pool,
             over every file, equal to 7a's resident oracle bit for
             bit. (b) and (c) match their oracles' metrics, check
             results and every state, take the scan and one pre-pass
             for each dictionary the plan reads, the oracle's fetches,
             launch K1 as the planner says (the codes entry in its
             per-row form at D = 2^17), peak under the budget, and
             leave no thread, device copy or whole column; their wall,
             rows/s, pinned copies, pack seconds (against 7a's one
             thread), the prefetch thread's decode seconds, the pool's
             decode and pack seconds by worker and the deltas shipped
             are logged; (d) in a child that ``engine/subproc.py::
             IsolatedRunner`` spawns (``checkpoint_progress_probe`` over
             the checkpoints), on the pool at the raised capacity over
             the first quarter of the files (a cut of depth, for the
             time limit: over half of them, killed at batch 15, it took
             85-110 s), a worker's decode of batch 2 failing once
             (retried), a checkpoint every 4 batches on the local disk
             (free disk checked first) and a SIGKILL of the child in the
             ordered commit of batch 11 (``FaultInjectingDataset``'s
             ``crash_at_batch``, once: a token file); the runner
             relaunches it and the new child resumes in a FRESH
             ``Dataset.from_parquet``: it must start at batch 8 and ship
             back, as host values and no tensor, a run equal to (b)'s
             resident run bit for bit, the retry riding the checkpoint,
             its own peak under the budget, no thread left and the
             checkpoint removed; the parent counts one crash, one
             relaunch and one crash resume, and no child is left. Each
             child's start (process and imports, CUDA context, the
             kernels' library) and each checkpoint's bytes and seconds
             are logged, and the directory removed. The files are
             removed at the end;
9. resilience — on the first 24 batches of phase 6's table (a cut of
             depth, for the time limit), 7a's suite streamed at 7a's
             budget or just under the rows' estimate
             (``testing/faults.py`` around the rows), each run held
             against a resident run over the same rows: (a) transient
             faults at batches 3 (twice), 12 and 21 (twice) and a hang
             at 15 under ``batch_stall_seconds`` = 5: equal to the
             resident run bit for bit, 6 retries, no quarantine, K1
             launched as the clean run; (b) a permanent fault at batch
             10 and a corrupt batch at 20: 2 quarantined, both error
             classes, the status Error under the default policy, equal
             to a resident run over those batches without the two; (c)
             killed at 21 with a checkpoint every 8 batches, resumed in
             a fresh engine at 16, equal to the resident run; (d)
             cancelled from batch 20's hook, partial metrics and a final
             checkpoint, resumed equal to the resident run; then over
             the whole table (e) on the resident path, a real CUDA
             OOM: the peaks of runs at B and B/2, a cap between them
             (``torch.cuda.set_per_process_memory_fraction``), and a run
             at B under it whose first update raises
             ``torch.OutOfMemoryError``, settles at B/2 and equals the
             run at B/2 bit for bit; the cap is lifted afterwards. Each
             run logs its wall, rows/s and peak (under the budget when
             it streamed), and no thread is left;
10. mesh  — print the device count and the backend chosen
             (``engine/mesh.py::choose_backend``: NCCL with one rank a
             card when there are two or more cards, gloo with both ranks
             on ``cuda:0`` on one), then spawn two ranks of a ``dp`` mesh
             (``deequ_tpu_torch.testing.mesh.run_ranks``, every rank
             killed past its timeout), each loading the kernels phase 2
             built: (a) 7a's suite over phase 8's parquet files, each
             rank streaming its own row-group shard (``shard_view``) at
             7a's budget through the ordered pool, the ranks merging
             their states once: every rank's metrics equal, and equal
             to 7a's resident oracle (integer metrics, counts, HLL
             registers, DataType counts and min/max bit for bit, float
             metrics and accumulators within the stated tolerances,
             frequency states as sets, each quantile's rank in the exact
             column within ApproxQuantile's relative error), the check
             results equal, K1 launched on each rank as the planner
             says over its shard; (b) the high-cardinality plans of
             phase 4's kind (the ticket number's distinct count and
             uniqueness, the ``(ss_item_sk, ss_ticket_number)`` key and a
             1,000-bin customer histogram) over each rank's contiguous
             rows of the same files, their keys shuffled between the
             ranks, each metric equal to numpy's. Each rank's run and
             scan seconds, device idle share under the profiler, merge
             seconds and bytes, spill exchange bytes and seconds, peak
             memory and K1 launches are logged, and the phase's wall;
11. egress — row-level egress (``deequ_tpu_torch.egress``) on phase 6's
             table, after phase 8's files are removed (free disk checked
             before each split is written, every directory removed at
             the end): (a) over the first 12 batches (a cut of depth,
             for the time limit: every row is quarantined, since 7a's
             suite holds the customer key unique, and the one quarantine
             file's parquet encoding on the host bounds the run;
             ``--egress-only whole`` runs it over the whole table), 7a's
             suite streamed at 7a's budget scaled to the rows' share (the
             whole table's budget a row) or just under the rows'
             estimate with a row-level check (a completeness on a column with about 4%
             nulls, a Compliance about 1% of rows fail, one filtered to
             Books, a pattern on ``ca_zip``, an asserted minimum, and the
             uniqueness of the TPC-DS key pair, the deferred family),
             and a ``RowLevelSink`` carrying every column with a tenant
             and a run id: the clean and quarantine ``__row_index__``
             partition the rows; each quarantined row's
             ``__failed_constraints__`` are exactly the constraints the
             port's oracle (``row_level_results_as_dataset``) fails it
             on, and no clean row fails one; each of the row-level
             check's failing counts equals numpy's (the key pair's by an
             exact sort on the card); one row group of each split, read
             back, equals the in-memory rows it names; 7a's metrics,
             check results and states equal a resident run's over the
             same rows bit for bit; two data passes, K1 launched as 7a's streamed run,
             the peak under the budget, no thread left; one batch's
             plane update runs under the sync debug mode and is timed;
             (b) over the first 12 batches, streamed, the row-level
             check's scan families and eight columns (a cut of width,
             for the time limit): an uninterrupted run, its split held
             to the oracle, numpy and the in-memory rows as (a)'s is
             (about 9% of its rows quarantined), then a run with
             a checkpoint every 4 batches killed at batch 11
             (``testing/faults.py``), resumed in a fresh engine with a
             fresh sink on the same directory: it starts at batch 8 with
             no row written again, and its split files' sha256 and its
             manifest equal the uninterrupted run's. Each run's wall,
             rows/s, the writer's seconds by part, bytes raw and
             encoded, rows clean and quarantined and segments are logged;
12. isolation — crash isolation (``engine/subproc.py``) with small
             inputs, every child spawned: (a) a child that SIGSEGVs at
             once, ``max_relaunches`` 2: ``CrashLoopError`` after two
             launches, the plan's breaker open, the next launch refused
             (``BreakerOpen``) with no child; past the cooldown (a
             ``ManualClock``) one half-open probe runs a clean child that
             launches K1's fused entry on the card (an approximate
             distinct count of 2^21 int64 rows) against the plain build,
             and the breaker closes; (b) a child whose out-of-range
             gather trips CUDA's device-side assert: the error comes
             back in-band, this process's CUDA context still runs K1
             bit-equal, and the next child runs clean; (c) a child past
             its 5 s timeout, terminated and classified. The parent's
             crash, relaunch, loop and breaker counters are held to what
             was injected, each child's start is logged, and no child is
             left.

The line before the last lists the kernels as JSON; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
package beside this script, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import math
import re
import shutil
import struct
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
SCALAR_OPS_PER_S = 67e12  # H100 SXM non-tensor 32-bit rate (data sheet)
SF100_ROWS = 287_997_024  # store_sales rows at scale factor 100
SF100_ITEMS = 204_000
SF100_CUSTOMERS = 2_000_000
SF100_STORES = 402
CATEGORIES = [
    "Books", "Children", "Electronics", "Home", "Jewelry",
    "Men", "Music", "Shoes", "Sports", "Women",
]
NULL_SHARE = 0.04
# stated tolerances of the scalar metrics against numpy float64: the
# port sums float64 columns per batch in a different order (1e-9 covers
# 2^21-row tree sums of values ~1e3); float32 columns reduce in float32
# within a batch as the JAX package does (1e-5)
RTOL_F64 = 1e-9
RTOL_F32 = 1e-5
# float64 magnitudes that round to a float32 x86 calls tiny: the KLL
# step's float32 cast flushes them to a zero of their sign, as XLA's CPU
# cast does (2^-126 - 2^-151)
FTZ_LIMIT = 2.0**-126 - 2.0**-151
BOOKS = "i_category = 'Books'"


class SmokeFailure(Exception):
    pass


def check(cond: bool, message: str) -> None:
    if not cond:
        raise SmokeFailure(message)


def log(message: str) -> None:
    print(message, flush=True)


_STARTED = time.perf_counter()
_PHASE = ["0"]  # the running phase's title, for the profiler's notes


def phase(title: str) -> None:
    """A phase's header, with the seconds since the smoke started."""
    _PHASE[0] = title
    log(f"== phase {title} (at {time.perf_counter() - _STARTED:.1f} s)")


def fmt_phases(times) -> str:
    """A scan's ``phase_times`` as text: seconds, and its mode as a word."""
    return ", ".join(f"{k} {v:.3f} s" if isinstance(v, float) else f"{k} {v}"
                     for k, v in times.items())


def device_kernels(averages):
    """A profile's device kernels: its CUDA events but the device side of
    the telemetry's ``deequ_tpu:`` ranges, which span kernels and are
    none."""
    from torch.autograd import DeviceType

    return [e for e in averages
            if e.device_type == DeviceType.CUDA and not e.key.startswith("deequ_tpu:")]


def log_empty_session(torch, prof, open_before: bool, what: str) -> None:
    """A profiling session that recorded no CUDA kernel: the phase it ran
    in, what it did record, and whether a profiler session was already
    open in this process when it started (a session left open by an
    earlier profile is the suspected cause)."""
    events = prof.key_averages()
    device = sum(e.count for e in device_kernels(events))
    log(f"profiler: an empty session in phase {_PHASE[0]} ({what}): {device} device events, "
        f"{sum(e.count for e in events)} events in all; a session was "
        f"{'already' if open_before else 'not'} open when it started, and "
        f"{'is' if torch.autograd._profiler_enabled() else 'is not'} open now")


# -- phase 1 ----------------------------------------------------------------


def device_phase(torch):
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    card = proc.stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    return card


# -- phase 2 ----------------------------------------------------------------


def build_phase():
    from deequ_tpu_torch.sketches import scatter_max
    from deequ_tpu_torch.tools import probe_kernels
    from deequ_tpu_torch.utils import cuda_build

    modules = (scatter_max, probe_kernels)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(modules)) as pool:  # one nvcc each, together
        list(pool.map(lambda m: cuda_build.build_library(m.SOURCE), modules))
    for m in modules:
        m.build()  # load the libraries just built
    seconds = time.perf_counter() - t0
    log(f"build: {', '.join(m.SOURCE.name for m in modules)} in {seconds:.2f} s")
    for m in modules:
        report = cuda_build.library_path(m.SOURCE).with_suffix(".log")
        if report.exists():
            for line in report.read_text().splitlines():
                log(f"  {line}")


# -- phase 3 ----------------------------------------------------------------


def median_ms(torch, fn, iters=30, warmup=3):
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def device_ms(torch, fn, kernel: str, iters=20):
    """Mean device time of the CUDA kernel whose name contains
    ``kernel`` over ``iters`` calls of ``fn``, from the profiler: the
    kernel's own execution, without the host time that CUDA events
    around one call of a few-microsecond kernel also take in."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    # a profiling session now and then records no device activity at all
    # in a run of the smoke: such a session is logged and run again
    for attempt in range(3):
        open_before = torch.autograd._profiler_enabled()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        hits = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and kernel in e.key]
        if hits:
            break
        log_empty_session(torch, prof, open_before,
                          f"device_ms of {kernel}, attempt {attempt + 1} of 3")
    check(bool(hits), f"the profiler saw no kernel named like {kernel}")
    return sum(e.self_device_time_total for e in hits) / sum(e.count for e in hits) / 1e3


def kernel_phase(torch):
    from deequ_tpu_torch.sketches import hll, scatter_max as sm

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1234)
    M = hll.M

    def hashed(cols, rows):
        h = torch.randint(0, 1 << 32, (2, cols, rows), generator=gen,
                          device=dev, dtype=torch.int64)
        mask = torch.rand((cols, rows), generator=gen, device=dev) < 0.96
        idx, rho = hll.index_and_rank(h[0], h[1], mask)
        return idx.contiguous(), rho.contiguous()

    def collision(cols, rows):
        idx = torch.full((cols, rows), 7, dtype=torch.int32, device=dev)
        rho = torch.randint(1, 34, (cols, rows), generator=gen, device=dev,
                            dtype=torch.int32)
        return idx, rho

    def masked(cols, rows):
        z = torch.zeros((cols, rows), dtype=torch.int32, device=dev)
        return z, z.clone()

    cases = {
        "random C=4 B=2^21": hashed(4, 1 << 21),
        "all-collision C=4 B=2^21": collision(4, 1 << 21),
        "all-masked C=4 B=2^21": masked(4, 1 << 21),
        "ragged C=4 B=2^21+12345": hashed(4, (1 << 21) + 12345),
        "ragged C=3 B=1000": hashed(3, 1000),
        "random C=40 B=2^21 (the probe's --prod shape)": hashed(40, 1 << 21),
    }
    max_err = 0
    for name, (idx, rho) in cases.items():
        got = sm.scatter_max(idx, rho, M)
        want = sm.scatter_max_plain(idx, rho, M)
        torch.cuda.synchronize()
        err = int((got - want).abs().max().item())
        max_err = max(max_err, err)
        check(torch.equal(got, want), f"kernel != plain in case {name} "
              f"(max abs err {err})")
        log(f"kernel vs plain, {name}: bit-equal")

    def timed(idx, rho):
        """(ms, plain_ms, library_ms, record arguments) at one shape,
        the device time alone logged."""
        C, B = idx.shape
        flat = (torch.arange(C, device=dev)[:, None] * M + idx.long()).reshape(-1)
        rho_flat = rho.reshape(-1)
        dev_ms = device_ms(torch, lambda: sm._launch(idx, rho, M), "hll_scatter_max_kernel")
        log(f"hll_scatter_max device time alone at C={C} B={B}: {dev_ms:.4f} ms")
        return dict(
            shape=f"C={C} B={B} M={M}",
            ms=median_ms(torch, lambda: sm._launch(idx, rho, M)),
            plain_ms=median_ms(torch, lambda: sm.scatter_max_plain(idx, rho, M)),
            library_ms=median_ms(
                torch,
                lambda: torch.zeros(C * M, dtype=torch.int32, device=dev)
                .scatter_reduce_(0, flat, rho_flat, "amax"),
            ),
            nbytes=C * B * 8 + C * M * 4, ops=C * B,
        )

    # the entry reads nothing back when the ranges hold by construction:
    # one scatter_max_derived call under the sync debug mode, which raises
    # on a synchronising call
    prod = cases["random C=40 B=2^21 (the probe's --prod shape)"]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        sm.scatter_max_derived(*prod, M)
    except RuntimeError as exc:
        raise SmokeFailure(f"scatter_max_derived synchronised with the host: {exc}") from exc
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    log("scatter_max_derived ran under set_sync_debug_mode('error'): no host sync")

    # the main path no longer reaches this entry; the probe's --prod mode
    # (phase 5) launches it at C=40, B=2^21, where its record is timed.
    # C=4, B=2^21, where numeric columns used to reach it, is logged for
    # comparison with earlier records
    stacked = timed(*cases["random C=4 B=2^21"])
    log(f"hll_scatter_max at {stacked['shape']}: kernel {stacked['ms']:.4f} ms, "
        f"plain {stacked['plain_ms']:.4f} ms, library {stacked['library_ms']:.4f} ms")
    return kernel_record(
        "hll_scatter_max", "deequ_tpu_torch/csrc/scatter_max.cu",
        "deequ_tpu/sketches/pallas_scatter.py:108", max_err=max_err, **timed(*prod),
    )


FLOAT_EDGES = [
    0.0, -0.0, float("inf"), -float("inf"), float("nan"), 1.0, -1.0,
    1e-40, -1e-40, 1.0000001e-37,  # float32-subnormal hi and residual words
    2.0**-126 * (1 - 2.0**-24), 2.0**-126 * (1 - 2.0**-25),  # either side of tiny
    1e300, -1e300,  # beyond float32: hi = +-inf, residual -+inf
    1e-50, -1e-50,  # hi rounds to +-0.0
    1e-310, -5e-324,  # float64 subnormals
    3.4028235e38, 3.4028236e38, 2.2250738585072014e-308, 2.0**53 + 1,
]
HASH_OPS_PER_ROW = 41  # four fmix32 (2 multiplies, 3 shifts, 3 xors
# each), four word xors, the index shift, clz, +1, min and the gate


def fused_kernel_phase(torch):
    """K1's fused entry (``scatter_max.hll_update``) against its plain
    version on the card, bit for bit, in every case below, each into
    zero, random and one-zero registers; one fused and one presence-path
    call under the sync debug mode; then timed at the main path's shape
    against the plain version and the parent's unfused chain."""
    from deequ_tpu_torch.sketches import hll, scatter_max as sm

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2468)
    M = hll.M
    big = 1 << 21

    def ints(dtype, cols, rows):
        lo, hi = (-(2**62), 2**62) if dtype == torch.int64 else (-(2**31), 2**31 - 1)
        x = torch.randint(lo, hi, (cols, rows), generator=gen, device=dev, dtype=dtype)
        info = torch.iinfo(dtype)
        edges = torch.tensor([info.min, info.min + 1, -1, 0, 1, info.max - 1, info.max],
                             dtype=dtype, device=dev)
        x[:, :min(rows, len(edges))] = edges[:rows]
        return x

    def floats(dtype, cols, rows):
        x = (torch.randn((cols, rows), generator=gen, device=dev, dtype=torch.float64)
             * 10.0 ** torch.randint(-8, 9, (cols, rows), generator=gen, device=dev))
        edges = torch.tensor(FLOAT_EDGES, dtype=torch.float64, device=dev)
        x[:, :min(rows, len(edges))] = edges[:rows]
        return x.to(dtype)

    def valid(cols, rows, share=0.96):
        return torch.rand((cols, rows), generator=gen, device=dev) < share

    def rows_kept(rows):
        return torch.rand(rows, generator=gen, device=dev) < 0.5

    main_values = ints(torch.int64, 4, big)
    main_mask = valid(4, big)
    cases = {
        "int64 random C=4 B=2^21 (main path)": (main_values, main_mask, None),
        "int64 C=4 B=2^21 with a row mask": (main_values, main_mask, rows_kept(big)),
        "int32 edges C=4 B=2^21": (ints(torch.int32, 4, big), valid(4, big), None),
        "float32 edges C=4 B=2^21": (floats(torch.float32, 4, big), valid(4, big), None),
        "float64 edges C=4 B=2^21": (floats(torch.float64, 4, big), valid(4, big), None),
        "one repeated value C=4 B=2^21": (
            torch.full((4, big), 42, dtype=torch.int64, device=dev), valid(4, big), None),
        "all masked C=4 B=2^21": (main_values, torch.zeros_like(main_mask), None),
        "ragged int64 C=4 B=2^21+12345": (
            ints(torch.int64, 4, big + 12345), valid(4, big + 12345), rows_kept(big + 12345)),
        "ragged float64 C=3 B=1001": (floats(torch.float64, 3, 1001), valid(3, 1001), None),
        "ragged float32 C=2 B=3": (floats(torch.float32, 2, 3), valid(2, 3), rows_kept(3)),
        "ragged int32 C=1 B=1001": (ints(torch.int32, 1, 1001), valid(1, 1001), None),
    }

    def registers(cols):
        warm = torch.randint(0, 20, (cols, M), generator=gen, device=dev, dtype=torch.int8)
        one_zero = torch.full((cols, M), 9, dtype=torch.int8, device=dev)
        one_zero[:, 1234] = 0
        return {"zero": torch.zeros((cols, M), dtype=torch.int8, device=dev),
                "random": warm, "one-zero": one_zero}

    max_err = 0
    for name, (values, mask, rows) in cases.items():
        for regs_name, regs in registers(values.shape[0]).items():
            got = sm.hll_update(values, mask, rows, regs)
            want = sm.hll_update_plain(values, mask, rows, regs)
            torch.cuda.synchronize()
            err = int((got.int() - want.int()).abs().max().item())
            max_err = max(max_err, err)
            check(torch.equal(got, want), f"hll_update != plain in case {name}, "
                  f"registers {regs_name} (max abs err {err})")
        log(f"hll_update vs plain, {name}: bit-equal (registers zero, random, one-zero)")

    # the fused entry reads nothing back: one call under the sync debug
    # mode, which raises on a synchronising call
    zero1 = torch.zeros((4, M), dtype=torch.int8, device=dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        sm.hll_update(main_values, main_mask, cases["int64 C=4 B=2^21 with a row mask"][2], zero1)
    except RuntimeError as exc:
        raise SmokeFailure(f"hll_update synchronised with the host: {exc}") from exc
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    log("hll_update ran under set_sync_debug_mode('error'): no host sync")

    # timing at the main path's shape, into the registers the main path
    # carries after its first batches (8 chained updates of fresh values)
    values, mask = main_values, main_mask
    rows = torch.ones(big, dtype=torch.bool, device=dev)  # unfiltered ROW_MASK
    carry = torch.zeros((4, M), dtype=torch.int8, device=dev)
    for k in range(8):
        carry = sm.hll_update(values + k, mask, rows, carry)
    C, B = values.shape
    zero = torch.zeros_like(carry)
    kernel = "hll_update_kernel"
    cold_dev = device_ms(torch, lambda: sm._launch_update(values, mask, rows, zero), kernel)
    warm_dev = device_ms(torch, lambda: sm._launch_update(values, mask, rows, carry), kernel)
    log(f"hll_update device time alone: {warm_dev:.4f} ms into warm registers, "
        f"{cold_dev:.4f} ms into zeroed ones (the first batch)")
    by_dtype = {name: device_ms(torch, lambda x=x: sm._launch_update(x, mask, rows, carry), kernel)
                for name, x in (("int32", values.to(torch.int32)),
                                ("float64", values.double()), ("float32", values.float()))}
    log("hll_update device time by value dtype (warm, C=4 B=2^21): int64 "
        f"{warm_dev:.4f} ms, " + ", ".join(f"{k} {v:.4f} ms" for k, v in by_dtype.items()))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    sweep = {per_sm: device_ms(torch, lambda s=per_sm * sms // C: sm._launch_update(
        values, mask, rows, carry, s), kernel) for per_sm in (1, 2, 3)}
    log("hll_update device time by blocks per SM (warm): "
        + ", ".join(f"{k}/SM {v:.4f} ms" for k, v in sweep.items()))

    def unfused():  # the parent's path: hash, rank, checked K1, maximum
        h1, h2 = hll.hash_pair_numeric(values)
        idx, rho = hll.index_and_rank(h1, h2, mask & rows[None, :])
        regs = sm.scatter_max(idx.contiguous(), rho.contiguous(), M).to(torch.int8)
        return torch.maximum(carry, regs)

    sm_cache_ab(torch, "hll_update at int64 C=4 B=2^21",
                lambda: sm.hll_update(values, mask, rows, carry))
    ms = median_ms(torch, lambda: sm.hll_update(values, mask, rows, carry))
    plain_ms = median_ms(torch, lambda: sm.hll_update_plain(values, mask, rows, carry))
    unfused_ms = median_ms(torch, unfused)
    log(f"hll_update: unfused chain of the parent (hash, rank, checked K1, "
        f"maximum) {unfused_ms:.4f} ms; no single PyTorch call hashes and "
        "scatters, so library_ms is null")
    record = kernel_record(
        "hll_update", "deequ_tpu_torch/csrc/scatter_max.cu",
        "deequ_tpu/sketches/pallas_scatter.py:108", f"int64 C={C} B={B} M={M}",
        max_err, ms, plain_ms, None,
        nbytes=C * B * (values.element_size() + 1) + B + 2 * C * M,
        ops=C * B * HASH_OPS_PER_ROW,
    )
    return record


def codes_kernel_phase(torch):
    """K1's codes entry (``scatter_max.hll_update_codes``) against its
    plain version on the card, bit for bit, at C=1 and C=3, B=2^21, for
    D = 16, 4096 (the presence cap) and 100,000 (the gather branch), with
    null codes, masked rows, a row mask, a
    ragged B and an unaligned base, each into zeroed, warm and one-zero
    registers; one call under the sync debug mode and one launch a call;
    then timed at the main path's shape (C=1, B=2^21, D=16, the batch's
    row mask) and at D=4096 against the plain version and the parent's
    path (the compare-reduce, the (idx, rho) kernel and a maximum)."""
    from deequ_tpu_torch.sketches import hll, scatter_max as sm

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1357)
    M = hll.M
    big = 1 << 21

    def unaligned_like(t):
        """A contiguous copy of ``t`` whose base lies one element off the
        allocation's (16-byte) alignment."""
        flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)
        out = flat[1:].view(t.shape)
        out.copy_(t)
        return out

    def block(cols, rows, d, null_share=0.05, masked_share=0.03):
        codes = torch.randint(0, d, (cols, rows), generator=gen, device=dev, dtype=torch.int32)
        null = torch.rand((cols, rows), generator=gen, device=dev) < null_share
        codes[null] = -1
        mask = ~null & (torch.rand((cols, rows), generator=gen, device=dev) >= masked_share)
        # pad to a power of two as the engine does: the pad slots hash as
        # 0, and no code points at them
        width = 1 << (d - 1).bit_length()
        luts = torch.zeros((2, cols, width), dtype=torch.int64, device=dev)
        luts[:, :, :d] = torch.randint(0, 1 << 32, (2, cols, d), generator=gen, device=dev)
        luts[1, :, 0] = 0  # an entry of rank 33
        return codes, mask, luts[0].contiguous(), luts[1].contiguous()

    def rows_kept(rows):
        return torch.rand(rows, generator=gen, device=dev) < 0.5

    def registers(cols):
        warm = torch.randint(0, 20, (cols, M), generator=gen, device=dev, dtype=torch.int8)
        one_zero = torch.full((cols, M), 9, dtype=torch.int8, device=dev)
        one_zero[:, 1234] = 0
        return {"zero": torch.zeros((cols, M), dtype=torch.int8, device=dev),
                "warm": warm, "one-zero": one_zero}

    cases = {}
    for d in (16, 4096, 100_000):
        for cols in (1, 3):
            codes, mask, l1, l2 = block(cols, big, d)
            cases[f"D={d} C={cols} B=2^21"] = (codes, mask, None, l1, l2)
            cases[f"D={d} C={cols} B=2^21 with a row mask"] = (codes, mask, rows_kept(big), l1, l2)
            cases[f"D={d} C={cols} B=2^21 unaligned"] = (
                unaligned_like(codes), unaligned_like(mask), None, l1, l2)
        codes, mask, l1, l2 = block(3, big + 12345, d)
        cases[f"D={d} ragged C=3 B=2^21+12345 with a row mask"] = (
            codes, mask, rows_kept(big + 12345), l1, l2)
        codes, mask, l1, l2 = block(2, 1001, d)
        cases[f"D={d} ragged C=2 B=1001"] = (codes, mask, None, l1, l2)
    codes, mask, l1, l2 = block(1, big, 16)
    cases["D=16 C=1 B=2^21 all masked"] = (codes, torch.zeros_like(mask), None, l1, l2)
    cases["D=16 C=1 B=2^21 all null"] = (torch.full_like(codes, -1), torch.zeros_like(mask),
                                         None, l1, l2)

    max_err = 0
    for name, (codes, mask, rows, l1, l2) in cases.items():
        for regs_name, regs in registers(codes.shape[0]).items():
            want = sm.hll_update_codes_plain(codes, mask, rows, l1, l2, regs)
            before = (sm.codes_launches, sm.launches, sm.fused_launches)
            got = sm.hll_update_codes(codes, mask, rows, l1, l2, regs)
            after = (sm.codes_launches, sm.launches, sm.fused_launches)
            check(after == (before[0] + 1,) + before[1:],
                  f"hll_update_codes made launches {before} -> {after} in case {name}")
            torch.cuda.synchronize()
            err = int((got.int() - want.int()).abs().max().item())
            max_err = max(max_err, err)
            check(torch.equal(got, want), f"hll_update_codes != plain in case {name}, "
                  f"registers {regs_name} (max abs err {err})")
        plan = sm.plan_codes(codes.shape[0], codes.shape[1], l1.shape[1],
                             torch.cuda.get_device_properties(dev).multi_processor_count)
        log(f"hll_update_codes vs plain, {name}: bit-equal, one launch a call "
            f"(registers zero, warm, one-zero; plan {plan})")

    # the launch path reads nothing back: one call under the sync debug mode
    codes, mask, rows, l1, l2 = cases["D=16 C=3 B=2^21 with a row mask"]
    zero3 = torch.zeros((3, M), dtype=torch.int8, device=dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        sm.hll_update_codes(codes, mask, rows, l1, l2, zero3)
    except RuntimeError as exc:
        raise SmokeFailure(f"hll_update_codes synchronised with the host: {exc}") from exc
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    log("hll_update_codes ran under set_sync_debug_mode('error'): no host sync")

    # timing at the main path's shape: i_category is one column of a
    # 16-entry (padded) dictionary, and the batch's row mask is ROW_MASK
    ones = torch.ones(big, dtype=torch.bool, device=dev)

    def parent_path(codes, mask, l1, l2, carry):
        """The parent's update: the presence compare-reduce (or gather),
        the (idx, rho) kernel, the cast and a maximum with the carry."""
        idx, rho = sm.hll_hash.code_index_and_rank(codes, mask & ones[None, :], l1, l2)
        regs = sm.scatter_max_derived(idx.contiguous(), rho.contiguous(), M)
        return torch.maximum(carry, regs.to(torch.int8))

    timed = {}
    for d in (16, 4096):
        codes, mask, _, l1, l2 = cases[f"D={d} C=1 B=2^21"]
        carry = registers(1)["warm"]
        kname = "hll_codes_bitmap_kernel"
        dev_ms = device_ms(torch, lambda: sm.hll_update_codes(codes, mask, ones, l1, l2, carry),
                           kname)
        ms = median_ms(torch, lambda: sm.hll_update_codes(codes, mask, ones, l1, l2, carry))
        plain_ms = median_ms(torch, lambda: sm.hll_update_codes_plain(
            codes, mask, ones, l1, l2, carry), iters=10 if d > 16 else 30)
        parent_ms = median_ms(torch, lambda: parent_path(codes, mask, l1, l2, carry),
                              iters=10 if d > 16 else 30)
        log(f"hll_update_codes at C=1 B=2^21 D={d} (row mask): call {ms:.4f} ms, device "
            f"{dev_ms:.4f} ms, plain {plain_ms:.4f} ms, the parent's path (compare-reduce, "
            f"(idx, rho) kernel, maximum) {parent_ms:.4f} ms; no single PyTorch call ranks "
            "and folds present entries, so library_ms is null")
        timed[d] = (codes, mask, l1, l2, carry, ms, plain_ms)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for d in (16, 4096):
        codes, mask, _, l1, l2 = cases[f"D={d} C=1 B=2^21"]
        carry = registers(1)["warm"]
        out = torch.empty_like(carry)

        def launch(splits):  # the codes library call with its blocks a column set
            err = sm._library().hll_update_codes_launch(
                codes.data_ptr(), mask.data_ptr(), ones.data_ptr(), l1.data_ptr(), l2.data_ptr(),
                carry.data_ptr(), out.data_ptr(), 1, big, d, sm.hll_hash.P, splits,
                torch.cuda.current_stream().cuda_stream)
            check(err == 0, f"hll_update_codes launch failed ({err})")

        sweep = {per_sm: device_ms(torch, lambda s=per_sm * sms: launch(s), "hll_codes_bitmap_kernel")
                 for per_sm in (1, 2, 3, 4, 8)}
        log(f"hll_update_codes device time at C=1 B=2^21 D={d} by blocks per SM: "
            + ", ".join(f"{k}/SM {v:.4f} ms" for k, v in sweep.items()))
    codes, mask, _, l1, l2 = cases["D=100000 C=1 B=2^21"]
    carry = registers(1)["warm"]
    gather_dev = device_ms(torch, lambda: sm.hll_update_codes(codes, mask, ones, l1, l2, carry),
                           "hll_codes_rows_kernel")
    log(f"hll_update_codes device time at C=1 B=2^21 D=100000 (the gather branch's "
        f"per-row file): {gather_dev:.4f} ms")

    codes, mask, l1, l2, carry, ms, plain_ms = timed[16]
    C, B = codes.shape
    D = l1.shape[1]
    present = int(sm.hll_hash.tiled_code_presence(codes, mask, D).sum().item())
    return kernel_record(
        "hll_update_codes", "deequ_tpu_torch/csrc/scatter_max.cu",
        "deequ_tpu/sketches/pallas_scatter.py:108", f"C={C} B={B} D={D} M={M} (row mask)",
        max_err, ms, plain_ms, None,
        nbytes=C * B * 5 + B + 2 * C * M + 16 * present, ops=C * B,
    )


def sm_cache_ab(torch, label, fn):
    """``fn``'s call time (CUDA events) with the SM count queried from the
    device on every launch, as before it was cached, and cached, in the
    order before, after, after, before."""
    from deequ_tpu_torch import config

    cached = config.sm_count

    def uncached(device):
        return torch.cuda.get_device_properties(device).multi_processor_count

    times = {"before": [], "after": []}
    for when in ("before", "after", "after", "before"):
        config.sm_count = uncached if when == "before" else cached
        try:
            times[when].append(median_ms(torch, fn))
        finally:
            config.sm_count = cached
    log(f"{label}, SM count read on every launch (before) against cached (after): "
        + ", ".join(f"{k} {' / '.join(f'{t:.4f}' for t in v)} ms" for k, v in times.items()))


def kernel_record(name, source, replaces, shape, max_err, ms, plain_ms,
                  library_ms, nbytes, ops):
    """One entry of the kernels line. The bound is the larger of the
    bytes the function must move (each input read once, each output
    written once) at the HBM rate and its operations (the caller counts
    them: one compare per element for a scatter of ranks, the hash's
    32-bit operations for the fused update) at the card's 32-bit
    rate."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / SCALAR_OPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    library = "none" if library_ms is None else f"{library_ms:.4f} ms"
    log(f"{name} at {shape}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"library {library}, bound {bound_ms:.4f} ms ({nbytes} bytes at "
        f"3.35 TB/s, {ops} operations at 67 T/s)")
    return {
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": None,  # filled from the main path's run
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": library_ms,
    }


def probe_kernel_phase(torch):
    """P1-P3 against their plain versions on the card, bit for bit:
    random, all-collision, all-masked and ragged B, fewer rows than a
    cluster has blocks, unaligned packed words, zero, warm and one-zero
    registers, and files of m = 2^14, 16,383, 100 and 1 registers. Then
    one call of P1 and of P2 under the sync debug mode, the host time of
    their launch path step by step, and each kernel timed at the probe's
    shape, B = 2^21 into M = 2^14 registers."""
    from deequ_tpu_torch.sketches import hll
    from deequ_tpu_torch.tools import probe_kernels as pk

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4321)
    M = hll.M
    B = 1 << 21

    def stream(rows, m=M, kind="random"):
        idx = torch.randint(0, m, (rows,), generator=gen, device=dev, dtype=torch.int32)
        rho = (torch.empty(rows, device=dev).geometric_(0.5, generator=gen)
               .clamp_(max=33).to(torch.int32))
        if kind == "collision":
            idx.fill_(min(7, m - 1))
        elif kind == "masked":
            idx.zero_()
            rho.zero_()
        return idx, rho

    def registers(m):
        warm = torch.randint(1, 12, (m,), generator=gen, device=dev, dtype=torch.int32)
        one_zero = warm.clone()
        one_zero[min(1234, m - 1)] = 0
        return {"zero": torch.zeros(m, dtype=torch.int32, device=dev),
                "warm": warm, "one-zero": one_zero}

    cases = [
        ("random B=2^21 (probe path)", M, stream(B)),
        ("all-collision B=2^21", M, stream(B, kind="collision")),
        ("all-masked B=2^21", M, stream(B, kind="masked")),
        ("ragged B=2^21+12345", M, stream(B + 12345)),
        ("ragged B=1000", M, stream(1000)),
        ("ragged B=3", M, stream(3)),
        ("B=5, fewer rows than a cluster's blocks", M, stream(5)),
        ("m=16383 B=2^21", 16383, stream(B, 16383)),
        ("m=16383 all-collision B=1000", 16383, stream(1000, 16383, "collision")),
        ("m=100 B=2^21", 100, stream(B, 100)),
        ("m=100 B=1000", 100, stream(1000, 100)),
        ("m=1 B=2^21+12345", 1, stream(B + 12345, 1)),
        ("m=1 B=3", 1, stream(3, 1)),
    ]
    max_err = {"P1": 0, "P2": 0, "P3": 0}
    for name, m, (idx, rho) in cases:
        packed = pk.pack(idx, rho)
        unaligned = torch.cat([packed[:1], packed])[1:]  # 4 bytes off 16
        idx_off = torch.cat([idx[:1], idx])[1:]
        for regs_name, regs in registers(m).items():
            want = torch.maximum(regs, pk.two_stream_plain(idx, rho, m))
            got = {
                "P1": [pk.scatter_two_stream(regs, i, rho, skip_cold=s)
                       for i in (idx, idx_off) for s in (False, True)],
                "P2": [pk.scatter_packed(regs, w, skip_cold=s, vec=v)
                       for w in (packed, unaligned) for s in (False, True) for v in (False, True)],
                "P3": [pk.scatter_gmin(regs, w, vec=v) for w in (packed, unaligned) for v in (False, True)],
            }
            torch.cuda.synchronize()
            for kernel, outs in got.items():
                for out in outs:
                    err = int((out - want).abs().max().item())
                    max_err[kernel] = max(max_err[kernel], err)
                    check(torch.equal(out, want), f"{kernel} != plain in case {name}, "
                          f"registers {regs_name} (max abs err {err})")
        log(f"P1-P3 vs plain, {name}: bit-equal (registers zero, warm, one-zero)")

    idx, rho = cases[0][2]
    packed = pk.pack(idx, rho)
    idx64 = idx.to(torch.int64)
    regs = registers(M)
    zero, warm = regs["zero"], regs["warm"]
    for kernel, two in (("P1", True), ("P2", False)):
        index = torch.cuda.current_device()
        p = pk.plan_on(index, two, True, B, M)
        fit = pk.max_active_clusters(index, two, True)
        log(f"{kernel} plan at B={B} M={M}: cluster {pk.CLUSTER}, {p.clusters} clusters "
            f"({fit} fit at once), {p.blocks} blocks of {p.share} rows, "
            f"{1 << p.span_log2} registers a block, {pk.BLOCK_SMEM} bytes of shared memory "
            "a block, int4 loads, merge: atomic fold into a copy of regs")

    # the CUDA launch path reads nothing back: one call of each under
    # the sync debug mode, which raises on a synchronising call
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pk._launch_two_stream(zero, idx, rho, True)
        pk._launch_packed(zero, packed, True, True)
        pk._launch_gmin(warm, packed, True)
    except RuntimeError as exc:
        raise SmokeFailure(f"a probe launch synchronised with the host: {exc}") from exc
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    log("P1, P2 and P3 ran under set_sync_debug_mode('error'): no host sync")

    launch_host_split(torch, pk, zero, warm, packed)

    for name, regs_name, fn in (
        ("probe_two_stream_kernel", "zeroed", lambda: pk._launch_two_stream(zero, idx, rho, True)),
        ("probe_two_stream_kernel", "warm", lambda: pk._launch_two_stream(warm, idx, rho, True)),
        ("probe_packed_kernel", "zeroed", lambda: pk._launch_packed(zero, packed, True, True)),
        ("probe_packed_kernel", "warm", lambda: pk._launch_packed(warm, packed, True, True)),
    ):
        log(f"{name} device time alone into {regs_name} registers: "
            f"{device_ms(torch, fn, name):.4f} ms")
    one_zero = regs["one-zero"]
    for regs_name, r in (("zeroed", zero), ("warm", warm), ("one-zero", one_zero)):
        fn = lambda r=r: pk._launch_gmin(r, packed, True)  # noqa: E731
        log(f"P3 into {regs_name} registers: device "
            f"{device_ms(torch, fn, 'probe_gmin_kernel'):.4f} ms, call "
            f"{median_ms(torch, fn):.4f} ms")
    g = pk.plan_gmin_on(torch.cuda.current_device(), B, M)
    log(f"P3 plan at B={B} M={M}: cluster {pk.GMIN_CLUSTER}, {g.clusters} clusters, "
        f"{g.blocks} blocks, no shared-memory file: rows that pass go to atomics on out")
    for label, kname, fn in (
        ("P1 without the skip test", "probe_two_stream_kernel",
         lambda: pk._launch_two_stream(zero, idx, rho, False)),
        ("P2 without the skip test", "probe_packed_kernel",
         lambda: pk._launch_packed(zero, packed, False, True)),
        ("P2 with scalar loads (vec off)", "probe_packed_kernel",
         lambda: pk._launch_packed(zero, packed, True, False)),
    ):
        log(f"{label}, device time alone into zeroed registers: "
            f"{device_ms(torch, fn, kname):.4f} ms")

    def library():  # one scatter_reduce_ into a copy of the registers
        return zero.clone().scatter_reduce_(0, idx64, rho, "amax")

    shape = f"B={B} M={M}"
    records = []
    for name, source_line, kernel, launch, plain, nbytes in (
        ("probe_two_stream", "tools/scatter_probe.py:96", "P1",
         lambda r: pk._launch_two_stream(r, idx, rho, True),
         lambda: torch.maximum(zero, pk.two_stream_plain(idx, rho, M)), B * 8 + 2 * M * 4),
        ("probe_packed", "tools/scatter_probe.py:166", "P2",
         lambda r: pk._launch_packed(r, packed, True, True),
         lambda: torch.maximum(zero, pk.packed_plain(packed, M)), B * 4 + 2 * M * 4),
    ):
        log(f"{name} through its launch path into warm registers: "
            f"{median_ms(torch, lambda: launch(warm)):.4f} ms")
        records.append(kernel_record(
            name, "deequ_tpu_torch/csrc/scatter_probe.cu", source_line, shape,
            max_err[kernel], median_ms(torch, lambda: launch(zero)), median_ms(torch, plain),
            median_ms(torch, library), nbytes=nbytes, ops=B,
        ))
    records.append(kernel_record(
        "probe_gmin", "deequ_tpu_torch/csrc/scatter_probe.cu",
        "tools/scatter_probe.py:255", shape, max_err["P3"],
        median_ms(torch, lambda: pk._launch_gmin(warm, packed, True)),
        median_ms(torch, lambda: pk.gmin_plain(warm, packed)),
        median_ms(torch, lambda: torch.maximum(warm, library())),
        nbytes=B * 4 + 2 * M * 4, ops=B,
    ))
    return records


def host_us(torch, fn, n=200):
    """Host microseconds per call of ``fn``, not waiting for the device
    (the launches queue up and are drained afterwards; ``n`` stays well
    below the depth at which a full launch queue would stall the host)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds / n * 1e6


def launch_host_split(torch, pk, zero, warm, packed):
    """The host time of one P2 call, step by step (time.perf_counter
    over many calls): the whole launch path, each PyTorch call of it,
    and the calls the parent's path made around its launch."""
    from deequ_tpu_torch import config

    dev = zero.device
    m, rows = zero.shape[0], packed.shape[0]
    whole = host_us(torch, lambda: pk._launch_packed(zero, packed, True, True))
    p = pk.plan_on(dev.index, False, True, rows, m)
    stream = torch.cuda.current_stream(dev).cuda_stream
    out = zero.clone()
    args = (packed.data_ptr(), zero.data_ptr(), out.data_ptr(), rows, m, 1, 1, p.clusters,
            p.share, p.span_log2, stream)
    refused = args[:7] + (0,) + args[8:]  # no clusters: returns before launching
    g = pk.plan_gmin_on(dev.index, rows, m)
    gmin = (zero.data_ptr(), packed.data_ptr(), out.data_ptr(), rows, m, 1, g.clusters, stream)
    steps = {
        "the ctypes call (argument conversion, cudaLaunchKernelEx)":
            lambda: pk._library().probe_packed_launch(*args),
        "the same call refused before the launch (conversion and call alone)":
            lambda: pk._library().probe_packed_launch(*refused),
        "P3's ctypes call for comparison (8 arguments, cudaLaunchKernelEx)":
            lambda: pk._library().probe_gmin_launch(*gmin),
        "plan lookup": lambda: pk.plan_on(dev.index, False, True, rows, m),
        "SM count (cached)": lambda: config.sm_count(dev),
        "current device": torch.cuda.current_device,
        "current stream": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "clone of regs (the output)": zero.clone,
    }
    def device_switch():
        with torch.cuda.device(dev):
            pass

    parent = {
        "torch.zeros output": lambda: torch.zeros(m, dtype=torch.int32, device=dev),
        "torch.cuda.device switch": device_switch,
        "get_device_properties": lambda: torch.cuda.get_device_properties(dev).multi_processor_count,
        "torch.maximum after": lambda: torch.maximum(zero, warm),
    }
    log(f"P2 launch path, host time of one call: {whole:.2f} us; its steps:")
    for label, fn in steps.items():
        log(f"  {label}: {host_us(torch, fn):.2f} us")
    log("  the parent's steps beside its launch, each alone:")
    for label, fn in parent.items():
        log(f"  {label}: {host_us(torch, fn):.2f} us")


# -- phase 4 ----------------------------------------------------------------

# phase 4 runs over 16 batches of 2^21 rows of its own table (a cut of
# depth, for the time limit: over 24 batches it took 137.0-161.5 s with the
# telemetry slice's reruns, over 48 batches 198 s before them)
MAIN_ROWS = 16 << 21


def store_sales(np, rows: int, seed: int):
    """A store_sales-shaped table: the TPC-DS key domains at SF100, ~4%
    nulls in every non-key column, i_category joined from item."""
    rng = np.random.default_rng(seed)

    def nulls():
        return rng.random(rows, dtype=np.float32) < NULL_SHARE

    item = rng.integers(1, SF100_ITEMS + 1, rows)
    item_category = rng.integers(0, len(CATEGORIES), SF100_ITEMS + 1).astype(np.int32)
    item_category[rng.random(SF100_ITEMS + 1) < NULL_SHARE] = -1
    quantity = rng.integers(1, 101, rows, dtype=np.int32)
    wholesale = np.round(rng.uniform(1.0, 100.0, rows), 2)
    list_price = np.round(wholesale * rng.uniform(1.0, 2.0, rows), 2)
    sales_price = np.round(list_price * rng.uniform(0.0, 1.0, rows), 2)
    ext_sales = sales_price * quantity
    net_profit = np.round(ext_sales - wholesale * quantity, 2)
    return {
        "ss_item_sk": item,
        "ss_customer_sk": np.ma.array(
            rng.integers(1, SF100_CUSTOMERS + 1, rows), mask=nulls()),
        "ss_store_sk": np.ma.array(
            rng.integers(1, SF100_STORES + 1, rows), mask=nulls()),
        "ss_ticket_number": np.arange(rows, dtype=np.int64) // 12 + 1,
        "ss_quantity": np.ma.array(quantity, mask=nulls()),
        "ss_wholesale_cost": np.ma.array(wholesale.astype(np.float32), mask=nulls()),
        "ss_sales_price": np.ma.array(sales_price, mask=nulls()),
        "ss_ext_sales_price": np.ma.array(ext_sales, mask=nulls()),
        "ss_net_profit": np.ma.array(net_profit, mask=nulls()),
        "i_category": item_category[item],
    }


def expected_metrics(np, cols):
    """Scalar metrics by numpy float64, from the host columns."""
    out = {}
    for name, col in cols.items():
        if name == "i_category":
            out[name] = {"completeness": float((col >= 0).sum()) / len(col)}
            continue
        if isinstance(col, np.ma.MaskedArray):
            valid = ~np.ma.getmaskarray(col)
            vals = np.asarray(col.data)[valid].astype(np.float64)
        else:
            valid = np.ones(len(col), dtype=bool)
            vals = col.astype(np.float64)
        mean = float(vals.mean())
        out[name] = {
            "completeness": float(valid.sum()) / len(col),
            "mean": mean,
            "sum": float(vals.sum()),
            "min": float(vals.min()),
            "max": float(vals.max()),
            "std": float(np.sqrt(np.mean((vals - mean) ** 2))),
        }
    return out


def profile_rerun(torch, rerun, label, tables=True, hash_check=True, counts=None):
    """Device time by kernel, and the device's idle share, over one more
    run on resident columns; returns the device ms and calls by PyTorch
    op, and fills ``counts``, when given, with the session's
    ``session_counts``. ``hash_check``: the HLL hash's elementwise ops
    must be gone (the KLL step's offset hashes C words a batch with
    them, so a suite with sketches skips the check)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    open_before = torch.autograd._profiler_enabled()
    t_session = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rerun()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = device_kernels(prof.key_averages())
    session_s = time.perf_counter() - t_session
    if not kernels:
        # the run launched kernels (its callers check the counts), so the
        # session lost them: no idle share is read from it
        log_empty_session(torch, prof, open_before, f"profile_rerun of {label}")
        log(f"profile ({label}): rerun wall {wall_ms:.3f} ms; device idle share not measured")
        return {}
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    device_ops = sum(e.count for e in prof.key_averages()
                     if e.device_type == DeviceType.CPU and e.key.startswith("aten::")
                     and e.self_device_time_total > 0)
    log(f"profile ({label}): rerun wall {wall_ms:.3f} ms, kernels {busy_ms:.3f} ms, "
        f"device idle share {1 - busy_ms / wall_ms:.3f}; "
        f"{sum(e.count for e in kernels)} kernel launches, {device_ops} PyTorch ops "
        f"that ran on the device; the session and its parse {session_s:.3f} s")
    if counts is not None:
        counts.update(session_counts(prof))
    op_ms = {e.key: (e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
             if e.device_type == DeviceType.CPU and e.key.startswith("aten::")
             and e.self_device_time_total > 0}
    if not tables:
        return op_ms
    log("profile: device time by kernel:")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]:
        log(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:6d}x  {e.key[:100]}")
    ops = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CPU and e.key.startswith("aten::")
           and e.self_device_time_total > 0]
    log("profile: device time by PyTorch op:")
    for e in sorted(ops, key=lambda e: -e.self_device_time_total)[:15]:
        log(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:6d}x  {e.key}")
    # the HLL hash runs inside the fused kernel: the elementwise passes
    # that carried it before are gone from the suite
    hash_ms = sum(e.self_device_time_total for e in ops
                  if e.key in ("aten::bitwise_xor", "aten::__rshift__")) / 1e3
    log(f"profile: bitwise_xor + __rshift__ {hash_ms:.3f} ms")
    if hash_check:
        check(hash_ms < 1.0, f"the hash's elementwise ops still take {hash_ms:.3f} ms")
    return op_ms


def main_phase(torch, np, rows: int, seed: int):
    import deequ_tpu_torch as T
    from deequ_tpu_torch.analyzers import ApproxCountDistinct
    from deequ_tpu_torch.analyzers import grouping as grouping_mod
    from deequ_tpu_torch.data.table import ColumnRequest
    from deequ_tpu_torch.engine import vectorize
    from deequ_tpu_torch.sketches import hll, scatter_max as sm

    t_phase = time.perf_counter()
    log(f"main: store_sales-shaped table, {rows} rows "
        f"(cut from SF100's {SF100_ROWS} rows to fit the smoke's time limit)")
    t0 = time.perf_counter()
    cols = store_sales(np, rows, seed)
    t_gen = time.perf_counter() - t0
    data = dict(cols)
    data["i_category"] = T.DictionaryColumn(cols["i_category"], np.array(CATEGORIES, dtype=object))
    t0 = time.perf_counter()
    dataset = T.Dataset.from_pydict(data)
    t_ds = time.perf_counter() - t0

    keys = ["ss_item_sk", "ss_customer_sk", "ss_store_sk", "ss_ticket_number"]
    numeric = ["ss_quantity", "ss_wholesale_cost", "ss_sales_price",
               "ss_ext_sales_price", "ss_net_profit"]
    nullable = ["ss_customer_sk", "ss_store_sk"] + numeric + ["i_category"]
    t_expect = time.perf_counter()
    want = expected_metrics(np, cols)

    def close(a, b, rtol):
        return math.isclose(a, b, rel_tol=rtol, abs_tol=rtol)

    checks = (
        T.Check(T.CheckLevel.ERROR, "store_sales")
        .has_size(lambda n: n == rows)
        .is_complete("ss_item_sk")
        .is_complete("ss_ticket_number")
    )
    for c in nullable:
        checks = checks.has_completeness(c, lambda v, c=c: v == want[c]["completeness"])
    for c in numeric:
        rtol = RTOL_F32 if c == "ss_wholesale_cost" else RTOL_F64
        w = want[c]
        checks = (
            checks.has_mean(c, lambda v, w=w, r=rtol: close(v, w["mean"], r))
            .has_min(c, lambda v, w=w: v == w["min"])
            .has_max(c, lambda v, w=w: v == w["max"])
            .has_sum(c, lambda v, w=w, r=rtol: close(v, w["sum"], r))
            .has_standard_deviation(c, lambda v, w=w, r=rtol: close(v, w["std"], r))
        )
    domains = {"ss_item_sk": SF100_ITEMS, "ss_customer_sk": SF100_CUSTOMERS,
               "ss_store_sk": SF100_STORES, "ss_ticket_number": rows // 12 + 1}
    for c in keys:
        checks = checks.has_approx_count_distinct(
            c, lambda v, d=min(domains[c], rows): 0 < v < 1.1 * d)
    checks = checks.has_approx_count_distinct(
        "i_category", lambda v: abs(v - len(CATEGORIES)) < 0.5)
    filters = filter_checks(T, np, cols, rows, close)
    sketches, kll_columns = sketch_checks(T, np, cols, rows)
    grouping = grouping_checks(T, np, cols, rows)
    hll_where = ("ss_item_sk", "ss_customer_sk")

    states = {}

    class Keep:
        def persist(self, analyzer, state):
            states[analyzer] = state

    # every KLL unit's per-batch outputs, in fold order, keyed by (where,
    # columns): the outputs the engine fetched, read beside the fold
    recorded = {}
    build_kll = vectorize._build_kll_group

    def recording_build(dataset_, members, where):
        unit = build_kll(dataset_, members, where)
        outs = recorded.setdefault((where, tuple(vectorize._index_members(members)[0])), [])
        fold = unit.ops.host_fold

        def host_fold(accs, out):
            outs.append(out)
            return fold(accs, out)

        unit.ops.host_fold = host_fold
        return unit

    # the grouping planner's split of the first run's plans, each spill
    # plan's collector state (its key buffer, timed below), and the
    # host seconds of the dictionary encodes the dense plans need
    planned, collected, encode_s = [], [], {}
    plan_passes, finalize = grouping_mod.plan_frequency_passes, grouping_mod.finalize_collector_states
    encode = T.Dataset._encode

    def recording_plan(*args, **kwargs):
        out = plan_passes(*args, **kwargs)
        planned.append(out)
        return out

    def recording_finalize(collectors, states_, *args, **kwargs):
        collected.extend((spec.plan, state) for spec, state in zip(collectors, states_))
        return finalize(collectors, states_, *args, **kwargs)

    def timed_encode(self, column):
        t0 = time.perf_counter()
        encode(self, column)
        encode_s[column] = time.perf_counter() - t0

    engine = T.AnalysisEngine()
    check(engine.device.type == "cuda", f"default engine device is {engine.device}")
    batch = engine._resolve_batch_size(rows)
    nb = -(-rows // batch)
    t_first = time.perf_counter()
    sm.launches = sm.fused_launches = sm.codes_launches = sm.codes_rows_launches = 0
    vectorize._build_kll_group = recording_build
    grouping_mod.plan_frequency_passes = recording_plan
    grouping_mod.finalize_collector_states = recording_finalize
    T.Dataset._encode = timed_encode
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        result = (
            T.VerificationSuite().on_data(dataset)
            .add_checks([checks, filters, sketches, grouping])
            .with_engine(engine).save_states_with(Keep()).run()
        )
        torch.cuda.synchronize()
        t_run = time.perf_counter() - t0
        peak_first = torch.cuda.max_memory_allocated() / 2**30
    finally:
        vectorize._build_kll_group = build_kll
        grouping_mod.plan_frequency_passes = plan_passes
        grouping_mod.finalize_collector_states = finalize
        T.Dataset._encode = encode
    launches = {"hll_scatter_max": sm.launches, "hll_update": sm.fused_launches,
                "hll_update_codes": sm.codes_launches - sm.codes_rows_launches,
                "hll_update_codes_rows": sm.codes_rows_launches}
    phases = dict(engine.phase_times or {})
    t_checks = time.perf_counter()

    failed = [
        f"{cr.constraint}: {cr.message}"
        for check_ in (checks, filters, sketches, grouping)
        for cr in result.check_results[check_].constraint_results
        if cr.status.value != "Success"
    ]
    for line in failed:
        log(f"  FAILED {line}")
    # from the planner's groups: the four int64 keys stack into one HLL
    # group and the two filtered int64 keys into another; ss_sales_price
    # (float64) and ss_wholesale_cost (float32) are HLL singles, each its
    # own fused update, though KLL groups cover both (the JAX package
    # would build the float32 column's registers from the KLL sort);
    # i_category is a single, one codes launch a batch; the (idx, rho)
    # entry is off the main path
    expected = {"hll_scatter_max": 0, "hll_update": 4 * nb, "hll_update_codes": nb,
                "hll_update_codes_rows": 0}
    check(launches == expected, f"K1 launches {launches}, expected {expected}")
    check(engine.stream_stats is None, "the main suite streamed: it must stay resident under "
          "the phase's budget")
    check_grouping_plans(planned)
    # one pass; two fetches: the scan's states and per-batch outputs,
    # then the five spill finalizes' scalars, all dispatched before it
    check(engine.data_passes == 1, f"data_passes == {engine.data_passes}")
    check(engine.device_fetches == 2, f"device_fetches == {engine.device_fetches}")
    check(result.status.value == "Success", f"status {result.status}: {failed}")
    log("main: host dictionary encodes of the first run (cached after it): "
        + ", ".join(f"{c} {s:.3f} s" for c, s in encode_s.items())
        + f"; first run's peak device memory {peak_first:.2f} GiB")

    # HLL registers against the plain version over whole columns
    hll_columns = keys + ["i_category", "ss_sales_price", "ss_wholesale_cost"]
    for c in hll_columns:
        got = states[ApproxCountDistinct(c)].registers
        check(torch.equal(got, plain_registers(torch, np, dataset, c, engine.device)),
              f"HLL registers of {c} differ from the plain whole-column build")
    q = cols["ss_quantity"]
    over_50 = ~np.ma.getmaskarray(q) & (np.asarray(q.data) > 50)
    for c in hll_where:
        got = states[ApproxCountDistinct(c, where="ss_quantity > 50")].registers
        check(torch.equal(got, plain_registers(torch, np, dataset, c, engine.device, over_50)),
              f"filtered HLL registers of {c} differ from the plain build")
    log("main: HLL registers equal the plain whole-column build for "
        f"{len(hll_columns)} columns and {len(hll_where)} filtered columns")
    check_sketch_states(T, np, cols, rows, batch, nb, states, recorded, kll_columns)

    # reruns over the now-resident columns time the scan alone: the base
    # suite, the suite with the filter and predicate constraints, and the
    # suite with the sketch, type and pattern constraints too
    def rerun(check_list):
        def run():
            T.VerificationSuite().on_data(dataset).add_checks(check_list).with_engine(
                engine).run()
            torch.cuda.synchronize()
        return run

    t_reruns = time.perf_counter()
    base_rerun, full_rerun = rerun([checks]), rerun([checks, filters])
    sketch_rerun = rerun([checks, filters, sketches])
    grouping_rerun = rerun([checks, filters, sketches, grouping])
    t0 = time.perf_counter()
    base_rerun()
    t_base = time.perf_counter() - t0
    t0 = time.perf_counter()
    full_rerun()
    t_rerun = time.perf_counter() - t0
    t0 = time.perf_counter()
    sketch_rerun()
    t_sketch = time.perf_counter() - t0
    sketch_phases = dict(engine.phase_times or {})

    log(f"main: generate {t_gen:.3f} s, Dataset {t_ds:.3f} s, run {t_run:.3f} s "
        f"(upload {phases.get('resident_s', float('nan')):.3f} s, scan "
        f"{phases.get('scan_s', float('nan')):.3f} s, host fold "
        f"{phases.get('fold_s', float('nan')):.3f} s), rerun on resident "
        f"columns {t_sketch:.3f} s (scan {sketch_phases['scan_s']:.3f} s, host fold "
        f"{sketch_phases['fold_s']:.3f} s)")
    log(f"main: {rows / t_run:.0f} rows/s end to end (first run, upload "
        f"included), {rows / t_sketch:.0f} rows/s on resident columns "
        f"({rows / t_rerun:.0f} rows/s without the sketch, type and pattern "
        f"constraints, {t_rerun:.3f} s; {rows / t_base:.0f} rows/s without the "
        f"filter and predicate constraints too, {t_base:.3f} s); {nb} batches of "
        f"{batch} rows, K1 launches {launches}, "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    t_telemetry = time.perf_counter()
    telemetry_on = telemetry_reruns(torch, T, dataset, engine,
                                    [checks, filters, sketches, grouping], nb)
    t_coalesce = time.perf_counter()
    coalesced = coalesced_run(torch, T, dataset, [[checks, filters, grouping],
                                                  [checks, sketches]], expected)
    t_profiles = time.perf_counter()
    # the one profiled rerun of a part of the suite (the base suite: the
    # hash's elementwise ops must be gone from it); the full suite's are
    # telemetry's session and the grouping rerun's
    profile_rerun(torch, base_rerun, "base suite")
    t_grouping = time.perf_counter()
    telemetry_off = {}
    grouping_phase(torch, np, T, dataset, engine, grouping_rerun, rows, nb, batch, collected,
                   telemetry_off)
    # telemetry's cost: the profiler_trace session of the full suite (on)
    # against grouping_phase's profiled rerun of the same suite (off)
    log_cost("telemetry (the full suite)", telemetry_on, telemetry_off)
    t_budget = time.perf_counter()
    cache_budget_run(torch, T, dataset, [checks], rows)
    marks = (("the table and its Dataset", t_phase), ("numpy's expectations", t_expect),
             ("the first run", t_first), ("its checks against numpy and the plain builds",
                                          t_checks),
             ("three timed reruns", t_reruns), ("telemetry's reruns", t_telemetry),
             ("the coalesced run and its solo members", t_coalesce),
             ("one profiled rerun", t_profiles),
             ("the grouping rerun and count forms", t_grouping),
             ("the cross-dataset budget", t_budget), ("", time.perf_counter()))
    log(f"main: phase 4's seconds by part over {nb} batches: " + ", ".join(
        f"{name} {b - a:.1f}" for (name, a), (_, b) in zip(marks, marks[1:])))
    return launches, coalesced


def coalesced_run(torch, T, dataset, members, expected):
    """Phase 4's coalesced run: each member (a list of the suite's
    checks; the members overlap) run solo through
    ``do_verification_run``, then ONE ``do_coalesced_verification_run``
    of them all on the resident columns. Each member's metrics and check
    results must equal its solo run's bit for bit, and the coalesced run
    takes the union's one pass and two fetches and K1's launches
    ``expected`` (the union's). Returns those launches."""
    from deequ_tpu_torch.sketches import scatter_max as sm

    solo, walls = [], []
    for member in members:
        engine = T.AnalysisEngine()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solo.append(T.VerificationSuite.do_verification_run(dataset, member, engine=engine))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    engine = T.AnalysisEngine()
    sm.launches = sm.fused_launches = sm.codes_launches = sm.codes_rows_launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = T.VerificationSuite.do_coalesced_verification_run(
        dataset, [(member, []) for member in members], engine=engine)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = k1_launches()
    check(launches == expected, f"coalesced: K1 launches {launches}, the union's {expected}")
    check(engine.data_passes == 1 and engine.device_fetches == 2,
          f"coalesced: {engine.data_passes} passes and {engine.device_fetches} fetches, not "
          "the union's 1 and 2")
    for i, (alone, sliced) in enumerate(zip(solo, results)):
        want, got = metric_bits(alone.metrics), metric_bits(sliced.metrics)
        check(got == want, f"coalesced: member {i}'s metrics differ from its solo run: "
              + ", ".join(k for k in set(want) | set(got) if want.get(k) != got.get(k))[:2000])
        check([r["constraint_status"] for r in sliced.check_results_as_records()]
              == [r["constraint_status"] for r in alone.check_results_as_records()],
              f"coalesced: member {i}'s check results differ from its solo run")
    sizes = [len(metric_bits(r.metrics)) for r in results]
    log(f"coalesced: {len(members)} overlapping members ({' and '.join(map(str, sizes))} "
        f"metrics) in one run of {wall:.3f} s against their solo runs' "
        f"{' + '.join(f'{w:.3f}' for w in walls)} = {sum(walls):.3f} s; each member equals its "
        "solo run bit for bit (metrics and check results); 1 pass, 2 fetches, K1 launched as "
        "the union")
    return launches


def cache_budget_run(torch, T, dataset, checks, rows):
    """The cross-dataset device-cache budget on the card: two resident
    datasets of phase 4's kind (the table's halves, each a view with its
    own columns) scanned in turn after the table itself, under a budget
    that holds one half and not two. Each scan evicts the datasets
    scanned before it (the table, then the other half): their bytes
    leave the ledger, ``torch.cuda.memory_allocated`` drops, and
    ``Dataset.global_device_cache_bytes`` stays within the budget; a
    half scanned again after its eviction equals its first run."""
    from deequ_tpu_torch import config

    halves = [dataset.slice_rows(0, rows // 2), dataset.slice_rows(rows // 2, rows)]
    held = T.Dataset.global_device_cache_bytes()
    check(0 < dataset._device_cache_bytes() <= held,
          f"budget: the table holds {dataset._device_cache_bytes()} of {held} bytes")

    def scan(half):
        out = (T.VerificationSuite().on_data(half).add_checks(checks)
               .with_engine(T.AnalysisEngine()).run())
        torch.cuda.synchronize()
        return out

    first = scan(halves[0])
    one = halves[0]._device_cache_bytes()
    check(0 < one and T.Dataset.global_device_cache_bytes() == held + one,
          f"budget: the first half holds {one} bytes beside the table's {held}")
    budget = one + one // 2
    steps = []
    with config.configure(device_cache_bytes=budget):
        for n, (half, gone) in enumerate(((halves[1], (dataset, halves[0])),
                                          (halves[0], (halves[1],)))):
            before = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            result = scan(half)
            seconds = time.perf_counter() - t0
            after = torch.cuda.memory_allocated()
            total = T.Dataset.global_device_cache_bytes()
            check(all(d._device_cache_bytes() == 0 for d in gone),
                  f"budget: scan {n + 1} left an older dataset's columns on the device")
            check(half._device_cache_bytes() == total and 0 < total <= budget,
                  f"budget: {total} bytes cached against a budget of {budget}")
            # the table's columns leave the card in scan 2; in scan 3 one
            # half's replace the other's, as many bytes
            check(after < before if n == 0 else after <= before,
                  f"budget: scan {n + 2}: memory_allocated {before} -> {after} bytes")
            steps.append((before, after, total, seconds))
    check(metric_bits(result.metrics) == metric_bits(first.metrics),
          "budget: the first half scanned again differs from its first scan")
    halves[0].clear_device_cache()
    check(T.Dataset.global_device_cache_bytes() == 0, "budget: a cache outlived its dataset")
    log(f"budget: the table ({held / 2**30:.3f} GiB resident) and its halves "
        f"({one / 2**30:.3f} GiB each) scanned in turn under a budget of "
        f"{budget / 2**30:.3f} GiB: " + "; ".join(
            f"scan {n + 2} {s:.3f} s, memory_allocated {b / 2**30:.3f} -> {a / 2**30:.3f} GiB, "
            f"{t / 2**30:.3f} GiB cached" for n, (b, a, t, s) in enumerate(steps))
        + "; each evicted the datasets scanned before it, and the first half again equals "
        "its first scan bit for bit")


# the buckets of the JAX package's scan wall decomposition (PhaseClock):
# they lie inside the pass they split
PHASE_BUCKETS = ("host_wait_s", "put_s", "dispatch_s", "first_step_s", "sync_s")
TELEMETRY_RERUNS = 3


def abba(a, b, n):
    """``n`` runs each of ``a`` and ``b`` in turns that give neither side
    the first or the warmer place: a b b a a b ..."""
    return [(a, b)[(i + 1) // 2 % 2] for i in range(2 * n)]


def telemetry_reruns(torch, T, dataset, engine, check_list, nb):
    """Phase 4's full suite rerun on its resident columns with telemetry
    on (a JSONL log in a temporary directory) and off, TELEMETRY_RERUNS
    each, in ABBA turns: the metrics bit-equal, one pass and two fetches
    each (the scan's, then the spill finalizes'), counted the same by
    the engine and the counters, no byte copied to the card, and the
    ``scan_phases`` buckets inside the pass's wall; then one rerun inside
    ``profiler_trace``, whose every K1 launch must lie inside a
    ``deequ_tpu:`` range. Returns that session's ``session_counts``,
    telemetry's side of its cost (``log_cost``)."""
    import os
    import statistics

    from deequ_tpu_torch import telemetry

    tm = telemetry.get_telemetry()
    tmp = tempfile.mkdtemp(prefix="deequ_smoke_telemetry_")
    path = os.path.join(tmp, "smoke.jsonl")

    def once(label):
        fetches, passes = engine.device_fetches, engine.data_passes
        before = tm.metrics.counters_snapshot()
        t0 = time.perf_counter()
        result = (T.VerificationSuite().on_data(dataset).add_checks(check_list)
                  .with_engine(engine).run())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        after = tm.metrics.counters_snapshot()
        deltas = {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}
        fetches, passes = engine.device_fetches - fetches, engine.data_passes - passes
        check((fetches, passes) == (2, 1),
              f"telemetry ({label}): {fetches} fetches and {passes} passes, want 2 and 1")
        check(deltas.get("engine.device_fetches") == fetches
              and deltas.get("engine.data_passes") == passes,
              f"telemetry ({label}): counters {deltas}, the engine's {fetches} fetches and "
              f"{passes} passes")
        check(deltas.get("transfer.bytes", 0) == 0,
              f"telemetry ({label}): a rerun on resident columns copied "
              f"{deltas.get('transfer.bytes')} bytes")
        return result, wall

    walls = {"on": [], "off": []}
    want = None
    t_start = time.perf_counter()
    try:
        for mode in abba("off", "on", TELEMETRY_RERUNS):
            telemetry.configure(enabled=mode == "on", jsonl_path=path if mode == "on" else None)
            try:
                result, wall = once(mode)
            finally:
                telemetry.configure(enabled=True, jsonl_path=None)
            walls[mode].append(wall)
            bits = metric_bits(result.metrics)
            want = want or bits
            check(bits == want, f"telemetry ({mode}): metrics differ from the first rerun's: "
                  + ", ".join(k for k, v in bits.items() if want.get(k) != v))
            check((result.telemetry is None) == (mode == "off"),
                  f"telemetry ({mode}): the result's summary is {result.telemetry is None}")
            if mode == "on":
                (event,) = [e for e in result.telemetry["events"] if e["event"] == "scan_phases"]
                buckets = sum(event[k] for k in PHASE_BUCKETS)
                pass_wall = result.telemetry["passes"][0]["wall_s"]
                check(buckets <= pass_wall, f"telemetry: scan_phases buckets {buckets:.6f} s "
                      f"over the pass's {pass_wall:.6f} s")
        records = telemetry.read_jsonl(path)
        summaries = [r for r in records if r["type"] == "run_summary"]
        check(len(summaries) == TELEMETRY_RERUNS
              and all(s["counters"]["engine.device_fetches"] == 2 for s in summaries),
              f"telemetry: {len(summaries)} run summaries in the log")
        on, off = statistics.median(walls["on"]), statistics.median(walls["off"])
        log(f"telemetry: full suite rerun, median of {TELEMETRY_RERUNS}: on (JSONL, "
            f"{os.path.getsize(path)} bytes, {len(records)} records) {on:.4f} s, off "
            f"{off:.4f} s, cost {on - off:+.4f} s ({(on / off - 1) * 100:+.2f}%); runs on "
            + ", ".join(f"{w:.4f}" for w in walls["on"]) + "; off "
            + ", ".join(f"{w:.4f}" for w in walls["off"])
            + "; metrics bit-equal, 1 pass and 2 fetches each, 0 bytes copied")
        t_trace = time.perf_counter()
        counts = k1_in_ranges(torch, T, once, os.path.join(tmp, "trace"), nb)
        log(f"telemetry: the reruns took {t_trace - t_start:.1f} s, the profiled rerun and its "
            f"check {time.perf_counter() - t_trace:.1f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return counts


def session_counts(prof):
    """A profiler session's device time and work: its kernels'
    milliseconds and launches (``device_kernels``), and the PyTorch ops
    it recorded, all and those that ran on the device."""
    from torch.autograd import DeviceType

    averages = prof.key_averages()
    kernels = device_kernels(averages)
    ops = [e for e in averages if e.device_type == DeviceType.CPU and e.key.startswith("aten::")]
    return {"kernel_ms": sum(e.self_device_time_total for e in kernels) / 1e3,
            "launches": sum(e.count for e in kernels),
            "ops": sum(e.count for e in ops),
            "device_ops": sum(e.count for e in ops if e.self_device_time_total > 0)}


def log_cost(what, with_it, without):
    """A feature's cost as two profiled reruns of one suite read it: the
    kernels' milliseconds, kernel launches and PyTorch ops with it
    (``session_counts``) against without it."""
    for side, c in (("with", with_it), ("without", without)):
        log(f"cost of {what}: the profiled rerun {side} it: kernels {c['kernel_ms']:.3f} ms, "
            f"{c['launches']} kernel launches, {c['ops']} PyTorch ops ({c['device_ops']} on "
            "the device)")
    a, b = with_it, without
    share = (a["kernel_ms"] / b["kernel_ms"] - 1) * 100 if b["kernel_ms"] else math.nan
    log(f"cost of {what}: kernels {a['kernel_ms'] - b['kernel_ms']:+.3f} ms ({share:+.2f}%), "
        f"{a['launches'] - b['launches']:+d} kernel launches, {a['ops'] - b['ops']:+d} "
        f"PyTorch ops ({a['device_ops'] - b['device_ops']:+d} on the device)")


def k1_in_ranges(torch, T, once, trace_dir, nb, attempts=3):
    """One rerun inside ``profiler_trace``: its Chrome trace must hold
    K1's launches (four fused and one codes a batch), and each launch's
    runtime call must lie inside a ``deequ_tpu:`` range of its thread.
    A session that recorded no kernel is logged and taken again. Returns
    the session's ``session_counts``."""
    for attempt in range(attempts):
        t0 = time.perf_counter()
        with T.profiler_trace(trace_dir) as prof:
            _, wall = once("profiled")
        t1 = time.perf_counter()
        with open(f"{trace_dir}/trace.json") as fh:
            events = json.load(fh)["traceEvents"]
        log(f"telemetry: the profiled rerun {wall:.3f} s, its session and Chrome trace "
            f"{t1 - t0:.3f} s in all, the trace read back in {time.perf_counter() - t1:.3f} s "
            f"({len(events)} events)")
        kernels = [e for e in events if e.get("cat") == "kernel" and "hll_" in e.get("name", "")]
        if kernels:
            break
        log(f"telemetry: the profiler session recorded no K1 kernel (attempt {attempt + 1})")
    check(len(kernels) == 5 * nb, f"telemetry: {len(kernels)} K1 kernels in the trace, want "
          f"{5 * nb}")
    runtime = {e["args"]["correlation"]: e for e in events
               if e.get("cat") in ("cuda_runtime", "cuda_driver") and "correlation" in
               e.get("args", {})}
    ranges = {}
    for e in events:
        if e.get("cat") == "user_annotation" and e.get("name", "").startswith("deequ_tpu:"):
            ranges.setdefault((e["pid"], e["tid"]), []).append((e["ts"], e["ts"] + e["dur"],
                                                              e["name"]))
    outside, names = [], set()
    for k in kernels:
        call = runtime.get(k["args"].get("correlation"))
        inside = [] if call is None else [
            name for lo, hi, name in ranges.get((call["pid"], call["tid"]), ())
            if lo <= call["ts"] and call["ts"] + call.get("dur", 0) <= hi]
        if not inside:
            outside.append(k["name"][:60])
        names.update(inside)
    check(not outside, f"telemetry: {len(outside)} K1 launches outside a deequ_tpu: range: "
          f"{outside[:3]}")
    log(f"telemetry: all {len(kernels)} K1 launches of the profiled rerun lie inside "
        f"deequ_tpu: ranges ({', '.join(sorted(names))})")
    return session_counts(prof)


# stated tolerances of the grouping metrics against numpy: entropy of a
# spill plan is a float64 sum on the device (numpy sums the same terms
# in another order); mutual information is a sum of ~4,400 terms of
# either sign whose total is small, against numpy's sum of them
RTOL_ENTROPY = 1e-12
RTOL_MI = 1e-9
# the plans phase 4's grouping constraints must take: (columns, where,
# include_nulls) -> "dense" | "collector"
GROUPING_PLANS = {
    (("ss_store_sk",), None, False): "dense",
    (("i_category",), None, False): "dense",
    (("i_category",), None, True): "dense",
    (("i_category", "ss_store_sk"), None, False): "dense",
    (("ss_customer_sk",), None, False): "collector",
    (("ss_sales_price",), None, False): "collector",
    (("ss_wholesale_cost",), None, False): "collector",
    (("ss_item_sk",), BOOKS, False): "collector",
    (("ss_item_sk", "ss_ticket_number"), None, False): "collector",
}


def grouping_checks(T, np, cols, rows):
    """The nine grouping constraints, each held to a value numpy computes
    from the host columns (``np.bincount`` over bounded domains; the
    TPC-DS key pair's duplicates within each 12-row ticket)."""
    t0 = time.perf_counter()

    def valid_data(name):
        col = cols[name]
        valid = ~np.ma.getmaskarray(col)
        return valid, np.asarray(col.data)

    cat = cols["i_category"]
    cat_valid = cat >= 0
    cat_counts = np.bincount(cat[cat_valid], minlength=len(CATEGORIES))
    distinctness = int((cat_counts > 0).sum()) / int(cat_valid.sum())
    histogram = {name: int(c) for name, c in zip(CATEGORIES, cat_counts) if c}
    if rows - int(cat_valid.sum()):
        histogram["NullValue"] = rows - int(cat_valid.sum())

    store_valid, store = valid_data("ss_store_sk")
    n_stores = int((np.bincount(store[store_valid]) > 0).sum())
    both = cat_valid & store_valid
    width = SF100_STORES + 1
    joint = np.bincount(cat[both].astype(np.int64) * width + store[both],
                        minlength=len(CATEGORIES) * width).astype(np.float64)
    p = joint.reshape(len(CATEGORIES), width) / joint.sum()
    pa, pb = p.sum(axis=1, keepdims=True), p.sum(axis=0, keepdims=True)
    nz = p > 0
    mutual = float((p[nz] * np.log(p[nz] / (pa * pb)[nz])).sum())

    cust_valid, cust = valid_data("ss_customer_sk")
    cust_counts = np.bincount(cust[cust_valid])
    uniqueness = int((cust_counts == 1).sum()) / int(cust_valid.sum())

    # prices are cents (np.round(x, 2)): distinct values are distinct cents
    price_valid, price = valid_data("ss_sales_price")
    price_counts = np.bincount(np.rint(price[price_valid] * 100).astype(np.int64))
    pc = price_counts[price_counts > 0] / price_valid.sum()
    entropy = float(-(pc * np.log(pc)).sum())
    cost_valid, cost = valid_data("ss_wholesale_cost")
    cost_counts = np.bincount(np.rint(cost[cost_valid].astype(np.float64) * 100).astype(np.int64))
    ratio = int((cost_counts == 1).sum()) / int((cost_counts > 0).sum())

    item = cols["ss_item_sk"]
    books_items = int((np.bincount(item[cat == CATEGORIES.index("Books")]) > 0).sum())
    # (ss_item_sk, ss_ticket_number): a ticket is 12 consecutive rows, so
    # a pair repeats only as an item twice within one ticket
    full = rows // 12 * 12
    blocks = np.sort(item[:full].reshape(-1, 12), axis=1)
    same = blocks[:, 1:] == blocks[:, :-1]
    repeated = np.zeros(blocks.shape, dtype=bool)
    repeated[:, 1:] |= same
    repeated[:, :-1] |= same
    _, tail_counts = np.unique(item[full:], return_counts=True)
    pk_unique = (int((~repeated).sum()) + int((tail_counts == 1).sum())) / rows

    def histogram_exact(dist):
        return dist.number_of_bins == len(histogram) and {
            k: (v.absolute, v.ratio) for k, v in dist.values.items()
        } == {k: (c, c / rows) for k, c in histogram.items()}

    check_ = (
        T.Check(T.CheckLevel.ERROR, "store_sales grouping")
        .has_number_of_distinct_values("ss_store_sk", lambda v: v == n_stores)
        .has_distinctness(["i_category"], lambda v: v == distinctness)
        .has_histogram_values("i_category", histogram_exact)
        .has_mutual_information(
            "i_category", "ss_store_sk",
            lambda v: math.isclose(v, mutual, rel_tol=RTOL_MI, abs_tol=1e-15))
        .has_uniqueness(["ss_customer_sk"], lambda v: v == uniqueness)
        .has_entropy("ss_sales_price",
                     lambda v: math.isclose(v, entropy, rel_tol=RTOL_ENTROPY, abs_tol=0.0))
        .has_unique_value_ratio(["ss_wholesale_cost"], lambda v: v == ratio)
        .has_number_of_distinct_values("ss_item_sk", lambda v: v == books_items).where(BOOKS)
        .has_uniqueness(["ss_item_sk", "ss_ticket_number"], lambda v: v == pk_unique)
    )
    log(f"main: numpy computed the grouping expectations in {time.perf_counter() - t0:.3f} s "
        f"({n_stores} stores, {books_items} Books items, customer uniqueness {uniqueness}, "
        f"price entropy {entropy}, cost unique ratio {ratio}, key-pair uniqueness "
        f"{pk_unique}, mutual information {mutual})")
    return check_


def check_grouping_plans(planned):
    """The first run's one grouping plan split: every plan on its path,
    four dense specs, five collectors, nothing deferred."""
    check(len(planned) == 1, f"the grouping planner ran {len(planned)} times")
    dense, collectors, deferred = planned[0]
    got = {}
    for spec in dense:
        got[(spec.plan.columns, spec.plan.where, spec.plan.include_nulls)] = "dense"
    for spec in collectors:
        got[(spec.plan.columns, spec.plan.where, spec.plan.include_nulls)] = "collector"
    check(not deferred, f"deferred plans: {list(deferred)}")
    check(got == GROUPING_PLANS, f"grouping plans {got}, expected {GROUPING_PLANS}")
    log(f"main: grouping plans: {len(dense)} dense, {len(collectors)} collectors, "
        f"{len(deferred)} deferred; dense slots "
        + ", ".join(f"{'+'.join(s.plan.columns)} {s.ops.init()[0].numel()}" for s in dense))


def grouping_phase(torch, np, T, dataset, engine, grouping_rerun, rows, nb, batch, collected,
                   counts):
    """The rerun with the grouping constraints, profiled with telemetry
    off (its ``session_counts`` into ``counts``: telemetry's cost), with
    its peak memory; then the two forms of the spill segment count on
    each collector's own keys, and of the dense per-batch scatter at the
    dense plans' widths."""
    from deequ_tpu_torch import telemetry
    from deequ_tpu_torch.analyzers import grouping as grouping_mod
    from deequ_tpu_torch.analyzers import spill
    from deequ_tpu_torch.data.table import ColumnRequest

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    grouping_rerun()
    t_group = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    log(f"main: rerun with the grouping constraints {t_group:.3f} s, {rows / t_group:.0f} "
        f"rows/s on resident columns; peak device memory {peak / 2**30:.2f} GiB "
        f"({(peak - base_mem) / 2**30:.2f} GiB above the resident columns and states "
        f"held before it)")
    telemetry.configure(enabled=False)
    try:
        op_ms = profile_rerun(torch, grouping_rerun, "whole suite with the grouping constraints, "
                              "telemetry off", hash_check=False, counts=counts)
    finally:
        telemetry.configure(enabled=True)
    for op in ("aten::sort", "aten::scatter_add_", "aten::scatter_", "aten::cumsum",
               "aten::index", "aten::where", "aten::copy_"):
        ms, count = op_ms.get(op, (0.0, 0))
        log(f"profile (grouping): {op} {ms:.3f} ms in {count} calls, {ms / nb:.4f} ms a batch")

    # a spill finalize reads nothing back before the one fetch: every
    # plan's sort is dispatched before any result is needed
    _plan, (buffers, _offset, ns, _nn) = collected[0]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        spill._finalize_fn(buffers[0], ns)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    log("grouping: a spill finalize dispatches with no host sync")

    # the spill segment count, both forms, on each plan's sorted keys
    log("grouping: segment count forms on each collector's keys (CUDA events, median):")
    for plan, state in collected:
        buffers, offset, ns, _nn = state
        keys = buffers[0]
        n = keys.shape[0]
        sort_ms = median_ms(torch, lambda: torch.sort(keys), iters=5, warmup=1)
        finalize_ms = median_ms(torch, lambda: spill._finalize_fn(keys, ns), iters=5, warmup=1)
        srt = torch.sort(keys).values
        boundary = torch.cat([torch.ones(1, dtype=torch.bool, device=srt.device),
                              srt[1:] != srt[:-1]])
        seg = torch.cumsum(boundary, 0) - 1

        def starts_form():
            starts = spill._segment_starts(boundary, seg)
            return torch.cat([starts[1:], starts.new_full((1,), n)]) - starts

        ones = torch.ones((), dtype=torch.int32, device=srt.device).expand(n)

        def scatter_add_form():
            return torch.zeros(n + 1, dtype=torch.int32, device=srt.device).scatter_add_(0, seg, ones)

        check(torch.equal(starts_form(), scatter_add_form()),
              f"segment count forms differ on {plan.columns}")
        a = median_ms(torch, starts_form, iters=5, warmup=1)
        b = median_ms(torch, scatter_add_form, iters=5, warmup=1)
        segments = int(seg[-1]) + 1
        log(f"  {'+'.join(plan.columns)}{' where ' + plan.where if plan.where else ''}: "
            f"{n} keys, {segments} segments; sort {sort_ms:.3f} ms, whole finalize "
            f"{finalize_ms:.3f} ms; counts from segment starts {a:.3f} ms, "
            f"scatter_add_ of ones {b:.3f} ms")
        del srt, boundary, seg

    # the dense per-batch scatter: lanes spread against one plain
    # scatter_add_, at the dense plans' padded widths
    log("grouping: dense per-batch count forms (CUDA events, median, one batch):")
    cat_codes = dataset.device_column(ColumnRequest("i_category", "codes"), engine.device)[:batch]
    store_codes = dataset.device_column(ColumnRequest("ss_store_sk", "codes"), engine.device)[:batch]
    shapes = {
        "i_category (11 slots, 16 padded)": (cat_codes + 1, 16),
        "ss_store_sk (403 slots, 512 padded)": (store_codes + 1, 512),
        "i_category x ss_store_sk (4433 slots, 8192 padded)":
            ((cat_codes + 1) * (SF100_STORES + 1) + store_codes + 1, 8192),
    }
    for label, (code, padded) in shapes.items():
        code = code.to(torch.int32)
        ones = torch.ones((), dtype=torch.int32, device=code.device).expand(code.shape)
        long_code = code.to(torch.int64)

        def plain():
            return torch.zeros(padded, dtype=torch.int32, device=code.device).scatter_add_(
                0, long_code, ones)

        want = plain()
        check(torch.equal(_spread(torch, code, padded), want)
              and torch.equal(grouping_mod.dense_counts(code, padded), want),
              f"dense count forms differ at {label}")
        spread_ms = median_ms(torch, lambda: _spread(torch, code, padded), iters=10)
        plain_ms = median_ms(torch, plain, iters=10)
        kept = "spread" if padded <= grouping_mod.SPREAD_MAX_SLOTS else "plain"
        log(f"  {label}: spread over {grouping_mod._LANES} lanes {spread_ms:.4f} ms, "
            f"plain scatter_add_ {plain_ms:.4f} ms (the path takes the {kept} form)")


def _spread(torch, code, padded):
    """The lane-spread per-batch count at any width (the path takes it
    up to SPREAD_MAX_SLOTS; timed past it too)."""
    from deequ_tpu_torch.analyzers import grouping as grouping_mod

    lanes = grouping_mod._LANES
    code = code.to(torch.int64)
    lane = torch.arange(code.shape[0], dtype=torch.int64, device=code.device) & (lanes - 1)
    ones = torch.ones((), dtype=torch.int32, device=code.device).expand(code.shape)
    spread = torch.zeros(padded * lanes, dtype=torch.int32, device=code.device)
    spread.scatter_add_(0, code * lanes + lane, ones)
    return spread.view(padded, lanes).sum(dim=1, dtype=torch.int32)


def f32_like_xla(np, values):
    """A column as the KLL step's float32 lanes, in numpy: float64 values
    whose float32 would be subnormal flush to a zero of their sign."""
    x = values.astype(np.float32)
    if values.dtype == np.float64:
        x = np.where(np.abs(values) < FTZ_LIMIT, np.copysign(np.float32(0.0), x), x)
    return x


def f32_like_xla_torch(torch, values):
    """``f32_like_xla`` on the card: a column as the KLL step's float32
    lanes, float64 values whose float32 would be subnormal flushed to a
    zero of their sign."""
    x = values.to(torch.float32)
    if values.dtype == torch.float64:
        x = torch.where(values.abs() < FTZ_LIMIT, torch.copysign(torch.zeros_like(x), x), x)
    return x


def fmix32(h: int) -> int:
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & 0xFFFFFFFF
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & 0xFFFFFFFF
    return h ^ (h >> 16)


def kll_step_numpy(np, values, valid, k):
    """The KLL per-batch step of one column on the host, a plain version
    written apart from the package: stable sort on a key with zeros and
    subnormals as +0.0, the fmix32-seeded offset, k strided samples."""
    x = f32_like_xla(np, values)
    m = valid & np.isfinite(x)
    xm = np.where(m, x, np.float32(np.inf))
    key = np.where(np.abs(xm) < np.finfo(np.float32).tiny, np.float32(0.0), xm)
    order = np.argsort(key, kind="stable")
    nv = int(m.sum())
    level = max(-(-nv // k) - 1, 0).bit_length()
    stride = 1 << level
    offset = fmix32(nv ^ int(xm[order[0]].view(np.uint32))) & (stride - 1)
    idx = offset + np.arange(k, dtype=np.int64) * stride
    samples = xm[order[np.clip(idx, 0, len(xm) - 1)]]
    mn = float(key[m].min()) if nv else math.inf
    mx = float(key[m].max()) if nv else -math.inf
    return samples, idx < nv, nv, mn, mx, level


def sketch_checks(T, np, cols, rows):
    """The sketch, type, pattern and schema constraints of the main
    suite, each holding what numpy computes from the host columns where
    the value is exact; the quantiles' ranks are held after the run
    (``check_sketch_states``). Returns the check and the KLL columns by
    filter: {where: {column: [quantiles]}}."""
    cat = cols["i_category"]
    valid_cat = cat >= 0
    q = cols["ss_quantity"]
    q_valid = ~np.ma.getmaskarray(q)
    price = cols["ss_sales_price"]
    price32 = f32_like_xla(np, np.asarray(price.data)[~np.ma.getmaskarray(price)])
    picked = np.isin(cat, [CATEGORIES.index(c) for c in ("Books", "Music", "Sports")])

    both_stores = (~np.ma.getmaskarray(cols["ss_customer_sk"])
                   & ~np.ma.getmaskarray(cols["ss_store_sk"]))
    want = {
        "string_share": float(valid_cat.sum()) / rows,
        "integral_share": float(q_valid.sum()) / rows,
        "pattern": float(picked.sum()) / rows,
        "both_stores": float(both_stores.sum()) / rows,
        "price_max": float(price32.max()),
        "price_valid": int(len(price32)),
    }
    log(f"main: expected types, patterns and completeness {want}")
    kll_columns = {
        None: {"ss_sales_price": [0.5], "ss_net_profit": [0.99],
               "ss_wholesale_cost": [0.5], "ss_quantity": [0.5]},
        BOOKS: {"ss_sales_price": [0.5], "ss_net_profit": [0.5]},
    }
    check_ = T.Check(T.CheckLevel.ERROR, "sketches, types and patterns")
    for where, columns in kll_columns.items():
        for c, quantiles in columns.items():
            for quantile in quantiles:
                check_ = check_.has_approx_quantile(c, quantile, lambda v: math.isfinite(v))
                if where is not None:
                    check_ = check_.where(where)
    check_ = (
        check_.kll_sketch_satisfies(
            "ss_sales_price",
            lambda d: len(d.buckets) == 100 and d.buckets[-1].high_value == want["price_max"]
            and sum(b.count for b in d.buckets) in range(want["price_valid"] - 100,
                                                          want["price_valid"] + 101))
        .has_approx_count_distinct("ss_sales_price", lambda v: 0 < v < 1.1 * 20_000)
        .has_approx_count_distinct("ss_wholesale_cost", lambda v: 0 < v < 1.1 * 20_000)
        .has_data_type("i_category", T.checks.ConstrainableDataTypes.STRING,
                       lambda v: v == want["string_share"])
        .has_data_type("ss_quantity", T.checks.ConstrainableDataTypes.INTEGRAL,
                       lambda v: v == want["integral_share"])
        .has_pattern("i_category", r"^(Books|Music|Sports)$", lambda v: v == want["pattern"])
        .contains_email("i_category", lambda v: v == 0.0)
        .has_column_count(lambda n: n == len(cols))
        .are_complete(["ss_item_sk", "ss_ticket_number"])
        .have_completeness(["ss_customer_sk", "ss_store_sk"],
                           lambda v: v == want["both_stores"])
        .are_any_complete(["ss_customer_sk", "ss_item_sk"])
    )
    return check_, kll_columns


def check_sketch_states(T, np, cols, rows, batch, nb, states, recorded, kll_columns):
    """KLL: the first and the ragged last batch's outputs against the
    numpy step; every column's sketch against a host replay of all its
    batches' outputs; each quantile's rank in the exact (float32-cast,
    filtered) column within the rank-error bound E, where E sums the
    stride of every batch (a strided sample misranks any value by less
    than one stride) and 2^h for every compaction at level h (the
    replay counts them). DataType counts exactly against numpy."""
    from deequ_tpu_torch.sketches.kll import KLLParameters

    k = KLLParameters().sketch_size
    cat = cols["i_category"]
    books = cat == CATEGORIES.index("Books")
    worst = 0.0
    units = {where: set(columns) for where, columns in recorded}
    check(units == {w: set(c) for w, c in kll_columns.items()},
          f"KLL units {units}, expected one group a filter over {kll_columns}")
    for (where, columns), outs in recorded.items():
        check(len(outs) == nb, f"KLL unit {where!r} {columns}: {len(outs)} folds for {nb} batches")
        keep = books if where == BOOKS else np.ones(rows, dtype=bool)
        for i, c in enumerate(columns):
            col = cols[c]
            values = np.asarray(col.data)
            valid = ~np.ma.getmaskarray(col) & keep
            for b in (0, nb - 1):
                sl = slice(b * batch, min((b + 1) * batch, rows))
                want = kll_step_numpy(np, values[sl], valid[sl], k)
                got = [leaf[i] for leaf in outs[b]]
                check(np.array_equal(got[0].view(np.uint32), want[0].view(np.uint32))
                      and np.array_equal(got[1], want[1]) and int(got[2]) == want[2]
                      and int(got[5]) == want[5],
                      f"KLL output of {c} ({where!r}), batch {b}, differs from the numpy step")
                check(float(got[3]) == want[3] and float(got[4]) == want[4],
                      f"KLL min/max of {c} ({where!r}), batch {b}: {got[3:5]} vs {want[3:5]}")
            replay, bound = kll_replay(outs, i)
            x = f32_like_xla(np, values[valid]).astype(np.float64)
            x = x[np.isfinite(x)]
            n = len(x)
            for quantile in kll_columns[where][c]:
                analyzer = T.ApproxQuantile(c, quantile, where=where)
                state = states[analyzer]
                check(all(np.array_equal(a, b) for a, b in zip(
                    state.to_arrays().values(), replay.to_arrays().values())),
                      f"sketch of {c} ({where!r}) differs from the replay of its outputs")
                check(state.count == n, f"sketch count of {c}: {state.count} vs {n}")
                v = state.quantile(quantile)
                lo, hi = int((x < v).sum()), int((x <= v).sum())
                target = quantile * n
                check(lo <= target + bound and hi >= target - bound,
                      f"quantile {quantile} of {c} ({where!r}) = {v}: exact ranks "
                      f"[{lo}, {hi}] vs {target} +- {bound}")
                err = max(lo - target, target - hi, 0) / n
                worst = max(worst, err)
                log(f"main: ApproxQuantile({c}, {quantile}, where={where!r}) = {v!r}: rank "
                    f"error {err:.6f} of n = {n}, bound {bound / n:.6f} ({nb} batches' "
                    f"strides, {replay.compaction_weight} from compactions)")
    log(f"main: KLL outputs of batches 0 and {nb - 1} equal the numpy step for "
        f"{sum(len(c) for _, c in recorded)} columns; sketches equal their replays; "
        f"worst quantile rank error {worst:.6f}")
    for column, bucket in (("i_category", 4), ("ss_quantity", 2)):
        col = cols[column]
        n_valid = int((col >= 0).sum()) if column == "i_category" else int(
            (~np.ma.getmaskarray(col)).sum())
        want = [0] * 6
        want[0], want[bucket] = rows - n_valid, n_valid
        got = states[T.DataType(column)].counts.tolist()
        check(got == want, f"DataType counts of {column}: {got} vs {want}")
    log("main: DataType counts equal numpy's")


def filter_checks(T, np, cols, rows, close):
    """The filter and predicate constraints of the main suite, each
    holding the value numpy computes from the host columns: Compliance
    through the Check methods, ``where=`` on the stats, completeness
    and HLL groups, correlation and string lengths."""

    def valid(c):
        return ~np.ma.getmaskarray(cols[c])

    def data(c):
        return np.asarray(cols[c].data)

    cat = cols["i_category"]
    books = cat == CATEGORIES.index("Books")
    qv, q = valid("ss_quantity"), data("ss_quantity")
    profit_v, profit = valid("ss_net_profit"), data("ss_net_profit")
    price_v, price = valid("ss_sales_price"), data("ss_sales_price")
    ext_v, ext = valid("ss_ext_sales_price"), data("ss_ext_sales_price")
    store_v = valid("ss_store_sk")

    def share(hits):
        return float(hits.sum()) / rows

    lengths = np.array([len(c) for c in CATEGORIES])[cat[cat >= 0]]
    both = price_v & ext_v
    corr = float(np.corrcoef(price[both], ext[both])[0, 1])
    want = {
        "in_range": share(qv & (q >= 1) & (q <= 100)),
        "non_negative": share(~price_v | (price >= 0)),
        "positive": share(~qv | (q > 0)),
        "books_loss": share(books & profit_v & (profit < 0)),
        "completeness": float((valid("ss_customer_sk") & store_v).sum()) / store_v.sum(),
    }
    log(f"main: expected compliance {want}, correlation {corr!r}, lengths "
        f"[{lengths.min()}, {lengths.max()}]")
    check_ = (
        T.Check(T.CheckLevel.ERROR, "filters and predicates")
        .satisfies("ss_quantity BETWEEN 1 AND 100", "quantity in range",
                   lambda v: v == want["in_range"])
        .is_non_negative("ss_sales_price", lambda v: v == want["non_negative"])
        .is_positive("ss_quantity", lambda v: v == want["positive"])
        .is_contained_in("i_category", CATEGORIES)
        .satisfies("i_category = 'Books' AND ss_net_profit < 0", "loss-making books",
                   lambda v: v == want["books_loss"])
        .has_completeness("ss_customer_sk", lambda v: v == want["completeness"])
        .where("ss_store_sk IS NOT NULL")
        .has_correlation("ss_sales_price", "ss_ext_sales_price",
                         lambda v: close(v, corr, RTOL_F64))
        .has_min_length("i_category", lambda v: v == lengths.min())
        .has_max_length("i_category", lambda v: v == lengths.max())
    )
    for c, c_valid, c_data in (("ss_sales_price", price_v, price),
                               ("ss_ext_sales_price", ext_v, ext)):
        vals = c_data[books & c_valid].astype(np.float64)
        check_ = (
            check_.has_mean(c, lambda v, m=float(vals.mean()): close(v, m, RTOL_F64))
            .where("i_category = 'Books'")
            .has_sum(c, lambda v, m=float(vals.sum()): close(v, m, RTOL_F64))
            .where("i_category = 'Books'")
        )
    kept = int((qv & (q > 50)).sum())
    for c in ("ss_item_sk", "ss_customer_sk"):
        check_ = check_.has_approx_count_distinct(
            c, lambda v: 0 < v < 1.1 * kept).where("ss_quantity > 50")
    return check_


# -- phase 5 ----------------------------------------------------------------


def probe_phase():
    """The port's scatter probe, in-process, in default and --prod mode
    at full width; returns the P1-P3 launches of this run, and K1's
    (idx, rho) launches (``--prod`` holds that entry, which the main path
    no longer takes)."""
    from deequ_tpu_torch.sketches import scatter_max as sm
    from deequ_tpu_torch.tools import probe_kernels as pk
    from deequ_tpu_torch.tools import scatter_probe

    for kernel in pk.launches:
        pk.launches[kernel] = 0
    sm.launches = 0
    records = [scatter_probe.run(["--b", "21"]),
               scatter_probe.run(["--prod", "--cols", "40", "--b", "21"])]
    launches = dict(pk.launches, hll_scatter_max=sm.launches)
    for record in records:
        wrong = [n for n, v in record["variants"].items() if not v["bit_identical"]]
        check(not wrong, f"probe {record['mode']}: {wrong} differ from the library scatter")
    for kernel, n in launches.items():
        check(n > 0, f"the probe launched {kernel} no time")
    log(f"probe: every variant bit-identical in both modes; launches {launches}")
    return launches


# -- phase 6 ----------------------------------------------------------------

SF100_DATES = (2_450_816, 2_452_642)  # d_date_sk of the sales dates
SF100_TIMES = (28_800, 75_599)  # t_time_sk of the store hours
SF100_CDEMOS = 1_920_800
SF100_HDEMOS = 7_200
SF100_ADDRESSES = 1_000_000
SF100_PROMOS = 1_000
# item is a slowly changing dimension: about two surrogate keys a
# business key, so 204,000 items carry 102,000 i_item_id values
SF100_ITEM_IDS = SF100_ITEMS // 2
ZIPS = 5_000  # distinct ca_zip values over the addresses
TEST_RATIO = 0.2  # the suggestion run's holdout
SPLIT_SEED = 42  # the suggestion runner's default split seed
# the percentiles a numeric profile holds
PERCENTILES = tuple(round(q / 100.0, 2) for q in range(1, 100))


def item_id(k: int) -> str:
    """A 16-character TPC-DS business key: AAAAAAAA and eight letters
    A-P spelling ``k`` in base 16, least significant first."""
    return "AAAAAAAA" + "".join(chr(65 + ((k >> (4 * j)) & 15)) for j in range(8))


def store_sales_full(T, np, rows: int, seed: int):
    """Every column of TPC-DS store_sales (spec v3, section 2.3.12) at
    SF100's key domains, about 4% nulls in every column the spec lets be
    null, and three columns joined in as codes and dictionaries:
    i_category and i_item_id from item, ca_zip from customer_address
    through ss_addr_sk. The decimal(7,2) columns are cents in float64
    (float32 for ss_wholesale_cost), derived as the spec's pricing does."""
    rng = np.random.default_rng(seed)

    def nulls():
        return rng.random(rows, dtype=np.float32) < NULL_SHARE

    def key(lo, hi, nullable=True):
        values = rng.integers(lo, hi + 1, rows)
        return np.ma.array(values, mask=nulls()) if nullable else values

    def cents(values, nullable=True):
        values = np.round(values, 2)
        return np.ma.array(values, mask=nulls()) if nullable else values

    item = key(1, SF100_ITEMS, nullable=False)
    addr = key(1, SF100_ADDRESSES)
    cols = {
        "ss_sold_date_sk": key(*SF100_DATES),
        "ss_sold_time_sk": key(*SF100_TIMES),
        "ss_item_sk": item,
        "ss_customer_sk": key(1, SF100_CUSTOMERS),
        "ss_cdemo_sk": key(1, SF100_CDEMOS),
        "ss_hdemo_sk": key(1, SF100_HDEMOS),
        "ss_addr_sk": addr,
        "ss_store_sk": key(1, SF100_STORES),
        "ss_promo_sk": key(1, SF100_PROMOS),
        "ss_ticket_number": np.arange(rows, dtype=np.int64) // 12 + 1,
    }
    quantity = rng.integers(1, 101, rows, dtype=np.int32)
    cols["ss_quantity"] = np.ma.array(quantity, mask=nulls())
    wholesale = np.round(rng.uniform(1.0, 100.0, rows), 2)
    cols["ss_wholesale_cost"] = np.ma.array(wholesale.astype(np.float32), mask=nulls())
    list_price = np.round(wholesale * rng.uniform(1.0, 2.0, rows), 2)
    cols["ss_list_price"] = cents(list_price)
    sales_price = np.round(list_price * rng.uniform(0.0, 1.0, rows), 2)
    cols["ss_sales_price"] = cents(sales_price)
    cols["ss_ext_discount_amt"] = cents((list_price - sales_price) * quantity)
    ext_sales = np.round(sales_price * quantity, 2)
    cols["ss_ext_sales_price"] = cents(ext_sales)
    ext_wholesale = np.round(wholesale * quantity, 2)
    cols["ss_ext_wholesale_cost"] = cents(ext_wholesale)
    cols["ss_ext_list_price"] = cents(list_price * quantity)
    tax = np.round(ext_sales * rng.uniform(0.0, 0.09, rows), 2)
    cols["ss_ext_tax"] = cents(tax)
    coupon = np.round(ext_sales * np.where(rng.random(rows, dtype=np.float32) < 0.2,
                                           rng.uniform(0.0, 1.0, rows), 0.0), 2)
    cols["ss_coupon_amt"] = cents(coupon)
    net_paid = np.round(ext_sales - coupon, 2)
    cols["ss_net_paid"] = cents(net_paid)
    cols["ss_net_paid_inc_tax"] = cents(net_paid + tax)
    cols["ss_net_profit"] = cents(net_paid - ext_wholesale)
    del wholesale, list_price, sales_price, ext_sales, ext_wholesale, tax, coupon, net_paid

    category = rng.integers(0, len(CATEGORIES), SF100_ITEMS + 1).astype(np.int32)
    category[rng.random(SF100_ITEMS + 1) < NULL_SHARE] = -1
    cols["i_category"] = T.DictionaryColumn(category[item], np.array(CATEGORIES, dtype=object))
    cols["i_item_id"] = T.DictionaryColumn(
        ((item - 1) // 2).astype(np.int32),
        np.array([item_id(k) for k in range(SF100_ITEM_IDS)], dtype=object))
    zips = np.array([f"{z:05d}" for z in rng.choice(100_000, ZIPS, replace=False)], dtype=object)
    zip_of_address = rng.integers(0, ZIPS, SF100_ADDRESSES + 1).astype(np.int32)
    zip_codes = zip_of_address[np.asarray(addr.data)]
    zip_codes[np.ma.getmaskarray(addr)] = -1
    cols["ca_zip"] = T.DictionaryColumn(zip_codes, zips)
    return cols


def plain_registers(torch, np, dataset, col, device, keep=None):
    """The HLL registers of a whole column by the plain versions: the
    hash, the rank and the plain scatter-max, 2^24 rows at a time."""
    from deequ_tpu_torch.data.table import ColumnRequest
    from deequ_tpu_torch.sketches import hll, scatter_max as sm

    rows = dataset.num_rows
    string = dataset.schema.kind_of(col).value == "String"
    if string:
        codes = dataset.device_column(ColumnRequest(col, "codes"), device)
        lut1, lut2 = (torch.from_numpy(h.astype(np.int64)).to(device)
                      for h in hll.dictionary_hash_pairs(dataset.dictionary(col)))
    else:
        values = dataset.device_column(ColumnRequest(col, dataset.hll_repr(col)), device)
    mask = dataset.device_column(ColumnRequest(col, "mask"), device)
    if keep is not None:
        mask = mask & torch.from_numpy(keep).to(device)
    regs = torch.zeros(hll.M, dtype=torch.int32, device=device)
    step = 1 << 24
    for s in range(0, rows, step):
        m = mask[s:s + step]
        if string:
            c = codes[s:s + step].long().clamp(min=0)
            h1, h2 = lut1[c], lut2[c]
        else:
            h1, h2 = hll.hash_pair_numeric(values[s:s + step])
        idx, rho = hll.index_and_rank(h1, h2, m)
        regs = torch.maximum(regs, sm.scatter_max_plain(idx[None], rho[None], hll.M)[0])
    return regs.to(torch.int8).cpu()


def k1_expected(T, dataset, columns, batch, nb, sms, label):
    """K1's launches over ``nb`` batches by the planner's HLL units over
    ``columns``: one fused launch a numeric unit a batch, one codes
    launch a string unit a batch, in the form its padded D picks."""
    from deequ_tpu_torch.engine import vectorize
    from deequ_tpu_torch.sketches import scatter_max as sm

    units, _ = vectorize.plan_scan_units(
        dataset, [T.ApproxCountDistinct(c) for c in columns])
    per_batch = {"hll_scatter_max": 0, "hll_update": 0, "hll_update_codes": 0,
                 "hll_update_codes_rows": 0}
    for unit in units:
        if unit.requests[0].repr != "codes":
            per_batch["hll_update"] += 1
            continue
        # a delta unit carries its tables in its state, at the capacity
        luts = unit.ops.consts if unit.ops.consts is not None else unit.ops.init()
        width = luts["h1"].shape[1]
        bitmap = sm.plan_codes(len(unit.members), batch, width, sms).bitmap
        per_batch["hll_update_codes" if bitmap else "hll_update_codes_rows"] += 1
        log(f"{label}: codes unit over {[a.column for a in unit.members]}, D={width} "
            f"({'bitmap' if bitmap else 'rows'} form)")
    return {k: v * nb for k, v in per_batch.items()}


def k1_launches():
    """K1's launch counts by entry, from the wrappers' counters."""
    from deequ_tpu_torch.sketches import scatter_max as sm

    return {"hll_scatter_max": sm.launches, "hll_update": sm.fused_launches,
            "hll_update_codes": sm.codes_launches - sm.codes_rows_launches,
            "hll_update_codes_rows": sm.codes_rows_launches}


def kll_replay(outs, i):
    """A column's sketch replayed from every batch's fetched output, in
    fold order, and its rank-error bound: the stride of every batch (a
    strided sample misranks a value by less than one stride) plus 2^h
    for every compaction at level h."""
    from deequ_tpu_torch.analyzers.kll import kll_fold
    from deequ_tpu_torch.sketches.kll import KLLParameters, KLLSketchState

    class CountingSketch(KLLSketchState):
        compaction_weight = 0

        def _compact_level(self, level):
            self.compaction_weight += 1 << level
            super()._compact_level(level)

    replay = CountingSketch(KLLParameters())
    strides = 0
    for out in outs:
        kll_fold(replay, out, i)
        strides += (1 << int(out[5][i])) if int(out[2][i]) else 0
    return replay, strides + replay.compaction_weight


def profile_phase(torch, np, rows: int, seed: int):
    """Phase 6: the ColumnProfiler and constraint suggestion at full width
    (see the module docstring); returns the K1 launches of the first
    profile, the codes rows form's kernel record and the table, which
    phase 7 streams."""
    import gc

    import deequ_tpu_torch as T
    from deequ_tpu_torch.analyzers import kll as kll_mod
    from deequ_tpu_torch.analyzers import runner as runner_mod
    from deequ_tpu_torch.data import table as table_mod
    from deequ_tpu_torch.data.table import ColumnRequest
    from deequ_tpu_torch.engine import vectorize
    from deequ_tpu_torch.profiles import profiler as profiler_mod
    from deequ_tpu_torch.sketches import hll, scatter_max as sm

    gc.collect()
    torch.cuda.empty_cache()
    log(f"profile: {torch.cuda.memory_allocated() / 2**30:.2f} GiB on the device before phase 6 "
        "(phase 4's dataset and engine freed)")
    log(f"profile: the full store_sales row (23 columns) with i_category, i_item_id and ca_zip "
        f"joined in, {rows} rows (cut from SF100's {SF100_ROWS} rows to fit the time limit)")
    t0 = time.perf_counter()
    data = store_sales_full(T, np, rows, seed)
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    dataset = T.Dataset.from_pydict(data)
    del data
    gc.collect()
    t_ds = time.perf_counter() - t0
    columns = dataset.schema.column_names
    strings = [c for c in columns if dataset.schema.kind_of(c).value == "String"]
    numeric = [c for c in columns if c not in strings]
    log(f"profile: generate {t_gen:.3f} s, Dataset {t_ds:.3f} s; {len(columns)} columns, "
        f"{len(numeric)} numeric, strings {strings}")

    def host(c, rep):
        return dataset.materialize(ColumnRequest(c, rep))

    engine = T.AnalysisEngine()
    device = engine.device
    batch = engine._resolve_batch_size(rows)
    nb = -(-rows // batch)
    sms = torch.cuda.get_device_properties(device).multi_processor_count

    expected = k1_expected(T, dataset, columns, batch, nb, sms, "profile")

    # instrument the first profile: every pass's states, every KLL unit's
    # per-batch outputs, and the host LUT and dictionary builds
    states, recorded, host_s = {}, {}, {}

    class Keep:
        def persist(self, analyzer, state):
            states[analyzer] = state

    run_pass = runner_mod.AnalysisRunner.__dict__["do_analysis_run"]
    build_kll, make_kll = vectorize._build_kll_group, kll_mod._make_kll_ops
    buckets, hash_pairs, encode = vectorize.dictionary_buckets, hll.dictionary_hash_pairs, T.Dataset._encode
    probe_range, cast = T.Dataset.integral_range, profiler_mod._cast_string_columns
    dense_encode = table_mod._first_seen_dense

    def keeping_pass(data_, analyzers, **kwargs):
        kwargs.setdefault("save_states_with", Keep())
        return run_pass.__func__(data_, analyzers, **kwargs)

    def record(columns_, ops, where):
        outs = recorded.setdefault((where, tuple(columns_)), [])
        fold = ops.host_fold

        def host_fold(acc, out):
            outs.append(out)
            return fold(acc, out)

        ops.host_fold = host_fold

    def recording_build(dataset_, members, where):
        unit = build_kll(dataset_, members, where)
        record(vectorize._index_members(members)[0], unit.ops, where)
        return unit

    def recording_make(analyzer, dataset_, params):
        ops = make_kll(analyzer, dataset_, params)
        record([analyzer.column], ops, analyzer.where)
        return ops

    def timed(name, fn, label):
        def run(*args):
            t = time.perf_counter()
            out = fn(*args)
            host_s.setdefault(name, []).append((label(args), time.perf_counter() - t))
            return out
        return run

    def entries(args):
        return f"{len(args[0])} entries"

    sm.launches = sm.fused_launches = sm.codes_launches = sm.codes_rows_launches = 0
    runner_mod.AnalysisRunner.do_analysis_run = staticmethod(keeping_pass)
    vectorize._build_kll_group, kll_mod._make_kll_ops = recording_build, recording_make
    vectorize.dictionary_buckets = timed("DataType buckets", buckets, entries)
    hll.dictionary_hash_pairs = timed("HLL hash words", hash_pairs, entries)
    T.Dataset._encode = timed("dictionary encode", encode, lambda args: args[1])
    T.Dataset.integral_range = timed("integral range", probe_range, lambda args: args[1])
    profiler_mod._cast_string_columns = timed("numeric cast", cast, lambda args: args[1])
    table_mod._first_seen_dense = timed(
        "direct-address encode", dense_encode, lambda args: f"span {args[2]}")
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        profiles = T.ColumnProfilerRunner().on_data(dataset).with_engine(engine).run()
        torch.cuda.synchronize()
        t_first = time.perf_counter() - t0
    finally:
        runner_mod.AnalysisRunner.do_analysis_run = run_pass
        vectorize._build_kll_group, kll_mod._make_kll_ops = build_kll, make_kll
        vectorize.dictionary_buckets, hll.dictionary_hash_pairs = buckets, hash_pairs
        T.Dataset._encode, T.Dataset.integral_range = encode, probe_range
        profiler_mod._cast_string_columns, table_mod._first_seen_dense = cast, dense_encode
    peak_first = torch.cuda.max_memory_allocated() / 2**30
    launches = {"hll_scatter_max": sm.launches, "hll_update": sm.fused_launches,
                "hll_update_codes": sm.codes_launches - sm.codes_rows_launches,
                "hll_update_codes_rows": sm.codes_rows_launches}
    check(launches == expected, f"profile K1 launches {launches}, the planner's {expected}")
    check(engine.stream_stats is None, "the profile's passes streamed: they must stay resident "
          "under the phase's budget")
    check(engine.data_passes == 2, f"profile data_passes == {engine.data_passes}: expected "
          "pass 1 and pass 2 (ca_zip), no pass 3")
    passes = profiles.run_metadata.as_records()
    check(len(passes) == 2, f"profile passes {passes}")
    log_profile_run("first profile", profiles, t_first, rows)
    log(f"profile: K1 launches {launches} (the planner's counts), {nb} batches of {batch} rows; "
        f"first profile's peak device memory {peak_first:.2f} GiB")
    for name, calls in host_s.items():
        log(f"profile: host {name}: " + ", ".join(f"{k} {s:.3f} s" for k, s in calls)
            + f" ({sum(s for _, s in calls):.3f} s)")
    check([k for k, _ in host_s.get("direct-address encode", [])] == ["span 100"],
          "ss_quantity's dictionary was not built by the direct-address form")

    t0 = time.perf_counter()
    check_profiles(torch, np, T, dataset, profiles, states, recorded, rows, nb, device)
    log(f"profile: the checks against numpy took {time.perf_counter() - t0:.3f} s")

    # the rerun on the resident columns
    def rerun():
        out = T.ColumnProfilerRunner().on_data(dataset).with_engine(engine).run()
        torch.cuda.synchronize()
        return out

    t0 = time.perf_counter()
    again = rerun()
    t_rerun = time.perf_counter() - t0
    log_profile_run("rerun", again, t_rerun, rows)
    for c in columns:
        check(again[c] == profiles[c], f"the rerun's profile of {c} differs from the first")

    record_ = rows_kernel_record(torch, np, dataset, strings, batch, device)

    # constraint suggestion with the default rules and a 20% holdout
    passes0 = engine.data_passes
    filter_rows, filter_s = T.Dataset.filter_rows, []

    def timed_filter(self, mask):
        t = time.perf_counter()
        out = filter_rows(self, mask)
        filter_s.append(time.perf_counter() - t)
        return out

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    T.Dataset.filter_rows = timed_filter
    try:
        t0 = time.perf_counter()
        result = (
            T.ConstraintSuggestionRunner().on_data(dataset).add_constraint_rules(T.DEFAULT_RULES)
            .use_train_test_split_with_testset_ratio(TEST_RATIO).with_engine(engine).run()
        )
        torch.cuda.synchronize()
        t_suggest = time.perf_counter() - t0
    finally:
        T.Dataset.filter_rows = filter_rows
    peak_suggest = torch.cuda.max_memory_allocated() / 2**30
    suggestions = result.all_suggestions()
    by_rule = {}
    for s in suggestions:
        by_rule[s.suggesting_rule] = by_rule.get(s.suggesting_rule, 0) + 1
    log(f"suggest: {t_suggest:.3f} s (the host row filter of the train and test splits "
        f"{' + '.join(f'{s:.3f}' for s in filter_s)} s), {engine.data_passes - passes0} data "
        f"passes, peak device memory {peak_suggest:.2f} GiB; {len(suggestions)} suggestions "
        f"{by_rule}")
    log_profile_run("suggestion's train profile", result.column_profiles, None, rows)
    t0 = time.perf_counter()
    for s in suggestions:
        log(f"  {s.code_for_constraint}")
    check_holdout(np, dataset, result, rows)
    log(f"suggest: the holdout checks against numpy took {time.perf_counter() - t0:.3f} s")
    return launches, record_, dataset


def log_profile_run(label, profiles, wall_s, rows):
    """Each pass's wall time and rows/s, and the upload, scan and host
    fold seconds of the run's scans."""
    meta = profiles.run_metadata
    phases = [e for e in meta.events if e.get("event") == "scan_phases"]
    upload = sum(e["resident_s"] for e in phases)
    scan = sum(e["scan_s"] for e in phases)
    fold = sum(e["fold_s"] for e in phases)
    total = "" if wall_s is None else (
        f"{wall_s:.3f} s, {rows / wall_s:.0f} rows/s ({wall_s - meta.total_wall_s:.3f} s "
        "outside the passes); ")
    log(f"profile ({label}): {total}upload {upload:.3f} s, scan {scan:.3f} s, host fold "
        f"{fold:.3f} s; passes " + "; ".join(
            f"{p['pass']} {p['wall_s']:.3f} s over {p['rows']} rows ({p['rows_per_sec']:.0f} "
            f"rows/s, {p['num_analyzers']} analyzers)" for p in meta.as_records()))


def check_profiles(torch, np, T, dataset, profiles, states, recorded, rows, nb, device):
    """Every field of the profile against a plain computation over the
    whole columns: counts and histograms by numpy on the host; the
    distinct counts, the numeric statistics and the percentiles' ranks
    by plain float64 reductions and an exact sort on the card, over the
    columns already resident there (numpy would take minutes at 100M
    rows). Each part's seconds are logged."""
    from collections import defaultdict

    from deequ_tpu_torch.data.table import ColumnRequest

    seconds = defaultdict(float)

    class part:
        def __init__(self, name):
            self.name = name

        def __enter__(self):
            self.t0 = time.perf_counter()

        def __exit__(self, *exc):
            seconds[self.name] += time.perf_counter() - self.t0

    def host(c, rep):
        return dataset.materialize(ColumnRequest(c, rep))

    def on_card(c, rep):
        return dataset.device_column(ColumnRequest(c, rep), device)

    def close(a, b, rtol):
        return math.isclose(a, b, rel_tol=rtol, abs_tol=rtol)

    check(profiles.num_records == rows, f"num_records {profiles.num_records}")
    columns = dataset.schema.column_names
    check(list(profiles.profiles) == columns, "profiled columns differ from the table's")
    zip_values = None
    for c in columns:
        p = profiles[c]
        with part("completeness and types"):
            mask = host(c, "mask")
            check(p.completeness == float(mask.sum()) / rows, f"completeness of {c}")
            kind = dataset.schema.kind_of(c).value
            if kind == "String":
                codes = host(c, "codes")
                dictionary = dataset.dictionary(c)
                numeric_entry = np.array([bool(re.fullmatch(r"\d+", v)) for v in dictionary])
                counts = np.bincount(codes[codes >= 0], minlength=len(dictionary))
                n_int = int(counts[numeric_entry].sum())
                want_counts = {"Unknown": rows - int(mask.sum()), "Fractional": 0,
                               "Integral": n_int, "Boolean": 0,
                               "String": int(mask.sum()) - n_int}
                check(p.type_counts == want_counts,
                      f"type counts of {c}: {p.type_counts} vs {want_counts}")
                want_kind = "Integral" if c == "ca_zip" else "String"
                check(p.data_type.value == want_kind and p.is_data_type_inferred,
                      f"type of {c}: {p.data_type} (inferred {p.is_data_type_inferred})")
                if c == "ca_zip":
                    parsed = torch.tensor([float(v) for v in dictionary], dtype=torch.float64,
                                          device=device)
                    zip_codes = on_card(c, "codes")
                    zip_values = parsed[zip_codes[zip_codes >= 0].to(torch.int64)]
            else:
                check(p.data_type.value == kind and not p.is_data_type_inferred, f"type of {c}")
        # HLL: registers against the plain build, the estimate against
        # the exact distinct count (a sort on the card)
        with part("HLL registers against the plain build"):
            registers = states[T.ApproxCountDistinct(c)].registers
            check(torch.equal(registers, plain_registers(torch, np, dataset, c, device)),
                  f"HLL registers of {c} differ from the plain whole-column build")
        with part("exact distinct counts"):
            rep = "codes" if kind == "String" else dataset.hll_repr(c)
            exact = int(torch.unique(on_card(c, rep)[on_card(c, "mask")]).numel())
        err = abs(p.approximate_num_distinct_values - exact) / max(exact, 1)
        check(err <= 3 * 1.04 / math.sqrt(16384),
              f"HLL estimate of {c}: {p.approximate_num_distinct_values} vs exact {exact}")
        log(f"profile: {c}: completeness {p.completeness}, approx distinct "
            f"{p.approximate_num_distinct_values:.1f} (exact {exact}, error {err:.5f}), "
            f"type {p.data_type.value}")
    check(zip_values is not None, "ca_zip was not checked")

    # histograms: exactly the speculated low-cardinality columns
    with part("histograms"):
        quantity = host("ss_quantity", "values")[host("ss_quantity", "mask")]
        q_counts = np.bincount(quantity)
        want = {str(v): int(q_counts[v]) for v in np.nonzero(q_counts)[0]}
        want["NullValue"] = rows - len(quantity)
        cat = host("i_category", "codes")
        c_counts = np.bincount(cat + 1, minlength=len(CATEGORIES) + 1)
        want_cat = {name: int(c_counts[i + 1]) for i, name in enumerate(CATEGORIES)
                    if c_counts[i + 1]}
        want_cat["NullValue"] = int(c_counts[0])
        for c, w in (("ss_quantity", want), ("i_category", want_cat)):
            got = {k: v.absolute for k, v in profiles[c].histogram.values.items()}
            check(got == w, f"histogram of {c}: {got} vs {w}")
            check(all(v.ratio == v.absolute / rows
                      for v in profiles[c].histogram.values.values()),
                  f"histogram ratios of {c}")
        with_histogram = [c for c in columns if profiles[c].histogram is not None]
        check(with_histogram == ["ss_quantity", "i_category"], f"histograms of {with_histogram}")

    # numeric statistics and the 99 percentiles' ranks
    units = {}
    for (where, cols_), outs in recorded.items():
        check(where is None and len(outs) == nb, f"KLL unit {cols_}: {len(outs)} folds, {nb} batches")
        for i, c in enumerate(cols_):
            units[c] = (outs, i)
    numeric = [c for c in columns if dataset.schema.kind_of(c).value != "String"] + ["ca_zip"]
    check(sorted(units) == sorted(numeric), f"KLL columns {sorted(units)} vs {sorted(numeric)}")
    worst = 0.0
    for c in numeric:
        p = profiles[c]
        with part("statistics (float64 on the card)"):
            if c == "ca_zip":
                vals = zip_values
            else:
                vals = on_card(c, "values")[on_card(c, "mask")].to(torch.float64)
            mean = float(vals.mean())
            want = {"mean": mean, "sum": float(vals.sum()), "minimum": float(vals.min()),
                    "maximum": float(vals.max()),
                    "std_dev": math.sqrt(float(((vals - mean) ** 2).mean()))}
            rtol = RTOL_F32 if c == "ss_wholesale_cost" else RTOL_F64
            for field, w in want.items():
                got = getattr(p, field)
                ok = got == w if field in ("minimum", "maximum") else close(got, w, rtol)
                check(ok, f"{field} of {c}: {got!r} vs {w!r}")
        with part("KLL replays"):
            outs, i = units[c]
            replay, bound = kll_replay(outs, i)
            state = states[T.ApproxQuantiles(c, PERCENTILES)]
            check(all(np.array_equal(a, b) for a, b in zip(
                state.to_arrays().values(), replay.to_arrays().values())),
                  f"sketch of {c} differs from the replay of its outputs")
        with part("percentile ranks (sort on the card)"):
            x = f32_like_xla_torch(torch, vals).to(torch.float64)
            x = torch.sort(x[torch.isfinite(x)]).values
            n = int(x.numel())
            check(state.count == n, f"sketch count of {c}: {state.count} vs {n}")
            v = torch.tensor(p.approx_percentiles, dtype=torch.float64, device=device)
            lo = torch.searchsorted(x, v).cpu().numpy()
            hi = torch.searchsorted(x, v, right=True).cpu().numpy()
        target = np.array(PERCENTILES) * n
        check(bool(np.all(lo <= target + bound) and np.all(hi >= target - bound)),
              f"percentiles of {c}: exact ranks outside {target} +- {bound}")
        err = float(np.max(np.maximum(np.maximum(lo - target, target - hi), 0))) / n
        worst = max(worst, err)
        log(f"profile: {c}: stats equal the float64 reductions; 99 percentiles within the rank "
            f"bound {bound / n:.6f} (worst error {err:.6f})")
        del vals, x
    log(f"profile: every field checked; worst percentile rank error {worst:.6f}; seconds by "
        "part: " + ", ".join(f"{k} {v:.3f}" for k, v in seconds.items()))


def rows_kernel_record(torch, np, dataset, strings, batch, device):
    """K1's codes entry in its rows form at the path's shape: the first
    batch of the three string columns stacked against their padded
    dictionaries' hash words, bit for bit against the plain version,
    then timed."""
    from deequ_tpu_torch.data.table import ColumnRequest
    from deequ_tpu_torch.engine import vectorize
    from deequ_tpu_torch.sketches import hll, scatter_max as sm

    codes = torch.stack([dataset.device_column(ColumnRequest(c, "codes"), device)[:batch]
                         for c in strings])
    mask = torch.stack([dataset.device_column(ColumnRequest(c, "mask"), device)[:batch]
                        for c in strings])
    pairs = [hll.dictionary_hash_pairs(dataset.dictionary(c)) for c in strings]
    l1, l2 = (torch.from_numpy(vectorize._stack_luts([p[i] for p in pairs]).astype(np.int64))
              .to(device) for i in (0, 1))
    rows_mask = torch.ones(batch, dtype=torch.bool, device=device)
    C, B, D = codes.shape[0], codes.shape[1], l1.shape[1]
    check(not sm.plan_codes(C, B, D, torch.cuda.get_device_properties(device)
                            .multi_processor_count).bitmap, f"D={D} takes the bitmap form")
    gen = torch.Generator(device=device).manual_seed(2468)
    max_err = 0
    for carry in (torch.zeros((C, hll.M), dtype=torch.int8, device=device),
                  torch.randint(0, 20, (C, hll.M), generator=gen, device=device,
                                dtype=torch.int8)):
        got = sm.hll_update_codes(codes, mask, rows_mask, l1, l2, carry)
        want = sm.hll_update_codes_plain(codes, mask, rows_mask, l1, l2, carry)
        torch.cuda.synchronize()
        max_err = max(max_err, int((got.int() - want.int()).abs().max().item()))
        check(torch.equal(got, want), f"hll_update_codes (rows form) != plain at C={C} D={D}")

    def call():
        sm.hll_update_codes(codes, mask, rows_mask, l1, l2, carry)

    ms = median_ms(torch, call)
    plain_ms = median_ms(torch, lambda: sm.hll_update_codes_plain(
        codes, mask, rows_mask, l1, l2, carry), iters=10)
    dev_ms = device_ms(torch, call, "hll_codes_rows_kernel")
    present = sum(int(torch.unique(codes[i][mask[i]]).numel()) for i in range(C))
    log(f"hll_update_codes (rows form) at the path's shape C={C} B={B} D={D}: bit-equal, call "
        f"{ms:.4f} ms, device {dev_ms:.4f} ms, plain {plain_ms:.4f} ms; {present} entries present")
    return kernel_record(
        "hll_update_codes_rows", "deequ_tpu_torch/csrc/scatter_max.cu",
        "deequ_tpu/sketches/pallas_scatter.py:108", f"C={C} B={B} D={D} M={hll.M} (row mask)",
        max_err, ms, plain_ms, None,
        nbytes=C * B * 5 + B + 2 * C * hll.M + 16 * present, ops=C * B,
    )


def check_holdout(np, dataset, result, rows):
    """Each suggested constraint's result on the holdout against numpy's
    evaluation of the same constraint on the same held-out rows (the
    runner's split: ``default_rng(42).random(n) < 0.2``)."""
    from deequ_tpu_torch.data.table import ColumnRequest

    test = np.flatnonzero(np.random.default_rng(SPLIT_SEED).random(rows) < TEST_RATIO)
    n = len(test)
    check(result.column_profiles.num_records == rows - n,
          f"train rows {result.column_profiles.num_records} vs {rows - n}")
    vr = result.verification_result
    check(vr is not None, "the suggestion run verified nothing on the holdout")
    [check_result] = vr.check_results.values()
    suggestions = result.all_suggestions()
    check(len(check_result.constraint_results) == len(suggestions),
          "one constraint result a suggestion")

    held = {}  # the held-out rows of the column at hand (suggestions come by column)

    def host(c, rep):
        if (c, rep) not in held:
            if any(key[0] != c for key in held):
                held.clear()
            held[(c, rep)] = dataset.materialize(ColumnRequest(c, rep)).take(test)
        return held[(c, rep)]

    for s, cr in zip(suggestions, check_result.constraint_results):
        c, rule = s.column_name, s.suggesting_rule
        string = dataset.schema.kind_of(c).value == "String"
        mask = host(c, "mask")
        bound = re.search(r">= ([0-9.]+)\)$", s.code_for_constraint)
        bound = None if bound is None else float(bound.group(1))
        fails = None  # the error a constraint's metric must carry
        if rule in ("CompleteIfCompleteRule", "RetainCompletenessRule"):
            value = float(mask.sum()) / n
        elif rule == "RetainTypeRule":
            entries = dataset.dictionary(c)
            numeric_entry = np.array([bool(re.fullmatch(r"[+-]?\d+(\.\d*)?", v)) for v in entries])
            codes = host(c, "codes")
            value = int(numeric_entry[codes[codes >= 0]].sum()) / n
        elif rule in ("CategoricalRangeRule", "FractionalCategoricalRangeRule"):
            if not string:
                fails = "IN with string literals requires a string column"
            else:
                allowed = set(re.findall(r'"([^"]*)"', s.code_for_constraint)[1:])
                entries = dataset.dictionary(c)
                in_set = np.array([v in allowed for v in entries] + [False])
                codes = host(c, "codes")
                value = float((~mask | in_set[codes]).sum()) / n
        elif rule == "NonNegativeNumbersRule":
            if string:
                fails = "cannot compare a string operand with a non-string operand"
            else:
                value = float((~mask | (host(c, "values") >= 0)).sum()) / n
        elif rule == "UniqueIfApproximatelyUniqueRule":
            rep = "codes" if string else "values"
            _, counts = np.unique(host(c, rep)[mask], return_counts=True)
            value = float((counts == 1).sum()) / int(mask.sum())
        else:
            raise SmokeFailure(f"no numpy evaluation of {rule}")
        metric = cr.metric.value
        if rule == "RetainTypeRule":  # the metric is the type histogram
            counts = {k: v.absolute for k, v in metric.get().values.items()}
            numeric_rows = counts["Integral"] + counts["Fractional"]
            check(numeric_rows == round(value * n) and sum(counts.values()) == n
                  and counts["Unknown"] == n - int(mask.sum()),
                  f"{s.code_for_constraint} on the holdout: {counts} vs numpy {value!r}")
            check((cr.status.value == "Success") == (value == 1.0),
                  f"{s.code_for_constraint} on the holdout: {cr.status} vs numpy {value!r}")
            continue
        if fails is not None:
            check(cr.status.value == "Failure" and metric.is_failure
                  and fails in str(metric.exception),
                  f"{s.code_for_constraint} on the holdout: {cr.status} {cr.message}")
            continue
        want_ok = value >= bound if bound is not None else value == 1.0
        check(metric.is_success and metric.get() == value,
              f"{s.code_for_constraint} on the holdout: metric {metric} vs numpy {value!r}")
        check((cr.status.value == "Success") == want_ok,
              f"{s.code_for_constraint} on the holdout: {cr.status} vs numpy {value!r}")
    log(f"suggest: all {len(suggestions)} holdout constraint results equal numpy's on the "
        f"{n} held-out rows; holdout status {vr.status.value}")


# -- phase 7 ----------------------------------------------------------------

# the budget phases 4 and 6 (and phase 7's resident oracle) run under:
# their suites request about 10 and 21.4 GB, above the default 8 GiB
# that would stream them; raising it loosens only the spill headroom
# gate (100M rows x 64 B already fits 8 GiB), so their plan paths stay
RESIDENT_BUDGET = 64 << 30
DEFAULT_BUDGET = 8 << 30  # the package's config.device_cache_bytes
# the daily pipeline: the table's rows as four days (30M, 30M, 30M, 10M
# at 100M rows), contiguous slices
DAY_SHARES = (3, 3, 3, 1)
STREAM_KEYS = ("ss_sold_date_sk", "ss_sold_time_sk", "ss_item_sk", "ss_customer_sk",
               "ss_cdemo_sk", "ss_hdemo_sk", "ss_addr_sk", "ss_store_sk", "ss_promo_sk",
               "ss_ticket_number")
STREAM_DECIMALS = ("ss_wholesale_cost", "ss_list_price", "ss_sales_price",
                   "ss_ext_discount_amt", "ss_ext_sales_price", "ss_ext_wholesale_cost",
                   "ss_ext_list_price", "ss_ext_tax", "ss_coupon_amt", "ss_net_paid",
                   "ss_net_paid_inc_tax", "ss_net_profit")
STREAM_STATS = ("ss_quantity", "ss_wholesale_cost", "ss_sales_price", "ss_ext_sales_price",
                "ss_net_paid", "ss_net_profit")
STREAM_KLL = ("ss_sales_price", "ss_net_profit", "ss_quantity")
STREAM_PLANS = {
    (("ss_store_sk",), None, False): "dense",
    (("ss_customer_sk",), None, False): "collector",
}
KLL_RELATIVE_ERROR = 0.01  # ApproxQuantile's stated relative error


def stream_checks(T):
    """Phase 7's suite over the wide row: stats and completeness (one
    group filtered), HLL of the int64 keys, the decimals, i_category and
    i_item_id, KLL quantiles of three columns, DataType and a pattern on
    ca_zip, two Compliance predicates, a dense and a collector grouping
    plan. Every assertion holds on each day of the pipeline too."""
    def finite(v):
        return v == v

    c = T.Check(T.CheckLevel.ERROR, "store_sales streamed").has_size(lambda n: n > 0)
    for col in STREAM_STATS:
        c = (c.has_mean(col, finite).has_min(col, finite).has_max(col, finite)
             .has_sum(col, finite).has_standard_deviation(col, lambda v: v >= 0))
    for col in ("ss_sales_price", "ss_net_profit", "ss_quantity"):
        c = c.has_mean(col, finite).where(BOOKS)
    c = c.has_completeness("ss_customer_sk", lambda v: v > 0.9).where(BOOKS)
    c = c.is_complete("ss_item_sk").is_complete("ss_ticket_number")
    for col in STREAM_KEYS + STREAM_DECIMALS:
        if col not in ("ss_item_sk", "ss_ticket_number"):
            c = c.has_completeness(col, lambda v: v > 0.9)
    for col in STREAM_KEYS + STREAM_DECIMALS + ("i_category", "i_item_id"):
        c = c.has_approx_count_distinct(col, lambda v: v > 0)
    for col in STREAM_KLL:
        c = c.has_approx_quantile(col, 0.5, finite)
    c = c.has_data_type("ca_zip", T.checks.ConstrainableDataTypes.INTEGRAL, lambda f: f > 0.85)
    c = c.has_pattern("ca_zip", r"^[0-9]{5}$", lambda f: f > 0.85)
    c = c.satisfies("ss_quantity BETWEEN 1 AND 100", "quantity in range", lambda f: f > 0.85)
    c = c.satisfies("ss_net_paid <= ss_ext_sales_price", "net paid at most the sale",
                    lambda f: f > 0.85)
    c = c.has_number_of_distinct_values("ss_store_sk", lambda v: v > 0)
    c = c.has_uniqueness(["ss_customer_sk"], lambda v: 0.0 <= v <= 1.0)
    return c


def metric_bits(metrics):
    """Each metric as bytes or a repr: floats by their bits."""
    out = {}
    for a, m in metrics.items():
        if m.value.is_failure:
            out[repr(a)] = ("failure", str(m.value.exception))
        else:
            v = m.value.get()
            out[repr(a)] = struct.pack("<d", v) if isinstance(v, float) else repr(v)
    return out


def states_equal(np, a, b) -> bool:
    """Two states bit for bit: a frequency state's keys and counts in
    order, any other state's persisted arrays byte for byte."""
    from deequ_tpu_torch.analyzers.grouping import FrequenciesAndNumRows
    from deequ_tpu_torch.interop import states_to_numpy

    if isinstance(a, FrequenciesAndNumRows):
        return (isinstance(b, FrequenciesAndNumRows) and a.num_rows == b.num_rows
                and np.array_equal(a.counts, b.counts) and np.array_equal(a.keys, b.keys))
    x, y = states_to_numpy(a), states_to_numpy(b)
    return list(x) == list(y) and all(
        np.asarray(x[k]).dtype == np.asarray(y[k]).dtype
        and np.asarray(x[k]).shape == np.asarray(y[k]).shape
        and np.asarray(x[k]).tobytes() == np.asarray(y[k]).tobytes() for k in x)


def frequencies_equal_unordered(np, a, b) -> bool:
    """Two single-column frequency states as sets of (key, count)."""
    def table(state):
        keys = np.array([-1 if k is None else k for k in state.keys[:, 0]], dtype=np.int64)
        order = np.argsort(keys, kind="stable")
        return keys[order], np.asarray(state.counts)[order]

    (ka, ca), (kb, cb) = table(a), table(b)
    return a.num_rows == b.num_rows and np.array_equal(ka, kb) and np.array_equal(ca, cb)


def check_same_run(np, label, oracle, oracle_states, result, states):
    """A run's metrics, check results and states equal the oracle's, bit
    for bit."""
    check(metric_bits(result.metrics) == metric_bits(oracle.metrics),
          f"{label}: metrics differ from the resident oracle's: " + ", ".join(
              k for k, v in metric_bits(result.metrics).items()
              if metric_bits(oracle.metrics).get(k) != v)[:2000])
    check([r["constraint_status"] for r in result.check_results_as_records()]
          == [r["constraint_status"] for r in oracle.check_results_as_records()],
          f"{label}: check results differ from the oracle's")
    check(list(states) == list(oracle_states), f"{label}: other states were persisted")
    bad = [repr(a) for a in oracle_states if not states_equal(np, oracle_states[a], states[a])]
    check(not bad, f"{label}: states differ from the resident oracle's: {bad[:5]}")


def resident_oracle(torch, T, config, dataset, checks, label, requests=None):
    """7a's oracle over ``dataset``: the suite run resident under the
    raised budget; returns its result and persisted states (and appends
    each scan's column requests to ``requests`` when given)."""
    states = {}

    class Keep:
        def persist(self, analyzer, state):
            states[analyzer] = state

    engine = T.AnalysisEngine()
    if requests is not None:
        prepare = engine.prepare_scan

        def recording_prepare(*args, **kwargs):
            plan = prepare(*args, **kwargs)
            requests.append(plan.requests)
            return plan

        engine.prepare_scan = recording_prepare
    t0 = time.perf_counter()
    with config.configure(device_cache_bytes=RESIDENT_BUDGET):
        result = (T.VerificationSuite().on_data(dataset).add_check(checks).with_engine(engine)
                  .save_states_with(Keep()).run())
    torch.cuda.synchronize()
    check(engine.stream_stats is None, f"{label}: the oracle streamed")
    log(f"{label}: the resident oracle over {dataset.num_rows} rows in "
        f"{time.perf_counter() - t0:.3f} s")
    return result, states


def stream_phase(torch, np, dataset, rows: int):
    """Phase 7: the streamed suite (7a) and the daily pipeline (7b) on
    phase 6's table (see the module docstring); returns K1's launches of
    7a's first streamed run, the resident oracle's result and states
    (phase 8 is held to them), the first streamed run's pack seconds and
    the budget that chose streaming."""
    import gc
    import os
    import shutil
    import tempfile

    import deequ_tpu_torch as T
    from deequ_tpu_torch import config
    from deequ_tpu_torch.analyzers import grouping as grouping_mod
    from deequ_tpu_torch.engine import scan as scan_mod
    from deequ_tpu_torch.repository import serde
    from deequ_tpu_torch.sketches import scatter_max as sm

    dataset.clear_device_cache()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"stream: {torch.cuda.memory_allocated() / 2**30:.2f} GiB on the device before phase 7 "
        f"(phase 6's resident columns freed); {rows} rows, {dataset.num_columns} columns")
    checks = stream_checks(T)
    engine = T.AnalysisEngine()
    device = engine.device
    batch = engine._resolve_batch_size(rows)
    nb = -(-rows // batch)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    hll_columns = list(STREAM_KEYS + STREAM_DECIMALS + ("i_category", "i_item_id"))
    expected = k1_expected(T, dataset, hll_columns, batch, nb, sms, "stream")
    check(config.options().device_cache_bytes == DEFAULT_BUDGET,
          f"the package's default budget is {config.options().device_cache_bytes}")

    planned, requests = [], []
    plan_passes, prepare = grouping_mod.plan_frequency_passes, engine.prepare_scan

    def recording_plan(*args, **kwargs):
        out = plan_passes(*args, **kwargs)
        planned.append(out)
        return out

    def recording_prepare(*args, **kwargs):
        plan = prepare(*args, **kwargs)
        requests.append(plan.requests)
        return plan

    def run(label, **opts):
        states = {}

        class Keep:
            def persist(self, analyzer, state):
                states[analyzer] = state

        with config.configure(**opts):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            passes, fetches = engine.data_passes, engine.device_fetches
            t0 = time.perf_counter()
            result = (T.VerificationSuite().on_data(dataset).add_check(checks).with_engine(engine)
                      .save_states_with(Keep()).run())
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        info = {
            "wall": wall, "peak": torch.cuda.max_memory_allocated(), "held": held,
            "passes": engine.data_passes - passes, "fetches": engine.device_fetches - fetches,
            "mode": "resident" if engine.stream_stats is None else "streaming",
            "stats": engine.stream_stats, "phases": dict(engine.phase_times or {}),
        }
        log(f"stream ({label}): {info['mode']}, {wall:.3f} s, {rows / wall:.0f} rows/s; "
            f"{info['passes']} data pass, {info['fetches']} fetches; peak device memory "
            f"{info['peak'] / 2**30:.3f} GiB ({info['held'] / 2**30:.3f} GiB held before the run); "
            "phases "
            + fmt_phases(info["phases"]))
        return result, states, info

    # 7a.1: the oracle, resident under the raised budget
    grouping_mod.plan_frequency_passes = recording_plan
    engine.prepare_scan = recording_prepare
    try:
        oracle, oracle_states, oinfo = run("resident oracle", device_cache_bytes=RESIDENT_BUDGET)
    finally:
        grouping_mod.plan_frequency_passes = plan_passes
        del engine.prepare_scan
    # the streamed runs' budget: the default 8 GiB, or just under the
    # estimate where a reduced --rows table fits 8 GiB, so that the suite
    # still streams and its peak is held against the budget that chose it
    budget = min(DEFAULT_BUDGET, dataset.estimated_device_bytes(requests[-1]) - 1)
    check(oinfo["mode"] == "resident", "the oracle streamed")
    failed = [f"{cr.constraint}: {cr.message}" for r in oracle.check_results.values()
              for cr in r.constraint_results if cr.status.value != "Success"]
    check(oracle.status.value == "Success", f"the oracle's checks failed: {failed}")
    got = {}
    for spec in planned[0][0]:
        got[(spec.plan.columns, spec.plan.where, spec.plan.include_nulls)] = "dense"
    for spec in planned[0][1]:
        got[(spec.plan.columns, spec.plan.where, spec.plan.include_nulls)] = "collector"
    check(got == STREAM_PLANS and not planned[0][2], f"grouping plans {got}, {planned[0][2]}")
    # the oracle runs K1 too: hold its registers against the plain build,
    # so that the streamed runs below are held against it through them
    for c in hll_columns:
        check(torch.equal(oracle_states[T.ApproxCountDistinct(c)].registers,
                          plain_registers(torch, np, dataset, c, device)),
              f"the oracle's HLL registers of {c} differ from the plain whole-column build")
    log(f"stream: the oracle's HLL registers equal the plain whole-column build for "
        f"{len(hll_columns)} columns")
    dataset.clear_device_cache()
    gc.collect()
    torch.cuda.empty_cache()

    # 7a.2-6: streamed at the default budget, then codecs on, then a
    # deeper staging ring
    sm.launches = sm.fused_launches = sm.codes_launches = sm.codes_rows_launches = 0
    engine.prepare_scan = recording_prepare
    try:
        streamed, states, sinfo = run("streamed", device_cache_bytes=budget)
    finally:
        del engine.prepare_scan
    launches = k1_launches()
    check(sinfo["mode"] == "streaming", f"the suite did not stream at {budget} bytes")
    check(launches == expected, f"stream K1 launches {launches}, the planner's {expected}")
    check(sinfo["passes"] == 1 == oinfo["passes"], f"data passes {sinfo['passes']}")
    check(sinfo["fetches"] == oinfo["fetches"],
          f"fetches {sinfo['fetches']}, the oracle's {oinfo['fetches']}")
    check_same_run(np, "streamed", oracle, oracle_states, streamed, states)
    stats = sinfo["stats"]
    log(f"stream: wire {stats.encoded_bytes / rows:.2f} B a row encoded, {stats.raw_bytes / rows:.2f}"
        f" B raw; {stats.batches} batches, {stats.repacks} re-packed; host pack {stats.pack_s:.3f} s"
        f" on the prefetch thread; pinned copies {stats.copy_bytes / 1e9:.3f} GB in "
        f"{stats.copy_s:.3f} s of device time, "
        f"{stats.copy_bytes / 1e9 / stats.copy_s if stats.copy_s else float('nan'):.2f} GB/s; "
        f"estimate {dataset.estimated_device_bytes(requests[-1]) / 1e9:.3f} GB against the "
        f"budget {budget / 1e9:.3f} GB")
    del states
    pack_7a = stats.pack_s
    for label, opts in (("codecs on", dict(wire_codecs=True)),
                        ("ingest_depth 4", dict(ingest_depth=4))):
        result, states_, info = run(label, device_cache_bytes=budget, **opts)
        check(info["mode"] == "streaming", f"{label}: did not stream")
        check_same_run(np, label, oracle, oracle_states, result, states_)
        log(f"stream ({label}): wire {info['stats'].encoded_bytes / rows:.2f} B a row, pack "
            f"{info['stats'].pack_s:.3f} s, copies {info['stats'].copy_s:.3f} s")
        sinfo["peak"] = max(sinfo["peak"], info["peak"])
        del states_
    check(dataset._device_cache == {}, f"the streamed runs left {list(dataset._device_cache)}")
    check(scan_mod.active_prefetch_workers() == [], "a prefetch thread outlived its run")
    check(sinfo["peak"] < budget, f"streamed peak {sinfo['peak'] / 2**30:.3f} GiB is "
          f"not under the {budget / 2**30:.3f} GiB budget that chose streaming")
    log(f"stream: every streamed run equals the resident oracle bit for bit (metrics, check "
        f"results, {len(oracle_states)} states); peak device memory of the streamed runs "
        f"{sinfo['peak'] / 2**30:.3f} GiB, under the {budget / 2**30:.3f} GiB budget; no device "
        "copy and no prefetch thread left")

    # 7a.7: the unpack of one batch timed alone
    codecs = scan_mod.wire_mod.resolve_codecs(dataset, requests[-1],
                                              config.options().wire_codecs)
    wire = scan_mod._StreamWire(dataset, requests[-1], codecs, scan_mod.StreamStats())
    packed = wire.pack(batch, next(dataset.host_batches(requests[-1], batch)), None)
    dev = torch.from_numpy(packed.host).to(device)
    unpack = median_ms(torch, lambda: wire.unpack(packed, dev, device))
    log(f"stream: the unpack of one {batch}-row batch ({packed.host.size / 1e6:.1f} MB, "
        f"{len(packed.layout.masks)} packed masks) {unpack:.4f} ms, {unpack * nb:.3f} ms over "
        f"{nb} batches")
    del dev, packed

    # 7b: the daily pipeline
    bounds = np.cumsum([0] + [rows * s // sum(DAY_SHARES) for s in DAY_SHARES[:-1]] + [0])
    bounds[-1] = rows
    days = [dataset.slice_rows(int(a), int(b)) for a, b in zip(bounds[:-1], bounds[1:])]
    tmp = tempfile.mkdtemp(prefix="deequ_smoke_pipeline_")
    try:
        daily_pipeline(torch, np, T, serde, engine, checks, days, tmp, oracle, oracle_states,
                       dataset, rows)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        for day in days:
            day.clear_device_cache()
        gc.collect()
        torch.cuda.empty_cache()
    return launches, oracle, oracle_states, pack_7a, budget, requests[-1]


def daily_pipeline(torch, np, T, serde, engine, checks, days, tmp, oracle, oracle_states,
                   dataset, rows):
    """7b: four days, each checked with its metrics saved to a file
    repository, its states to a directory and its Size held against the
    history; then the repository reloaded, a reuse run, the four days'
    states aggregated against 7a's oracle, and the same flow on a
    ``mem://`` repository."""
    import os

    from deequ_tpu_torch.data.table import ColumnRequest

    def flow(repo_uri, state_dirs):
        results = []
        for i, day in enumerate(days):
            key = T.ResultKey.of(i, {"dataset": "store_sales"})
            builder = (T.VerificationSuite().on_data(day).add_check(checks).with_engine(engine)
                       .use_repository(T.FileSystemMetricsRepository(repo_uri))
                       .save_or_append_result(key))
            if state_dirs is not None:
                builder = builder.save_states_with(T.FileSystemStateProvider(state_dirs[i]))
            builder = builder.add_anomaly_check(
                T.RelativeRateOfChangeStrategy(max_rate_decrease=0.5, max_rate_increase=2.0),
                T.Size())
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            result = builder.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            anomaly = [cr.status.value for check_, r in result.check_results.items()
                       if check_ is not checks for cr in r.constraint_results]
            log(f"pipeline ({repo_uri.split('://')[0] if '://' in repo_uri else 'file'}): day {i}, "
                f"{day.num_rows} rows, {'resident' if engine.stream_stats is None else 'streaming'}"
                f", {wall:.3f} s; status {result.status.value}, anomaly constraint {anomaly}")
            results.append((key, result, anomaly))
        return results

    repo_path = os.path.join(tmp, "metrics.json")
    state_dirs = [os.path.join(tmp, f"day{i}") for i in range(len(days))]
    results = flow(repo_path, state_dirs)
    # each day's result saved to a parquet-table repository as well
    table_path = os.path.join(tmp, "metrics_table")
    table_repo = T.TableMetricsRepository(table_path)
    t0 = time.perf_counter()
    for key, result, _ in results:
        table_repo.save(T.AnalysisResult(key, T.AnalyzerContext(result.metrics)))
    t_table = time.perf_counter() - t0
    for i, (_, result, anomaly) in enumerate(results[:-1]):
        check(result.status.value == "Success" and anomaly == ["Success"],
              f"day {i}: status {result.status.value}, anomaly {anomaly}")
    _, last, anomaly = results[-1]
    check(anomaly == ["Failure"], f"day 3's anomaly constraint is {anomaly}: the drop went unflagged")
    check(all(cr.status.value == "Success" for cr in last.check_results[checks].constraint_results),
          "day 3's data checks failed")

    # the repository, reloaded from disk, holds each day's metrics, and
    # beside them the run's operational records (telemetry is on: each
    # run's own wall, rows and rows/s)
    from deequ_tpu_torch.telemetry.oprecords import OperationalAnalyzer

    analyzers = list(results[0][1].metrics)

    def data_only(stored):
        return T.AnalysisResult(stored.result_key, T.AnalyzerContext({
            a: m for a, m in stored.analyzer_context.metric_map.items()
            if not isinstance(a, OperationalAnalyzer)}))

    reloaded = T.FileSystemMetricsRepository(repo_path)
    for key, result, _ in results:
        stored = reloaded.load_by_key(key)
        check(stored is not None, f"no stored result for {key}")
        check(serde.serialize([data_only(stored)]) == serde.serialize(
            [T.AnalysisResult(key, T.AnalyzerContext(result.metrics))]),
            f"the stored result of {key} differs from the run's metrics")
        ops = {a.metric: m.value.get() for a, m in stored.analyzer_context.metric_map.items()
               if isinstance(a, OperationalAnalyzer)}
        check(ops.get("rows") == float(days[key.dataset_date].num_rows)
              and ops.get("wall_s", 0) > 0 and ops.get("rows_per_sec", 0) > 0,
              f"the operational records of {key}: {ops}")
    log(f"pipeline: each stored day carries its operational records; the last day's: {ops}")

    # the table repository, reloaded, holds the file repository's records
    table_reloaded = T.TableMetricsRepository(table_path)
    for key, _, _ in results:
        check(serde.serialize([table_reloaded.load_by_key(key)])
              == serde.serialize([data_only(reloaded.load_by_key(key))]),
              f"the table repository's record of {key} differs from the file repository's")
    check(table_reloaded.load().get_success_metrics_as_json()
          == reloaded.load().for_analyzers(analyzers).get_success_metrics_as_json(),
          "the table repository's records differ from the file repository's")
    log(f"pipeline: {len(results)} days saved to a parquet-table repository in {t_table:.3f} s "
        f"({len(os.listdir(table_path))} files); reloaded, its records equal the file "
        "repository's")

    # a rerun of day 2 reusing its stored metrics reads no data
    passes = engine.data_passes
    reuse = (T.VerificationSuite().on_data(days[2]).add_check(checks).with_engine(engine)
             .use_repository(reloaded)
             .reuse_existing_results_for_key(results[2][0], fail_if_results_missing=True).run())
    check(engine.data_passes == passes, "the reuse run of day 2 made a data pass")
    want, got = metric_bits(results[2][1].metrics), metric_bits(reuse.metrics)
    check(len(got) == len(oracle.metrics) and all(want.get(k) == v for k, v in got.items()),
          "the reuse run's metrics differ from day 2's")

    # the four days' states, aggregated, against the whole-table oracle
    merged = {}

    class Keep:
        def persist(self, analyzer, state):
            merged[analyzer] = state

    t0 = time.perf_counter()
    agg = T.VerificationSuite.run_on_aggregated_states(
        dataset.schema, [checks], [T.FileSystemStateProvider(d) for d in state_dirs],
        save_states_with=Keep())
    t_agg = time.perf_counter() - t0
    check(agg.metrics[T.Size()].value.get() == float(rows), "the aggregated Size is not the rows")
    exact = ("Size", "Completeness", "Compliance", "Minimum", "Maximum", "ApproxCountDistinct",
             "DataType", "PatternMatch", "CountDistinct", "Uniqueness")
    worst = {}
    for a, m in oracle.metrics.items():
        name = type(a).__name__
        got = agg.metrics[a].value.get()
        want = m.value.get()
        if name in exact:
            check(repr(got) == repr(want), f"aggregated {a}: {got!r}, whole table {want!r}")
        elif name in ("Sum", "Mean", "StandardDeviation"):
            f32 = a.column == "ss_wholesale_cost"
            check(math.isclose(got, want, rel_tol=RTOL_F32 if f32 else 1e-12),
                  f"aggregated {a}: {got}, whole {want}")
            label = f"{name} (float32)" if f32 else name
            worst[label] = max(worst.get(label, 0.0), abs(got - want) / abs(want))
        elif name == "ApproxQuantile":
            host = dataset.materialize(ColumnRequest(a.column, "values"))
            valid = host[dataset.materialize(ColumnRequest(a.column, "mask"))]
            lo, hi = (np.count_nonzero(valid < got) / len(valid),
                      np.count_nonzero(valid <= got) / len(valid))
            err = max(0.0, lo - a.quantile, a.quantile - hi)
            check(err <= KLL_RELATIVE_ERROR, f"aggregated {a}: rank [{lo}, {hi}] of {got}")
            worst["rank"] = max(worst.get("rank", 0.0), err)
        else:
            check(False, f"no rule to compare the aggregated {a}")
    for a, state in oracle_states.items():
        name = type(a).__name__
        if name == "ApproxCountDistinct":
            check(states_equal(np, state, merged[a]), f"aggregated HLL registers of {a} differ")
        elif name in ("CountDistinct", "Uniqueness"):
            check(frequencies_equal_unordered(np, state, merged[a]),
                  f"aggregated frequencies of {a} differ")
    log(f"pipeline: the four days' states aggregated in {t_agg:.3f} s equal the whole table: Size "
        f"{rows}, counts, completeness, min/max, HLL registers and grouping frequencies exact; "
        f"worst relative error {worst}")

    # the same flow on a mem:// repository gives the same records
    mem_uri = f"mem://deequ-smoke-{os.getpid()}/warehouse/metrics.json"
    mem = flow(mem_uri, None)
    check([a for *_, a in mem] == [a for *_, a in results], "the mem:// flow's anomalies differ")
    check(T.FileSystemMetricsRepository(mem_uri).load().for_analyzers(analyzers)
          .get_success_metrics_as_json()
          == reloaded.load().for_analyzers(analyzers).get_success_metrics_as_json(),
          "the mem:// repository's records differ from the file repository's")
    log("pipeline: days 0-2 passed and day 3's drop was flagged; the repository reloaded equals "
        "each day's metrics; the day-2 reuse run made no data pass; the mem:// flow's records "
        "equal the file's")


# -- phase 8 ----------------------------------------------------------------

PARQUET_ROW_GROUP = 1 << 20  # rows a row group
PARQUET_FILE_GROUPS = 8  # row groups a file
# TPC-DS declares every store_sales price decimal(7,2); ss_wholesale_cost
# stays float32, as in the in-memory table, so the float32 path stays
# covered
PARQUET_DECIMALS = tuple(c for c in STREAM_DECIMALS if c != "ss_wholesale_cost")
# the disk a row of the files may take, compressed or not: the check
# before writing asks for this much free space
PARQUET_ROW_BYTES = 160
# the delta capacity of run (c): past i_item_id's 102,000 ids,
# the JAX package's documented remedy for the default's overflow
PARQUET_DELTA_CAPACITY = 1 << 17
# the columns whose dictionaries the suite's plan reads before the scan,
# one pre-pass each, as the JAX package counts them: the Books filter's
# i_category, the type and pattern checks' ca_zip and the dense plan's
# ss_store_sk (the collector plan's ss_customer_sk is decided from its
# row-group statistics, with no pass)
PARQUET_PREPASS_COLUMNS = ("i_category", "ca_zip", "ss_store_sk")


def decimal_array(np, pa, cents, valid, typ):
    """A decimal array of ``cents / 100`` from int64 cents, with no
    Python loop: the cents are the low word of the little-endian
    two's-complement storage, their sign the high word."""
    storage = np.empty((len(cents), 2), dtype=np.int64)
    storage[:, 0] = cents
    storage[:, 1] = cents >> 63
    nulls = int(len(valid) - np.count_nonzero(valid))
    validity = pa.array(valid).buffers()[1] if nulls else None
    return pa.Array.from_buffers(typ, len(cents), [validity, pa.py_buffer(storage)],
                                 null_count=nulls)


def parquet_slice(np, pa, dataset, start, stop):
    """Rows [start, stop) of phase 6's table as an Arrow table: the int64
    keys and int32 quantity as they are, the eleven float64 cents columns
    as decimal(7,2), ss_wholesale_cost as float32, the three joined
    string columns as strings."""
    from deequ_tpu_torch.data.table import ColumnRequest

    columns = {}
    for c in dataset.schema.column_names:
        valid = dataset.materialize(ColumnRequest(c, "mask"))[start:stop]
        nulls = None if valid.all() else ~valid
        if dataset.schema.kind_of(c).value == "String":
            codes = dataset.materialize(ColumnRequest(c, "codes"))[start:stop]
            columns[c] = pa.DictionaryArray.from_arrays(
                pa.array(codes, mask=codes < 0),
                pa.array(dataset.dictionary(c).tolist(), pa.string())).dictionary_decode()
            continue
        values = dataset.materialize(ColumnRequest(c, "values"))[start:stop]
        if c in PARQUET_DECIMALS:
            cents = np.rint(values * 100.0).astype(np.int64)
            columns[c] = decimal_array(np, pa, cents, valid, pa.decimal128(7, 2))
        else:
            columns[c] = pa.array(values, mask=nulls)
    return pa.table(columns)


def write_parquet(np, dataset, rows, directory):
    """Phase 6's table as parquet files of PARQUET_FILE_GROUPS row groups
    of PARQUET_ROW_GROUP rows, statistics on, written by eight threads;
    returns (seconds, bytes on disk, files)."""
    import os

    import pyarrow as pa
    import pyarrow.parquet as pq

    per_file = PARQUET_ROW_GROUP * PARQUET_FILE_GROUPS
    spans = [(s, min(s + per_file, rows)) for s in range(0, rows, per_file)]

    def write(i):
        start, stop = spans[i]
        path = os.path.join(directory, f"part-{i:03d}.parquet")
        pq.write_table(parquet_slice(np, pa, dataset, start, stop), path,
                       row_group_size=PARQUET_ROW_GROUP, write_statistics=True)
        return os.path.getsize(path)

    t0 = time.perf_counter()
    with ThreadPoolExecutor(8) as pool:
        sizes = list(pool.map(write, range(len(spans))))
    return time.perf_counter() - t0, sum(sizes), len(spans)


def parquet_phase(torch, np, dataset, rows: int, oracle, oracle_states, pack_7a, budget, tmp):
    """Phase 8: phase 7a's suite over phase 6's table written to parquet
    by this run (decimal(7,2) prices, as TPC-DS declares them), streamed
    at the default budget: (a) at the default delta capacity, which
    i_item_id's dictionary overflows as the JAX package's does; (b) with
    the capacity raised and one ingest thread, over the first quarter of
    the files; (c) with the capacity raised and the ordered ingest pool,
    over every file. (b) must equal a resident run over the same rows of
    ``dataset`` and (c) 7a's resident oracle, bit for bit (metrics, check
    results, every state); each must take the planner's passes and the
    oracle's fetches, launch K1 as the planner says (the codes entry in
    its per-row form at D = the capacity), peak under its budget, and
    leave no thread, device copy or column behind. The files are written
    into ``tmp``, which phase 10 reads too and the caller removes.
    Returns the K1 launches of (b), (c) and (d)."""
    import gc
    import os

    import pyarrow.parquet as pq

    import deequ_tpu_torch as T
    from deequ_tpu_torch import config
    from deequ_tpu_torch.data.table import ColumnRequest
    from deequ_tpu_torch.engine import scan as scan_mod

    try:
        free = shutil.disk_usage(tmp).free
        need = rows * PARQUET_ROW_BYTES
        check(free >= need, f"parquet: {free / 1e9:.1f} GB free under {tmp}, the files may "
              f"need {need / 1e9:.1f} GB")
        write_s, on_disk, files = write_parquet(np, dataset, rows, tmp)
        log(f"parquet: wrote {rows} rows, {dataset.num_columns} columns as {files} files of "
            f"{PARQUET_FILE_GROUPS} row groups of {PARQUET_ROW_GROUP} rows in {write_s:.3f} s; "
            f"{on_disk / 1e9:.3f} GB on disk ({on_disk / rows:.1f} B a row; {free / 1e9:.1f} GB "
            "were free)")
        # the decimals as the port reads them equal the in-memory float64
        # cents, checked on one row group before anything streams
        group = pq.ParquetFile(os.path.join(tmp, "part-000.parquet")).read_row_group(
            0, columns=list(PARQUET_DECIMALS))
        head = T.Dataset.from_arrow(group)
        n = group.num_rows
        for c in PARQUET_DECIMALS:
            got = head.materialize(ColumnRequest(c, "values"))
            want = dataset.materialize(ColumnRequest(c, "values"))[:n]
            check(got.tobytes() == want.tobytes(),
                  f"parquet: {c}'s decimals read back differ from the in-memory cents")
        log(f"parquet: the {len(PARQUET_DECIMALS)} decimal(7,2) columns of the first row group "
            f"({n} rows) read back bit-equal to the in-memory float64 cents")
        return _parquet_runs(torch, np, T, config, scan_mod, dataset, tmp, rows, oracle,
                             oracle_states, pack_7a, budget)
    finally:
        gc.collect()
        torch.cuda.empty_cache()


def head_files(directory, rows):
    """Phase 8 (b)'s and (d)'s depth: a new directory beside ``directory``
    (a parquet source reads its subdirectories too) of hard links to the
    first quarter of phase 8's files (at least one), and the rows they
    hold (the first rows of the table, as ``write_parquet`` cut them)."""
    import os

    names = sorted(n for n in os.listdir(directory) if n.endswith(".parquet"))
    keep = names[:max(1, len(names) // 4)]
    share = tempfile.mkdtemp(prefix="deequ_smoke_parquet_head_",
                             dir=os.path.dirname(os.path.abspath(directory)))
    for name in keep:
        os.link(os.path.join(directory, name), os.path.join(share, name))
    return share, min(rows, len(keep) * PARQUET_ROW_GROUP * PARQUET_FILE_GROUPS)


def _parquet_runs(torch, np, T, config, scan_mod, dataset, directory, rows, oracle,
                  oracle_states, pack_7a, budget):
    """Phase 8's runs (a)-(c), (b) and (c) under the profiler."""
    import gc

    from deequ_tpu_torch.sketches import scatter_max as sm

    checks = stream_checks(T)
    engine = T.AnalysisEngine()
    device = engine.device
    batch = engine._resolve_batch_size(rows)
    nb = -(-rows // batch)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    hll_columns = list(STREAM_KEYS + STREAM_DECIMALS + ("i_category", "i_item_id"))
    requests = []
    prepare = engine.prepare_scan

    def recording_prepare(*args, **kwargs):
        plan = prepare(*args, **kwargs)
        requests.append(plan.requests)
        return plan

    def run(label, source=directory, n=rows, **opts):
        ds = T.Dataset.from_parquet(source)
        states = {}

        class Keep:
            def persist(self, analyzer, state):
                states[analyzer] = state

        engine.prepare_scan = recording_prepare
        try:
            with config.configure(**opts):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                held = torch.cuda.memory_allocated()
                passes, fetches, pre = engine.data_passes, engine.device_fetches, ds.prepasses
                t0 = time.perf_counter()
                result = (T.VerificationSuite().on_data(ds).add_check(checks).with_engine(engine)
                          .save_states_with(Keep()).run())
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        finally:
            del engine.prepare_scan
        info = {
            "wall": wall, "peak": torch.cuda.max_memory_allocated(), "held": held,
            "passes": engine.data_passes - passes, "fetches": engine.device_fetches - fetches,
            "prepasses": ds.prepasses - pre, "stats": engine.stream_stats, "ds": ds,
            "mode": "resident" if engine.stream_stats is None else "streaming",
        }
        log(f"parquet ({label}): {info['mode']}, {n} rows, {wall:.3f} s, {n / wall:.0f} rows/s; "
            f"{info['passes']} data passes ({info['prepasses']} dictionary pre-passes), "
            f"{info['fetches']} fetches; peak device memory {info['peak'] / 2**30:.3f} GiB "
            f"({held / 2**30:.3f} GiB held before the run)")
        return result, states, info

    # (a) the default capacity: i_item_id's first batch overflows it. The
    # budget is 7a's (the default 8 GiB, or just under the estimate of a
    # reduced --rows table), which this source's estimate must exceed
    result, _, info = run("default capacity", device_cache_bytes=budget)
    estimate = info["ds"].estimated_device_bytes(requests[-1])
    check(estimate > budget, f"parquet: the estimate {estimate} fits the budget {budget}")
    overflow = [m for m in result.metrics.values() if m.value.is_failure]
    message = re.compile(r"dictionary for column 'i_item_id' grew to \d+ values, past "
                         r"dict_delta_capacity=65536: raise DEEQU_TPU_DICT_DELTA_CAPACITY or "
                         r"set dict_deltas=False")
    check(info["mode"] == "streaming" and overflow
          and all(message.search(str(m.value.exception)) for m in overflow),
          f"parquet: the default capacity did not fail with the overflow error: "
          f"{[str(m.value.exception)[:200] for m in overflow[:2]]}")
    log(f"parquet (default capacity): {len(overflow)} metrics failed, as in the JAX package, "
        f"with: {str(overflow[0].value.exception)[:300]}")
    check(scan_mod.active_prefetch_workers() == [], "parquet (a): a thread outlived the run")
    # the failed scan's spill plan re-read its column resident, into that
    # dataset's cache: drop the dataset before the runs measured below
    del result, overflow, info
    gc.collect()
    torch.cuda.empty_cache()

    # (b): one ingest thread over (d)'s depth, a cut for the time limit
    # (over half of the files it took 40-48 s): the first quarter of the
    # files, held against a resident run over the same rows of the
    # in-memory table (7a's oracle at that depth), at 7a's budget or just
    # under that share's estimate, so that it streams as (c) does
    share_dir, share_rows = head_files(directory, rows)
    try:
        share = dataset.slice_rows(0, share_rows)
        share_oracle, share_states = resident_oracle(torch, T, config, share, checks,
                                                     "parquet (b)")
        share.clear_device_cache()
        share_budget = min(budget, T.Dataset.from_parquet(share_dir).estimated_device_bytes(
            requests[-1]) - 1)
        del share
        gc.collect()
        torch.cuda.empty_cache()

        launches = {}
        for label, workers, source, n, want, want_states, run_budget in (
                ("one ingest thread", 1, share_dir, share_rows, share_oracle, share_states,
                 share_budget),
                ("ingest pool", 0, directory, rows, oracle, oracle_states, budget)):
            opts = dict(device_cache_bytes=run_budget, ingest_workers=workers,
                        dict_delta_capacity=PARQUET_DELTA_CAPACITY)
            run_nb = -(-n // batch)
            with config.configure(**opts):
                expected = k1_expected(T, T.Dataset.from_parquet(source), hll_columns,
                                       batch, run_nb, sms, f"parquet ({label})")
            sm.launches = sm.fused_launches = sm.codes_launches = sm.codes_rows_launches = 0
            result, states, info = run(label, source, n, **opts)
            got = k1_launches()
            ds, stats = info["ds"], info["stats"]
            check(info["mode"] == "streaming",
                  f"parquet ({label}): did not stream at {run_budget} bytes")
            check(got == expected,
                  f"parquet ({label}): K1 launches {got}, the planner's {expected}")
            check(got["hll_update_codes_rows"] == run_nb, f"parquet ({label}): the codes entry "
                  f"ran {got} times, not once a batch per-row")
            check(info["prepasses"] == len(PARQUET_PREPASS_COLUMNS)
                  and info["passes"] == 1 + info["prepasses"],
                  f"parquet ({label}): {info['passes']} passes, {info['prepasses']} pre-passes")
            check(sorted(ds._dictionaries) == sorted(PARQUET_PREPASS_COLUMNS + ("i_item_id",)),
                  f"parquet ({label}): dictionaries built {sorted(ds._dictionaries)}")
            check(info["fetches"] == 2, f"parquet ({label}): {info['fetches']} fetches")
            check_same_run(np, f"parquet ({label})", want, want_states, result, states)
            check(info["peak"] < run_budget, f"parquet ({label}): peak "
                  f"{info['peak'] / 2**30:.3f} GiB is not under the {run_budget / 2**30:.3f} GiB "
                  "budget")
            check(ds._device_cache == {} and len(ds._columns) == 0,
                  f"parquet ({label}): the run left device copies or read whole columns")
            check(scan_mod.active_prefetch_workers() == [],
                  f"parquet ({label}): a thread outlived the run")
            pool = stats.pool
            check((pool is None) == (workers == 1), f"parquet ({label}): pool {pool}")
            log(f"parquet ({label}): equals "
                + ("7a's resident oracle" if n == rows else f"the resident run over its {n} rows")
                + f" bit for bit (metrics, check results, {len(want_states)} states); K1 {got}; "
                f"estimate {ds.estimated_device_bytes(requests[-1]) / 1e9:.3f} GB against the "
                f"budget {run_budget / 1e9:.3f} GB")
            log(f"parquet ({label}): pinned copies {stats.copy_bytes / 1e9:.3f} GB in "
                f"{stats.copy_s:.3f} s of device time, "
                f"{stats.copy_bytes / 1e9 / stats.copy_s if stats.copy_s else float('nan'):.2f} "
                f"GB/s; {stats.batches} batches; pack {stats.pack_s:.3f} s summed over the packing "
                f"threads (7a's one thread, this run: {pack_7a:.3f} s); "
                f"{stats.deltas} dictionary deltas carrying {stats.delta_values} values")
            if pool is None:
                log(f"parquet ({label}): the prefetch thread spent {stats.source_s:.3f} s "
                    "reading and decoding the batches")
            else:
                log(f"parquet ({label}): {pool.workers} workers, {pool.released} batches "
                    f"released, decode {pool.decode_s:.3f} s, pack {pool.encode_s:.3f} s, commit "
                    f"{pool.commit_s:.3f} s, consumer stalls {pool.stall_s:.3f} s, pool wall "
                    f"{pool.wall_s:.3f} s, peak {pool.peak_in_flight} batches and "
                    f"{pool.peak_in_flight_bytes / 1e9:.3f} GB in flight")
                for name, share in sorted(pool.by_worker.items()):
                    if "decode_s" in share:
                        log(f"parquet ({label}):   {name}: decode {share['decode_s']:.3f} s, "
                            f"pack {share.get('encode_s', 0.0):.3f} s, idle "
                            f"{share.get('idle_s', 0.0):.3f} s")
            launches[workers] = got
            del result, states, info, ds
        gc.collect()
        torch.cuda.empty_cache()
        resumed = parquet_resume(torch, np, T, share_dir, share_rows, share_oracle,
                                 share_states, share_budget)
    finally:
        shutil.rmtree(share_dir, ignore_errors=True)
    return launches[1], launches[0], resumed


# phase 8 (d), over (b)'s quarter of the files (a cut of depth, for the
# time limit; over half of them, killed at batch 15, it took 85-110 s): a
# worker's decode fails once at this batch (retried), the scan is
# killed at PARQUET_KILL_AT, checkpointed every PARQUET_CHECKPOINT_EVERY
# batches. The kill stays past the pool's 8 batches in flight after the
# retried one: a kill fired in a batch decoded ahead is dropped with the
# batches the retry discards, and fires once only
PARQUET_DEAD_WORKER = 2
PARQUET_KILL_AT = 11
PARQUET_CHECKPOINT_EVERY = 4
# phase 9 (c): the scan is killed at KILL_AT, checkpointed every
# CHECKPOINT_EVERY batches
KILL_AT = 21
CHECKPOINT_EVERY = 8


def checkpoint_dir(rows: int):
    """A fresh directory on the local disk for a scan's checkpoints, after
    checking that it can hold two of them (the spill collector's key
    buffer, 8 bytes a row, dominates one)."""
    import shutil
    import tempfile

    directory = tempfile.mkdtemp(prefix="deequ_smoke_ckpt_")
    free, need = shutil.disk_usage(directory).free, 2 * rows * 16
    check(free >= need, f"checkpoints: {free / 1e9:.1f} GB free under {directory}, two "
          f"checkpoints may need {need / 1e9:.1f} GB")
    log(f"checkpoints: {directory}, {free / 1e9:.1f} GB free, two checkpoints need at most "
        f"{need / 1e9:.1f} GB")
    return directory


def log_checkpoints(label, engine):
    for c in engine.checkpoints:
        log(f"{label}: checkpoint at batch {c['batch_index']}: {c['bytes'] / 1e9:.3f} GB in "
            f"{c['seconds']:.3f} s ({c['fetches']} fetch), "
            f"{c['bytes'] / 1e9 / c['seconds']:.3f} GB/s")


def child_age_s() -> float:
    """Seconds since this process started (``/proc``): a spawned child's
    start, its interpreter and imports, up to the call."""
    import os

    with open("/proc/self/stat", encoding="ascii") as fh:
        started = int(fh.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime", encoding="ascii") as fh:
        uptime = float(fh.read().split()[0])
    return uptime - started / os.sysconf("SC_CLK_TCK")


def child_start(torch):
    """A spawned child's start, by part: the process up to its work
    (interpreter, torch, the package), the CUDA context, the kernels'
    library (built by phase 2, loaded here)."""
    from deequ_tpu_torch.sketches import scatter_max as sm

    start = {"import_s": child_age_s()}
    t0 = time.perf_counter()
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    start["context_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    sm._library()
    start["load_s"] = time.perf_counter() - t0
    return start


def fmt_start(start) -> str:
    return (f"start {start['import_s']:.2f} s (process and imports), CUDA context "
            f"{start['context_s']:.2f} s, kernels' library {start['load_s']:.3f} s")


def journal(path, **record) -> None:
    """One durable line of a child's journal: it outlives a SIGKILL."""
    import os

    with open(path, "a", encoding="utf-8") as fh:
        fh.write(json.dumps(record) + "\n")
        fh.flush()
        os.fsync(fh.fileno())


def host_state(np, state):
    """A persisted state as host values only (no tensor): a frequency
    state's rows, counts and keys, any other state's persisted arrays."""
    from deequ_tpu_torch.analyzers.grouping import FrequenciesAndNumRows
    from deequ_tpu_torch.interop import states_to_numpy

    if isinstance(state, FrequenciesAndNumRows):
        return ("frequencies", int(state.num_rows), np.asarray(state.keys),
                np.asarray(state.counts))
    return ("arrays", {k: np.asarray(v) for k, v in states_to_numpy(state).items()})


def host_states_equal(np, a, b) -> bool:
    if a[0] != b[0]:
        return False
    if a[0] == "frequencies":
        return a[1] == b[1] and np.array_equal(a[2], b[2]) and np.array_equal(a[3], b[3])
    x, y = a[1], b[1]
    return list(x) == list(y) and all(
        x[k].dtype == y[k].dtype and x[k].shape == y[k].shape
        and x[k].tobytes() == y[k].tobytes() for k in x)


def shipped_run(np, result, states):
    """What a child ships of a run: metrics as bits, the constraint
    statuses, every persisted state as host values."""
    return {"metrics": metric_bits(result.metrics),
            "statuses": [r["constraint_status"] for r in result.check_results_as_records()],
            "states": {repr(a): host_state(np, s) for a, s in states.items()}}


def check_same_shipped(np, label, oracle, oracle_states, shipped):
    """``check_same_run`` for a run a child shipped as host values."""
    want = metric_bits(oracle.metrics)
    check(shipped["metrics"] == want, f"{label}: metrics differ from the resident oracle's: "
          + ", ".join(k for k, v in shipped["metrics"].items() if want.get(k) != v)[:2000])
    check(shipped["statuses"] == [r["constraint_status"]
                                  for r in oracle.check_results_as_records()],
          f"{label}: check results differ from the oracle's")
    check(list(shipped["states"]) == [repr(a) for a in oracle_states],
          f"{label}: other states were persisted")
    bad = [repr(a) for a in oracle_states
           if not host_states_equal(np, host_state(np, oracle_states[a]),
                                    shipped["states"][repr(a)])]
    check(not bad, f"{label}: states differ from the resident oracle's: {bad[:5]}")


def tensor_leaves(value) -> list:
    """The torch tensors anywhere in a (nested) shipped value."""
    import torch

    if isinstance(value, torch.Tensor):
        return [value]
    if isinstance(value, dict):
        return [t for v in value.values() for t in tensor_leaves(v)]
    if isinstance(value, (list, tuple)):
        return [t for v in value for t in tensor_leaves(v)]
    return []


def parquet_resume_child(payload):
    """Phase 8 (d) in a spawned child (``engine/subproc.py``): the pool at
    the raised capacity over the files in ``payload["directory"]``, a
    dead worker's batch retried, a checkpoint every
    PARQUET_CHECKPOINT_EVERY batches, and a SIGKILL in the ordered commit
    of batch PARQUET_KILL_AT (once: a token file). The relaunched child
    reads a fresh ``Dataset.from_parquet``, resumes from the checkpoint
    and ships its run as host values. Each launch journals its start, the
    dead worker, its checkpoints and, at the kill, K1's launches, in a
    file that outlives the kill."""
    import os
    import signal

    import numpy as np
    import torch

    import deequ_tpu_torch as T
    from deequ_tpu_torch import config
    from deequ_tpu_torch.engine import scan as scan_mod
    from deequ_tpu_torch.sketches import scatter_max as sm
    from deequ_tpu_torch.testing.faults import FaultInjectingDataset

    log_path = payload["journal"]
    start = child_start(torch)
    journal(log_path, event="start", **start)

    class Checkpointer(T.ScanCheckpointer):
        def save(self, cursor, *args, **kwargs):
            t0 = time.perf_counter()
            nbytes = super().save(cursor, *args, **kwargs)
            journal(log_path, event="checkpoint", batch=cursor.batch_index, bytes=nbytes,
                    seconds=time.perf_counter() - t0)
            return nbytes

    class Killed(FaultInjectingDataset):
        def _check_decode_faults(self, index):
            try:
                super()._check_decode_faults(index)
            except Exception:
                journal(log_path, event="dead_worker", batch=index)
                raise

        def _maybe_crash(self, index):
            if self._crash_due(index) and not os.path.exists(
                    f"{self._crash_token_path}.crashed-b{index}"):
                journal(log_path, event="kill", batch=index, launches=k1_launches())
            super()._maybe_crash(index)

    source = Killed(T.Dataset.from_parquet(payload["directory"]),
                    crash_at_batch=PARQUET_KILL_AT, crash_token_path=payload["token"],
                    crash_signum=signal.SIGKILL, decode_transient={PARQUET_DEAD_WORKER: 1})
    engine = T.AnalysisEngine(checkpointer=Checkpointer(
        payload["ckpt"], every_batches=PARQUET_CHECKPOINT_EVERY))
    states = {}

    class Keep:
        def persist(self, analyzer, state):
            states[analyzer] = state

    sm.launches = sm.fused_launches = sm.codes_launches = sm.codes_rows_launches = 0
    with config.configure(device_cache_bytes=payload["budget"],
                          dict_delta_capacity=PARQUET_DELTA_CAPACITY, ingest_workers=0):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        result = (T.VerificationSuite().on_data(source).add_check(stream_checks(T))
                  .with_engine(engine).save_states_with(Keep()).run())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    d = result.degradation
    with open(log_path, encoding="utf-8") as fh:
        records = [json.loads(line) for line in fh]
    return {
        "run": shipped_run(np, result, states), "journal": records, "start": start,
        "wall": wall, "resumed_at": engine.resumed_at, "launches": k1_launches(),
        "peak": torch.cuda.max_memory_allocated(), "prepasses": source.prepasses,
        "retries": None if d is None else d.retries,
        "degraded": None if d is None else d.is_degraded,
        "interrupted": result.interruption is not None,
        "threads": [t.name for t in scan_mod.active_prefetch_workers()],
        "checkpoints_left": engine.checkpointer._storage.list_keys("scan-ckpt-"),
    }


def parquet_resume(torch, np, T, directory, rows, oracle, oracle_states, budget):
    """Phase 8 (d) through ``IsolatedRunner``: a spawned child runs the
    pool over the parquet files in ``directory`` and dies by SIGKILL at
    batch PARQUET_KILL_AT (checkpoints every PARQUET_CHECKPOINT_EVERY
    batches, a dead worker's batch retried); the runner relaunches it and
    the new child resumes in a fresh ``Dataset.from_parquet`` at the last
    checkpoint. The shipped run must equal ``oracle`` (a resident run
    over the same rows) bit for bit. Returns K1's launches of both
    children."""
    import multiprocessing
    import os
    import shutil

    from deequ_tpu_torch.engine.subproc import IsolatedRunner, checkpoint_progress_probe
    from deequ_tpu_torch.telemetry import get_telemetry

    batch = T.AnalysisEngine()._resolve_batch_size(rows)
    nb = -(-rows // batch)
    check(nb > PARQUET_KILL_AT,
          f"parquet (d): {nb} batches, the kill is at batch {PARQUET_KILL_AT}")
    ckdir = checkpoint_dir(rows)
    tm = get_telemetry()
    names = ("engine.child_crashes", "engine.crash_resumes", "engine.child_relaunches",
             "engine.resumes")
    before = {n: tm.counter(n).value for n in names}
    try:
        payload = {"directory": directory, "budget": budget, "ckpt": ckdir,
                   "token": os.path.join(ckdir, "kill-token"),
                   "journal": os.path.join(ckdir, "journal.jsonl")}
        runner = IsolatedRunner(key="smoke:parquet (d)", max_relaunches=2, timeout_s=600.0,
                                progress_probe=checkpoint_progress_probe(ckdir),
                                use_breaker=False)
        t0 = time.perf_counter()
        got = runner.run(parquet_resume_child, payload)
        wall = time.perf_counter() - t0
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    check(not os.path.exists(ckdir), f"parquet (d): {ckdir} was not removed")
    delta = {n: tm.counter(n).value - before[n] for n in names}
    check(multiprocessing.active_children() == [], "parquet (d): a child was left")
    check(delta["engine.child_crashes"] == 1 and delta["engine.crash_resumes"] == 1
          and delta["engine.child_relaunches"] == 1,
          f"parquet (d): the parent's counters {delta}: one crash, one relaunch, one resume")
    check(delta["engine.resumes"] == 1, f"parquet (d): the scan's resumes {delta}")
    leaves = tensor_leaves(got)
    check(not leaves, f"parquet (d): the shipped result holds {len(leaves)} tensors (devices "
          f"{sorted({str(t.device) for t in leaves})})")
    records = got["journal"]
    starts = [r for r in records if r["event"] == "start"]
    kills = [r for r in records if r["event"] == "kill"]
    first = records[:records.index(kills[0]) + 1] if kills else records
    check(len(starts) == 2 and len(kills) == 1 and kills[0]["batch"] == PARQUET_KILL_AT,
          f"parquet (d): two launches and one kill at batch {PARQUET_KILL_AT}: {records}")
    check([r["batch"] for r in first if r["event"] == "dead_worker"] == [PARQUET_DEAD_WORKER],
          f"parquet (d): the dead worker did not fire once at batch {PARQUET_DEAD_WORKER}")
    want = list(range(PARQUET_CHECKPOINT_EVERY, PARQUET_KILL_AT + 1, PARQUET_CHECKPOINT_EVERY))
    got_ckpts = [r["batch"] for r in first if r["event"] == "checkpoint"]
    check(got_ckpts == want, f"parquet (d): the killed child's checkpoints {got_ckpts}, not "
          f"{want}")
    for n, start in enumerate(starts):
        log(f"parquet (d): child {n + 1}: {fmt_start(start)}")
    for r in records:
        if r["event"] == "checkpoint":
            log(f"parquet (d): checkpoint at batch {r['batch']}: {r['bytes'] / 1e9:.3f} GB "
                f"saved in {r['seconds']:.3f} s")
    resume_at = want[-1]
    check(got["resumed_at"] == resume_at,
          f"parquet (d): resumed at {got['resumed_at']}, not {resume_at}")
    check_same_shipped(np, "parquet (d)", oracle, oracle_states, got["run"])
    # the dead worker's retry rides the checkpoint into the resumed record
    check(got["retries"] == 1 and got["degraded"] is False and not got["interrupted"],
          f"parquet (d): retries {got['retries']}, degraded {got['degraded']}, interrupted "
          f"{got['interrupted']}")
    check(got["peak"] < budget, f"parquet (d): the child's peak {got['peak'] / 2**30:.3f} GiB "
          "over the budget")
    check(got["threads"] == [], f"parquet (d): threads left in the child {got['threads']}")
    check(got["checkpoints_left"] == [], "parquet (d): the finished scan left its checkpoint")
    log(f"parquet (d): killed by SIGKILL at batch {PARQUET_KILL_AT} in a spawned child, "
        f"relaunched, resumed in a fresh Dataset.from_parquet at batch {resume_at}; the "
        f"resumed scan {got['wall']:.3f} s ({(rows - resume_at * batch) / got['wall']:.0f} "
        f"rows/s of the rest), both children {wall:.3f} s; the child's peak "
        f"{got['peak'] / 2**30:.3f} GiB; {got['prepasses']} passes outside the scan")
    log(f"parquet (d): the resumed child's run equals the resident run over its {rows} rows "
        f"bit for bit (metrics, check results, {len(oracle_states)} states, shipped as host "
        "values); no thread or child left")
    total = dict(got["launches"])
    for k, v in kills[0]["launches"].items():
        total[k] = total.get(k, 0) + v
    return total


# -- phase 9 ----------------------------------------------------------------

# (a), (b), (c) and (d) run over the table's first RESILIENCE_BATCHES
# batches (a cut of depth, for the time limit), each held against a
# resident run over those rows
RESILIENCE_BATCHES = 24
# (a) transient source faults {batch: reads that fail}, one hang, and the
# stall limit that turns the hang into a retry
RESILIENCE_TRANSIENT = {3: 2, 12: 1, 21: 2}
RESILIENCE_HANG = 15
RESILIENCE_STALL_S = 5.0
# (b) a batch that always fails to decode, and one that arrives truncated
RESILIENCE_PERMANENT = 10
RESILIENCE_CORRUPT = 20
# (d) the batch whose production fires the cancel
RESILIENCE_CANCEL = 20


def resilience_phase(torch, np, dataset, rows: int, budget, requests):
    """Phase 9: 7a's suite streamed over the first RESILIENCE_BATCHES
    batches of phase 6's table at 7a's budget (or just under their
    estimate), under (a) transient faults and a stall, (b) a permanent
    and a corrupt batch, (c) a kill and a resume in a fresh engine, (d) a
    cancel and a resume, each held against a resident run over those
    rows, and resident over the whole table (e) a real CUDA OOM under a
    memory cap between the peaks of runs at B and B/2. Returns K1's
    launches of every run of the phase."""
    import gc
    import os
    import shutil

    import deequ_tpu_torch as T
    from deequ_tpu_torch import config, telemetry
    from deequ_tpu_torch.engine import scan as scan_mod
    from deequ_tpu_torch.engine.resilience import ScanKilled
    from deequ_tpu_torch.sketches import scatter_max as sm
    from deequ_tpu_torch.testing.faults import FaultInjectingDataset

    checks = stream_checks(T)
    batch = T.AnalysisEngine()._resolve_batch_size(rows)

    def counted(label, info, **want):
        """The run's counter deltas equal what it injected (a name
        absent from the deltas counted 0)."""
        got = {k: info["counters"].get(k, 0) for k in want}
        check(got == want, f"resilience ({label}): counters {got}, injected {want}")
        log(f"resilience ({label}): counters " + ", ".join(f"{k} {v}" for k, v in got.items()))
    nb = -(-rows // batch)
    check(min(nb, RESILIENCE_BATCHES) > max(max(RESILIENCE_TRANSIENT), KILL_AT, RESILIENCE_CANCEL),
          f"resilience: {nb} batches, fewer than the faults need")
    total = {}

    def run(label, ds, engine=None, killed=False, cancel=None, **opts):
        """One VerificationSuite run; (result, states, info), result None
        when ``killed`` and the scan was killed."""
        engine = engine or T.AnalysisEngine()
        states = {}

        class Keep:
            def persist(self, analyzer, state):
                states[analyzer] = state

        opts.setdefault("device_cache_bytes", budget)
        sm.launches = sm.fused_launches = sm.codes_launches = sm.codes_rows_launches = 0
        result = None
        counters = telemetry.get_telemetry().metrics.counters_snapshot()
        with config.configure(**opts):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            try:
                builder = (T.VerificationSuite().on_data(ds).add_check(checks).with_engine(engine)
                           .save_states_with(Keep()))
                if cancel is not None:
                    builder = builder.with_cancel(cancel)
                result = builder.run()
                check(not killed, f"resilience ({label}): the scan was not killed")
            except ScanKilled as exc:
                check(killed, f"resilience ({label}): killed: {exc}")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = k1_launches()
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        after = telemetry.get_telemetry().metrics.counters_snapshot()
        info = {"wall": wall, "peak": torch.cuda.max_memory_allocated(), "launches": launches,
                "engine": engine,
                "mode": "resident" if engine.stream_stats is None else "streaming",
                "counters": {k: v - counters.get(k, 0) for k, v in after.items()
                             if v != counters.get(k, 0)}}
        log(f"resilience ({label}): {info['mode']}, {ds.num_rows} rows, {wall:.3f} s, "
            f"{ds.num_rows / wall:.0f} rows/s; "
            f"peak device memory {info['peak'] / 2**30:.3f} GiB"
            + ("" if result is None or result.degradation is None
               else f"; degradation {result.degradation.to_dict()['error_classes']}, "
                    f"{result.degradation.retries} retries, "
                    f"{result.degradation.batches_quarantined} batches quarantined"))
        if info["mode"] == "streaming":
            check(info["peak"] < budget, f"resilience ({label}): peak "
                  f"{info['peak'] / 2**30:.3f} GiB over the {budget / 2**30:.3f} GiB budget")
        check(scan_mod.active_prefetch_workers() == [],
              f"resilience ({label}): a thread outlived the run")
        return result, states, info

    # every run but (e) over the table's first RESILIENCE_BATCHES batches,
    # at 7a's budget or just under the share's estimate, so that it
    # streams; (a), (c) and (d) against a resident run over those rows
    head = dataset.slice_rows(0, RESILIENCE_BATCHES * batch)
    head_rows = head.num_rows
    head_budget = min(budget, head.estimated_device_bytes(requests) - 1)
    oracle, oracle_states, info = run("resident oracle over the first "
                                      f"{RESILIENCE_BATCHES} batches", head,
                                      device_cache_bytes=RESIDENT_BUDGET)
    clean_launches = info["launches"]
    check(oracle.status.value == "Success", "resilience: the oracle's checks failed")
    head.clear_device_cache()
    gc.collect()
    torch.cuda.empty_cache()

    # (a) transient faults and a stall: 5 retried reads and 1 retried hang
    ds = FaultInjectingDataset(head, transient=dict(RESILIENCE_TRANSIENT),
                               hang_at_batch={RESILIENCE_HANG: 1})
    result, states, info = run("a: transient faults and a stall", ds,
                               batch_stall_seconds=RESILIENCE_STALL_S,
                               device_cache_bytes=head_budget)
    check(info["mode"] == "streaming", "resilience (a): did not stream")
    check_same_run(np, "resilience (a)", oracle, oracle_states, result, states)
    retries = sum(RESILIENCE_TRANSIENT.values()) + 1
    d = result.degradation
    check(d is not None and d.retries == retries and d.batches_quarantined == 0,
          f"resilience (a): {d}, want {retries} retries and no quarantine")
    check(("hang", RESILIENCE_HANG) in ds.faults_fired, f"resilience (a): {ds.faults_fired}")
    check(info["launches"] == clean_launches,
          f"resilience (a): K1 launches {info['launches']}, the clean run's {clean_launches}")
    counted("a", info, **{"engine.batch_retries": retries, "engine.batches_quarantined": 0,
                          "engine.stalls_detected": 1, "engine.resumes": 0})
    log(f"resilience (a): equals the resident run bit for bit; {d.retries} retries (the stall "
        f"after {RESILIENCE_STALL_S} s among them), no quarantine; K1 launched as the clean run")
    del result, states

    # (b) quarantine: the rows of the two batches missing, against a
    # resident run over the head without them (they sit on batch
    # boundaries, so the fold sequence is the same)
    ds = FaultInjectingDataset(head, permanent={RESILIENCE_PERMANENT},
                               corrupt={RESILIENCE_CORRUPT})
    result, states, info = run("b: quarantine", ds, device_cache_bytes=head_budget)
    check(info["mode"] == "streaming", "resilience (b): did not stream")
    d = result.degradation
    check(d is not None and d.batches_quarantined == 2 and d.rows_skipped == 2 * batch
          and d.error_classes == ["BatchIntegrityError", "ValueError"]
          and [f.batch_index for f in d.failures] == [RESILIENCE_PERMANENT, RESILIENCE_CORRUPT],
          f"resilience (b): {d}")
    check(config.options().degradation_policy == "fail" and result.status.value == "Error",
          f"resilience (b): status {result.status.value} under the default policy")
    counted("b", info, **{"engine.batches_quarantined": 2, "checks.degraded_runs": 1,
                          "engine.resumes": 0})
    keep = np.ones(head_rows, dtype=bool)
    for i in (RESILIENCE_PERMANENT, RESILIENCE_CORRUPT):
        keep[i * batch:(i + 1) * batch] = False
    t0 = time.perf_counter()
    cut = head.filter_rows(keep)
    log(f"resilience (b): the first {head_rows} rows without the two batches' rows, "
        f"{cut.num_rows} rows, in {time.perf_counter() - t0:.3f} s")
    cut_oracle, cut_states, _ = run("b: resident oracle without the two batches", cut,
                                    device_cache_bytes=RESIDENT_BUDGET)
    check_same_run(np, "resilience (b)", cut_oracle, cut_states, result, states)
    log(f"resilience (b): 2 batches quarantined ({d.rows_skipped} rows, "
        f"{', '.join(d.error_classes)}), status {result.status.value}; equals the resident run "
        "without those rows bit for bit")
    cut.clear_device_cache()
    del result, states, cut, cut_oracle, cut_states, keep, ds
    gc.collect()
    torch.cuda.empty_cache()

    # (c) kill and resume in a fresh engine
    ckdir = checkpoint_dir(head_rows)
    try:
        ckpt = T.ScanCheckpointer(ckdir, every_batches=CHECKPOINT_EVERY)
        engine = T.AnalysisEngine(checkpointer=ckpt)
        _, _, info = run("c: killed", FaultInjectingDataset(head, kill_at_batch=KILL_AT),
                         engine=engine, killed=True, device_cache_bytes=head_budget)
        want = list(range(CHECKPOINT_EVERY, KILL_AT + 1, CHECKPOINT_EVERY))
        check([c["batch_index"] for c in engine.checkpoints] == want,
              f"resilience (c): checkpoints {engine.checkpoints}")
        counted("c: killed", info, **{"engine.checkpoints_written": len(want),
                                      "engine.resumes": 0})
        log_checkpoints("resilience (c)", engine)
        engine = T.AnalysisEngine(checkpointer=ckpt)
        result, states, info = run("c: resumed", head, engine=engine,
                                   device_cache_bytes=head_budget)
        log_checkpoints("resilience (c) resumed", engine)
        check(engine.resumed_at == want[-1],
              f"resilience (c): resumed at {engine.resumed_at}, not {want[-1]}")
        counted("c: resumed", info, **{"engine.resumes": 1, "engine.batches_quarantined": 0})
        check_same_run(np, "resilience (c)", oracle, oracle_states, result, states)
        check(ckpt._storage.list_keys("scan-ckpt-") == [],
              "resilience (c): the finished scan left its checkpoint")
        log(f"resilience (c): resumed at batch {engine.resumed_at}; equals the resident run bit "
            "for bit")
        del result, states
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    check(not os.path.exists(ckdir), f"resilience (c): {ckdir} was not removed")

    # (d) cancel from a batch's hook, then resume
    ckdir = checkpoint_dir(head_rows)
    try:
        ckpt = T.ScanCheckpointer(ckdir, every_batches=10 * nb)  # the final cursor only
        token = T.CancelToken()
        ds = FaultInjectingDataset(head, on_batch={
            RESILIENCE_CANCEL: lambda: token.cancel("phase 9 (d): the operator stops the run")})
        engine = T.AnalysisEngine(checkpointer=ckpt)
        result, _, info = run("d: cancelled", ds, engine=engine, cancel=token,
                              device_cache_bytes=head_budget)
        stop = result.interruption
        check(stop is not None and stop.kind == "cancelled" and stop.checkpointed
              and RESILIENCE_CANCEL - 4 <= stop.batch_index <= RESILIENCE_BATCHES,
              f"resilience (d): interruption {stop}")
        size = result.metrics[T.Size()].value.get()
        check(size == stop.row_offset, f"resilience (d): partial Size {size}, "
              f"{stop.row_offset} rows folded")
        counted("d: cancelled", info, **{"engine.runs_cancelled": 1,
                                         "engine.checkpoints_written": 1})
        log(f"resilience (d): cancelled at batch {stop.batch_index} ({stop.reason}); partial "
            f"metrics over {stop.row_offset} rows; status {result.status.value}")
        log_checkpoints("resilience (d)", engine)
        engine = T.AnalysisEngine(checkpointer=ckpt)
        result, states, info = run("d: resumed", head, engine=engine,
                                   device_cache_bytes=head_budget)
        check(engine.resumed_at == stop.batch_index,
              f"resilience (d): resumed at {engine.resumed_at}, not {stop.batch_index}")
        counted("d: resumed", info, **{"engine.resumes": 1, "engine.runs_cancelled": 0})
        check_same_run(np, "resilience (d)", oracle, oracle_states, result, states)
        log(f"resilience (d): resumed at batch {engine.resumed_at}; equals the resident run bit "
            "for bit")
        del result, states
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    check(not os.path.exists(ckdir), f"resilience (d): {ckdir} was not removed")
    del head, oracle, oracle_states
    gc.collect()
    torch.cuda.empty_cache()
    resilience_oom(torch, np, T, config, dataset, rows, batch, run)
    dataset.clear_device_cache()
    gc.collect()
    torch.cuda.empty_cache()
    return total


def resilience_oom(torch, np, T, config, dataset, rows, batch, run):
    """Phase 9 (e), on the resident path (a streamed batch arrives on the
    device whole, so there only the update's temporaries would separate
    B from B/2, less than the ring's batches in flight). The allocator
    caps RESERVED memory (``torch.cuda.set_per_process_memory_fraction``),
    so the window is measured in it: each run starts from an emptied
    cache, and its scan's growth of reserved memory is read when the
    scan ends (at the spill finalize, whose sort of the collector's keys
    needs the same memory at any batch size, and more than the updates).
    A cap between the growths of runs at B and at B/2 holds the scan of
    a run at B, whose first update must raise a real
    ``torch.OutOfMemoryError``, settle at B/2 and equal the run at B/2
    bit for bit. The cap is lifted when that scan ends, and in any case
    afterwards. The allocated peaks of the same scans are logged."""
    from deequ_tpu_torch.analyzers import grouping as grouping_mod

    half = batch // 2
    resident = dict(device_cache_bytes=RESIDENT_BUDGET, memory_heal_after_batches=0)
    finalize = grouping_mod.finalize_collector_states
    scan = {}

    def at_scan_end(*args, **kwargs):
        scan["allocated"] = torch.cuda.max_memory_allocated()
        scan["reserved"] = torch.cuda.max_memory_reserved()
        if scan.pop("capped", False):
            torch.cuda.set_per_process_memory_fraction(1.0)
        return finalize(*args, **kwargs)

    def from_empty_cache(label, bs, **kw):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_reserved()
        out = run(label, dataset, batch_size=bs, **resident, **kw)
        return out, base, scan["reserved"] - base, scan["allocated"]

    grouping_mod.finalize_collector_states = at_scan_end
    try:
        (first, first_states, info), _, _, _ = from_empty_cache("e: resident at B (the upload)",
                                                                batch)
        check(info["mode"] == "resident", "resilience (e): did not stay resident")
        _, base, grow_full, alloc_full = from_empty_cache("e: resident at B", batch)
        (native, native_states, halved), _, grow_half, alloc_half = from_empty_cache(
            "e: resident at B/2", half)
        total = torch.cuda.get_device_properties(0).total_memory
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_reserved()
        cap = base + (grow_full + grow_half) // 2
        log(f"resilience (e): the scan's reserved memory grows {grow_full / 2**20:.1f} MiB at "
            f"B = {batch} and {grow_half / 2**20:.1f} MiB at B/2 = {half} from "
            f"{base / 2**30:.3f} GiB reserved (allocated peaks {alloc_full / 2**30:.3f} and "
            f"{alloc_half / 2**30:.3f} GiB); the cap {cap / 2**30:.3f} GiB, "
            f"{cap / total:.4f} of the card's {total / 2**30:.3f} GiB")
        check(grow_half < grow_full, f"resilience (e): no window between the growths "
              f"{grow_half} at B/2 and {grow_full} at B")
        engine = T.AnalysisEngine()
        scan["capped"] = True
        torch.cuda.set_per_process_memory_fraction(cap / total)
        try:
            result, states, info = run("e: resident at B under the cap", dataset, engine=engine,
                                       batch_size=batch, **resident)
        finally:
            torch.cuda.set_per_process_memory_fraction(1.0)
            scan.pop("capped", None)
    finally:
        grouping_mod.finalize_collector_states = finalize
    events = engine.oom_events
    check(events and events[0]["batch_index"] == 0 and events[0]["stage"] == "dispatch"
          and events[0]["error_class"] == "OutOfMemoryError",
          f"resilience (e): the first update did not raise a CUDA OOM: {events[:2]}")
    settled = engine.last_backoff.effective
    log(f"resilience (e): the first update raised {events[0]['error_class']}: "
        f"{events[0]['message'][:300]}")
    log(f"resilience (e): settled at {settled} rows after {engine.last_backoff.backoffs} "
        f"backoff(s), {len(events)} OOM(s); wall {info['wall']:.3f} s against "
        f"{halved['wall']:.3f} s natively at B/2; the scan's reserved peak "
        f"{scan['reserved'] / 2**30:.3f} GiB under the cap, allocated "
        f"{scan['allocated'] / 2**30:.3f} GiB")
    check(settled == half, f"resilience (e): settled at {settled}, not {half}")
    check(scan["reserved"] <= cap, f"resilience (e): the capped scan reserved {scan['reserved']}")
    check(result.degradation is None, f"resilience (e): {result.degradation}")
    check_same_run(np, "resilience (e)", native, native_states, result, states)
    log("resilience (e): equals the native run at B/2 bit for bit (metrics, check results, "
        f"{len(native_states)} states)")
    del first, first_states, native, native_states, result, states


# -- phase 10 ---------------------------------------------------------------

MESH_RANKS = 2
# seconds a phase-10 rank group may take before every rank is killed
MESH_TIMEOUT_S = 480
# CPU threads a rank's torch may use (the machine's cores are shared by
# the ranks and their ingest pools)
MESH_THREADS = 4
# phase 10 (b)'s high-cardinality plans, as phase 4's: the ticket
# number's distinct count and uniqueness and the TPC-DS primary key
# (single-column and one-lane joint collectors) and the customer
# histogram (each rank's top 1,000 candidates merged)
MESH_GROUPING = (("CountDistinct", ("ss_ticket_number",)),
                 ("Uniqueness", (["ss_ticket_number"],)),
                 ("Uniqueness", (["ss_item_sk", "ss_ticket_number"],)),
                 ("Histogram", ("ss_customer_sk",)))


def mesh_values(metrics):
    """A run's metrics as plain values (a distribution as {label:
    absolute} and its bin count), by analyzer repr."""
    out = {}
    for a, m in metrics.items():
        if m.value.is_failure:
            out[repr(a)] = ("failure", str(m.value.exception)[:300])
            continue
        v = m.value.get()
        if hasattr(v, "number_of_bins"):
            v = ({str(k): int(d.absolute) for k, d in v.values.items()}, int(v.number_of_bins))
        out[repr(a)] = v
    return out


def mesh_rank(rank, world, mesh, directory, parts):
    """Phase 10 on one rank (a fresh process of
    ``deequ_tpu_torch.testing.mesh.run_ranks``), each of ``parts`` (name,
    options) in turn: (a) ``"suite"``: 7a's suite through
    ``VerificationSuite`` over the rank's parquet shard (``shard_view``),
    streamed, with every state kept, under the profiler; (b)
    ``"grouping"``: MESH_GROUPING through ``AnalysisRunner`` over the
    rank's contiguous rows of the same files (``process_sharded_ingest``
    off: the ranks share the table's dictionaries, so the joint key's
    codes shuffle). Returns, a part, the rank's metrics, check results,
    states as arrays (rank 0, which persists them), K1's launches counted
    from 0 just before the run, the run's wall and phases, the
    collectives' bytes and seconds by kind, the device's idle share, and
    the wall-clock times of the rank's steps."""
    entered = time.time()
    import torch

    import deequ_tpu_torch as T

    engine = T.AnalysisEngine(mesh=mesh)
    torch.cuda.synchronize(engine.device)
    # the group's first collectives, timed apart from the parts: NCCL
    # sets up its communicator, and the connections to the peers, when
    # a group first uses them
    ctx, warm = engine.mesh_context, {}
    one = torch.ones(world, device=engine.device)
    for kind, call in (("all_gather", lambda: ctx.gather_tensor(one, kind="warm-up")),
                       ("all_to_all", lambda: ctx.all_to_all(one, [1] * world, [1] * world,
                                                              kind="warm-up"))):
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize(engine.device)
        warm[kind] = time.perf_counter() - t0
    outs = [mesh_part(torch, T, engine, rank, directory, which, opts) for which, opts in parts]
    for out in outs:
        out["entered"] = entered
        out["warm"] = warm
    return outs


def mesh_part(torch, T, engine, rank, directory, which, opts):
    """One part of ``mesh_rank``."""
    from torch.profiler import ProfilerActivity, profile

    import numpy as np

    from deequ_tpu_torch import config
    from deequ_tpu_torch.analyzers.grouping import FrequenciesAndNumRows
    from deequ_tpu_torch.interop import states_to_numpy
    from deequ_tpu_torch.sketches import scatter_max as sm

    ctx = engine.mesh_context
    ctx.bytes.clear()
    ctx.seconds.clear()
    states = {}

    class Keep:
        def persist(self, analyzer, state):
            states[analyzer] = state

    marks = {"start": time.time()}
    out = {"rank": rank, "device": str(engine.device), "backend": ctx.backend}
    with config.configure(**opts):
        local = engine.local_view(T.Dataset.from_parquet(directory))
        out["rows"] = local.num_rows
        out["share"] = local.mesh_share
        batch = engine._resolve_batch_size(local.num_rows)
        nb = -(-local.num_rows // batch)
        if which == "suite":
            sms = torch.cuda.get_device_properties(engine.device).multi_processor_count
            columns = list(STREAM_KEYS + STREAM_DECIMALS + ("i_category", "i_item_id"))
            out["k1_expected"] = k1_expected(T, local, columns, batch, nb, sms,
                                             f"mesh rank {rank}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        sm.launches = sm.fused_launches = sm.codes_launches = sm.codes_rows_launches = 0
        marks["planned"] = time.time()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            if which == "suite":
                result = (T.VerificationSuite().on_data(local).add_check(stream_checks(T))
                          .with_engine(engine).save_states_with(Keep()).run())
                out["statuses"] = [r["constraint_status"]
                                   for r in result.check_results_as_records()]
                metrics = result.metrics
                events = None
            else:
                analyzers = [getattr(T, name)(*args) for name, args in MESH_GROUPING]
                context = T.AnalysisRunner.do_analysis_run(local, analyzers, engine=engine)
                metrics = context.metric_map
                events = context.run_metadata.events
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    marks["ran"] = time.time()
    out["launches"] = k1_launches()
    kernels = device_kernels(prof.key_averages())
    busy_s = sum(e.self_device_time_total for e in kernels) / 1e6
    marks["profiled"] = time.time()
    # a session that recorded no kernel lost them (the run launched K1):
    # its idle share is not measured
    out.update(wall=wall, busy_s=busy_s, idle=1.0 - busy_s / wall if kernels else None,
               batches=nb, batch=batch,
               phases=dict(engine.phase_times or {}), bytes=dict(ctx.bytes),
               seconds=dict(ctx.seconds), metrics=mesh_values(metrics),
               paths=None if events is None else [
                   (e["columns"], e["path"]) for e in events if e["event"] == "grouping_spill"],
               peak=torch.cuda.max_memory_allocated(engine.device))
    # rank 0 persisted the merged states (a sharded state was gathered by
    # every rank first): the arrays they are written as, a frequency
    # state as its (key, count) table (its file's JSON keys cost seconds)
    out["states"] = {repr(a): frequency_table(np, st) if isinstance(st, FrequenciesAndNumRows)
                     else states_to_numpy(st) for a, st in states.items()}
    marks["done"] = time.time()
    out["marks"] = marks
    return out


def frequency_table(np, state):
    """A single-column integer frequency state as (rows, keys, counts) in
    key order (a null key as -1)."""
    keys = np.array([-1 if k is None else k for k in state.keys[:, 0]], dtype=np.int64)
    order = np.argsort(keys, kind="stable")
    return int(state.num_rows), keys[order], np.asarray(state.counts, dtype=np.int64)[order]


def mesh_phase(torch, np, table, rows: int, directory, oracle, oracle_states, budget,
               ranks: int = MESH_RANKS):
    """Phase 10: the ``dp`` mesh on the card (see the module docstring),
    over ``ranks`` ranks. Returns K1's launches summed over the ranks, and
    logs them per rank."""
    import gc

    import deequ_tpu_torch as T
    from deequ_tpu_torch.data.table import ColumnRequest
    from deequ_tpu_torch.engine.mesh import choose_backend
    from deequ_tpu_torch.interop import states_to_numpy
    from deequ_tpu_torch.testing.mesh import run_ranks

    t_phase = time.perf_counter()
    count = torch.cuda.device_count()
    backend, device_type = choose_backend()
    placement = ("one rank a card" if backend == "nccl"
                 else f"all {ranks} ranks on cuda:0, staged through the host")
    log(f"mesh: {count} CUDA device(s); backend {backend} ({placement}); {ranks} ranks")
    check(backend == "gloo" or ranks <= count, f"mesh: {ranks} ranks for {count} cards")
    gc.collect()
    torch.cuda.empty_cache()

    # (a) 7a's suite over the parquet shards, streamed at 7a's budget; (b)
    # the high-cardinality plans over the ranks' contiguous rows; one
    # group of ranks runs both
    parts = [("suite", dict(device_cache_bytes=budget, dict_delta_capacity=PARQUET_DELTA_CAPACITY,
                            ingest_workers=0)),
             ("grouping", dict(device_cache_bytes=budget, process_sharded_ingest=False))]
    spawned = time.time()
    results = run_ranks(mesh_rank, ranks, directory, parts, timeout=MESH_TIMEOUT_S,
                        backend=backend, device_type=device_type, threads=MESH_THREADS)
    returned = time.time()
    log(f"mesh: {ranks} ranks in {returned - spawned:.3f} s; their start (spawn to the "
        f"phase's code) {max(r[0]['entered'] for r in results) - spawned:.3f} s, the mesh "
        f"engine and the card's context "
        f"{max(r[0]['marks']['start'] - r[0]['entered'] for r in results):.3f} s, their "
        f"results back {returned - max(r[-1]['marks']['done'] for r in results):.3f} s")
    log("mesh: the group's first collectives, before the parts (their setup): "
        + ", ".join(f"{kind} {max(r[0]['warm'][kind] for r in results):.4f} s"
                    for kind in results[0][0]["warm"]) + " (the slowest rank)")

    def report(which, index):
        part = [r[index] for r in results]
        for r in part:
            m = r["marks"]
            spill = {k: v for k, v in r["bytes"].items() if k.startswith("spill")}
            spill_s = sum(v for k, v in r["seconds"].items() if k.startswith("spill"))
            log(f"mesh ({which}) rank {r['rank']} on {r['device']}: {r['rows']} rows "
                f"({r['share'][0]} share), {r['batches']} batches of {r['batch']}; run "
                f"{r['wall']:.3f} s, scan {r['phases'].get('scan_s', float('nan')):.3f} s, "
                f"device busy {r['busy_s']:.3f} s, idle share "
                + ("not measured (the profiler's session recorded no kernel)"
                   if r["idle"] is None else f"{r['idle']:.3f}")
                + "; merge "
                f"{r['phases'].get('merge_s', float('nan')):.4f} s, "
                f"{r['bytes'].get('merge', 0)} bytes; spill exchange {sum(spill.values())} "
                f"bytes in {spill_s:.4f} s ({spill}); peak {r['peak'] / 2**30:.3f} GiB; "
                f"K1 {r['launches']}; planning {m['planned'] - m['start']:.3f} s, the "
                f"profiler's tables {m['profiled'] - m['ran']:.3f} s, states as arrays "
                f"{m['done'] - m['profiled']:.3f} s")
        check(all(r["metrics"] == part[0]["metrics"] for r in part),
              f"mesh ({which}): the ranks' metrics differ")
        return part

    suite = report("suite", 0)
    check(sum(r["rows"] for r in suite) == rows, "mesh (a): the shards do not cover the table")
    for r in suite:
        check(r["launches"] == r["k1_expected"],
              f"mesh (a) rank {r['rank']}: K1 launches {r['launches']}, the planner's "
              f"{r['k1_expected']}")
        check(r["launches"]["hll_update"] > 0 and r["launches"]["hll_update_codes_rows"] > 0,
              f"mesh (a) rank {r['rank']}: a K1 entry did not run: {r['launches']}")
    got = suite[0]
    check(got["statuses"] == [x["constraint_status"] for x in oracle.check_results_as_records()],
          "mesh (a): check results differ from 7a's oracle")
    want = mesh_values(oracle.metrics)
    check(sorted(got["metrics"]) == sorted(want), "mesh (a): other metrics")
    exact = floats = quantiles = 0
    for key, w in want.items():
        g = got["metrics"][key]
        if "ApproxQuantile" in key:
            # another valid sketch than one device's: the exact rank of
            # the answer in the column, within the stated relative error;
            # a value that ties takes the whole interval of its ranks, as
            # phase 4 reckons it (the sketch's values are float32)
            column = re.search(r"column='([^']+)'", key).group(1)
            values = table.materialize(ColumnRequest(column, "values"))
            valid = f32_like_xla(np, values[table.materialize(ColumnRequest(column, "mask"))])
            n = len(valid)
            lo, hi = np.count_nonzero(valid < g), np.count_nonzero(valid <= g)
            err = max(lo - 0.5 * n, 0.5 * n - hi, 0) / n
            check(err <= KLL_RELATIVE_ERROR,
                  f"mesh (a): {key} = {g} at ranks [{lo / n}, {hi / n}], error {err}")
            quantiles += 1
        elif isinstance(w, float) and ("Mean" in key or "Sum(" in key or "StandardDeviation" in key):
            rtol = RTOL_F32 if "ss_wholesale_cost" in key else RTOL_F64
            check(math.isclose(g, w, rel_tol=rtol), f"mesh (a): {key} {g} against {w}")
            floats += 1
        else:
            check(g == w, f"mesh (a): {key} {g} against 7a's {w}")
            exact += 1
    # every state: integers (counts, HLL registers, DataType counts,
    # min/max) bit-equal, float accumulators within the stated
    # tolerances, frequencies as sets; KLL sketches are held above
    by_repr = {repr(a): st for a, st in oracle_states.items()}
    check(sorted(got["states"]) == sorted(by_repr), "mesh (a): other states were persisted")
    registers = frequencies = 0
    for key, arrays in got["states"].items():
        if "ApproxQuantile" in key:
            continue
        if isinstance(arrays, tuple):
            # a frequency state: a dense one merged by value over shards
            # whose dictionaries differ holds its groups in another order
            ref = frequency_table(np, by_repr[key])
            check(arrays[0] == ref[0] and np.array_equal(arrays[1], ref[1])
                  and np.array_equal(arrays[2], ref[2]), f"mesh (a): {key}'s groups differ")
            frequencies += 1
            continue
        ref = states_to_numpy(by_repr[key])
        check(sorted(arrays) == sorted(ref), f"mesh (a): {key}'s state has other arrays")
        for name, a in arrays.items():
            b = ref[name]
            a, b = np.asarray(a), np.asarray(b)
            if a.dtype.kind == "f":
                rtol = RTOL_F32 if "ss_wholesale_cost" in key else RTOL_F64
                check(a.shape == b.shape and np.allclose(a, b, rtol=rtol, atol=0.0),
                      f"mesh (a): {key}'s {name} outside rtol {rtol}")
            else:
                check(a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes(),
                      f"mesh (a): {key}'s {name} differs from 7a's oracle")
                registers += int(a.dtype == np.int8)
    log(f"mesh (a): every rank equals 7a's resident oracle: {exact} metrics bit for bit, "
        f"{floats} float metrics within rtol {RTOL_F64} ({RTOL_F32} for the float32 column), "
        f"{quantiles} quantiles within the rank error {KLL_RELATIVE_ERROR}; "
        f"{len(got['states'])} states ({registers} int8 HLL register arrays bit-equal, "
        f"{frequencies} frequency states equal as sets of groups); check results equal")

    grouping = report("grouping", 1)
    for r in grouping:
        check(sorted(map(tuple, ((tuple(c), p) for c, p in r["paths"]))) == sorted([
            (("ss_ticket_number",), "device-sort"),
            (("ss_item_sk", "ss_ticket_number"), "device-sort-joint"),
            (("ss_customer_sk",), "device-sort")]),
            f"mesh (b) rank {r['rank']}: grouping paths {r['paths']}")
    expected = mesh_grouping_expected(np, table, rows)
    values = grouping[0]["metrics"]
    for (name, args), want_value in zip(MESH_GROUPING, expected):
        key = repr(getattr(T, name)(*args))
        check(values[key] == want_value, f"mesh (b): {key} {str(values[key])[:300]} against "
              f"numpy's {str(want_value)[:300]}")
    log(f"mesh (b): {len(MESH_GROUPING)} grouping metrics equal numpy's exactly on every rank "
        f"(ticket numbers {expected[0]:.0f}, key-pair uniqueness {expected[2]})")
    total = {}
    for r in suite + grouping:
        for k, v in r["launches"].items():
            total[k] = total.get(k, 0) + v
    log(f"mesh: phase wall {time.perf_counter() - t_phase:.3f} s")
    return total


# -- phase 11 ---------------------------------------------------------------

# phase 11 (a) runs over the table's first EGRESS_BATCHES batches (a cut of
# depth, for the time limit: the split carries every column, and every
# row of it is quarantined, since 7a's suite holds the customer key unique,
# so the host's parquet encoding of the one quarantine file bounds it;
# over the whole table it takes 305 s, ``--egress-only whole``; the run's
# peak does not shrink with its rows as the budget scaled to them does, so
# fewer batches would not fit it)
EGRESS_BATCHES = 12
# phase 11 (b): over the table's first EGRESS_RESUME_BATCHES batches (16
# until the telemetry slice, cut for the time limit: the uninterrupted run
# took 20.5 s and the resumed one 37.6 s there), killed
# at EGRESS_KILL_AT with a checkpoint every EGRESS_CHECKPOINT_EVERY batches
EGRESS_RESUME_BATCHES = 12
EGRESS_KILL_AT = 11
EGRESS_CHECKPOINT_EVERY = 4
# (b) carries the keys and the columns its constraints read (a cut of
# width, for the time limit: (a) carries every column)
EGRESS_RESUME_COLUMNS = ("ss_item_sk", "ss_ticket_number", "ss_quantity", "ss_sales_price",
                         "ss_list_price", "ss_sold_date_sk", "i_category", "ca_zip")
# the disk a row of a split may take (phase 11 (a)'s split held 404 B a
# row over 12 batches, every row quarantined with 45 outcome columns)
EGRESS_BYTES_PER_ROW = 450


def egress_check(T, deferred=True):
    """Phase 11's row-level check: a completeness on a column with about
    4% nulls, a Compliance about 1% of rows fail, one filtered to Books, a
    pattern, an asserted minimum, and (``deferred``) the uniqueness of
    the TPC-DS key pair, which is evaluated at finalize. Its analyzers
    join no stacked group of 7a's float statistics (a wider stack sums
    in another order), so 7a's states stay bit-equal to a run without
    it."""
    c = (T.Check(T.CheckLevel.WARNING, "row level")
         .is_complete("ss_quantity")
         .satisfies("ss_item_sk > 2040", "item past the first 1%")
         .satisfies("ss_sales_price <= ss_list_price", "sale at most list").where(BOOKS)
         .has_pattern("ca_zip", r"^\d{5}$", lambda f: f > 0.9)
         .has_min("ss_sold_date_sk", lambda v: v >= SF100_DATES[0]))
    if deferred:
        c = c.has_uniqueness(["ss_item_sk", "ss_ticket_number"], lambda v: v > 0.999)
    return c


def egress_dir(rows: int, columns: int, label: str):
    """A fresh directory on the local disk for a split, after checking the
    free disk."""
    directory = tempfile.mkdtemp(prefix="deequ_smoke_egress_")
    free = shutil.disk_usage(directory).free
    need = rows * EGRESS_BYTES_PER_ROW * columns // 26
    check(free >= need, f"egress ({label}): {free / 1e9:.1f} GB free under {directory}, the "
          f"split may need {need / 1e9:.1f} GB")
    log(f"egress ({label}): {directory}, {free / 1e9:.1f} GB free, the split may need "
        f"{need / 1e9:.1f} GB")
    return directory


def split_digest(directory):
    """sha256 of each split file."""
    import hashlib

    out = {}
    for split in ("clean", "quarantine"):
        h = hashlib.sha256()
        with open(f"{directory}/{split}/part-00000.parquet", "rb") as fh:
            for chunk in iter(lambda: fh.read(1 << 24), b""):
                h.update(chunk)
        out[split] = h.hexdigest()
    return out


def egress_manifest(directory):
    """The manifest, its directory replaced."""
    with open(f"{directory}/manifest.json", encoding="utf-8") as fh:
        return json.loads(fh.read().replace(directory, "<out>"))


def log_writer(label, writer, report, wall, rows):
    log(f"egress ({label}): {wall:.3f} s, {rows / wall:.0f} rows/s; rows clean "
        f"{report.rows_clean}, quarantined {report.rows_quarantined}; bytes raw "
        f"{report.bytes_raw}, encoded {report.bytes_encoded}; the writer's spans "
        f"{writer.seconds['spans']:.3f} s, parquet encoding {writer.write_seconds:.3f} s (its "
        f"threads), compaction {writer.seconds['compaction']:.3f} s, manifest "
        f"{writer.seconds['manifest']:.3f} s; {writer.segments_written} segments")


def check_split(torch, np, label, out, dataset, result, rl, columns):
    """A run's split against the port's oracle, numpy and the in-memory
    rows: clean and quarantine ``__row_index__`` partition the rows; each
    quarantined row's ``__failed_constraints__`` are exactly the
    constraints the oracle (``row_level_results_as_dataset``) fails it on,
    and no clean row fails one; each of the row-level check ``rl``'s
    failing counts equals numpy's (the key pair's by an exact sort on the
    card); one row group of each split, read back, equals the in-memory
    rows it names in ``columns``."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    from deequ_tpu_torch import config
    from deequ_tpu_torch.data.table import ColumnRequest

    report = result.row_level_egress
    rows = dataset.num_rows
    device = config.resolve_device(None)
    t0 = time.perf_counter()
    expected = result.row_level_results_as_dataset()
    names = expected.schema.column_names
    check(sorted(names) == sorted(report.constraints),
          f"egress ({label}): the oracle's columns {len(names)} vs the split's "
          f"{len(report.constraints)}")
    fails = {n: ~expected._columns[n].values.astype(bool) for n in names}
    t_oracle = time.perf_counter() - t0
    index = {}
    for split in ("clean", "quarantine"):
        cols = ["__row_index__"] + (["__failed_constraints__"] if split == "quarantine"
                                    else [])
        read = pq.read_table(f"{out}/{split}/part-00000.parquet", columns=cols,
                             read_dictionary=cols[1:])
        index[split] = torch.from_numpy(
            read.column("__row_index__").to_numpy().astype(np.int64)).to(device)
        if split == "quarantine":
            labels = read.column("__failed_constraints__").unify_dictionaries()
            labels = labels.combine_chunks()
            codes = torch.from_numpy(labels.indices.to_numpy().astype(np.int64)).to(device)
            sets = [set(s.split(";")) for s in labels.dictionary.to_pylist()]
    seen = torch.zeros(rows, dtype=torch.int32, device=device)
    for split in ("clean", "quarantine"):
        seen.index_add_(0, index[split], torch.ones_like(index[split], dtype=torch.int32))
    check(bool((seen == 1).all()), f"egress ({label}): clean and quarantine __row_index__ do "
          "not partition the rows")
    check(index["quarantine"].numel() == report.rows_quarantined,
          f"egress ({label}): the quarantine's rows differ from the report's")
    counts = {}
    for n in names:
        member = torch.tensor([n in s for s in sets], dtype=torch.bool, device=device)
        got = torch.zeros(rows, dtype=torch.bool, device=device)
        got[index["quarantine"]] = member[codes]
        want_fail = torch.from_numpy(fails[n]).to(device)
        check(torch.equal(got, want_fail),
              f"egress ({label}): the rows labelled {n!r} differ from the oracle's failures")
        counts[n] = int(want_fail.sum())
    log(f"egress ({label}): clean and quarantine partition range({rows}); every quarantined "
        f"row's __failed_constraints__ equal the oracle's failures of {len(names)} "
        f"constraints, and no clean row fails one (oracle {t_oracle:.3f} s, check "
        f"{time.perf_counter() - t0 - t_oracle:.3f} s)")
    del fails, expected, seen, index, codes

    # each of the row-level check's constraints against numpy (the key
    # pair's duplicates by an exact sort on the card)
    host = {f"{c}::{r}": dataset.materialize(ColumnRequest(c, r)) for c, r in (
        ("ss_quantity", "mask"), ("ss_item_sk", "values"), ("ss_sales_price", "values"),
        ("ss_sales_price", "mask"), ("ss_list_price", "values"), ("ss_list_price", "mask"),
        ("i_category", "codes"), ("ca_zip", "codes"), ("ss_ticket_number", "values"),
        ("ss_sold_date_sk", "values"), ("ss_sold_date_sk", "mask"))}
    books = host["i_category::codes"] == CATEGORIES.index("Books")
    sale_ok = (host["ss_sales_price::mask"] & host["ss_list_price::mask"]
               & (host["ss_sales_price::values"] <= host["ss_list_price::values"]))
    # the row-level check's constraints, in its order
    numpy_fail = [
        int((~host["ss_quantity::mask"]).sum()),
        int((host["ss_item_sk::values"] <= 2040).sum()),
        int((books & ~sale_ok).sum()),
        int((host["ca_zip::codes"] < 0).sum()),
        int((host["ss_sold_date_sk::mask"]
             & (host["ss_sold_date_sk::values"] < SF100_DATES[0])).sum()),
    ]
    rl_names = [str(cr.constraint) for cr in result.check_results[rl].constraint_results]
    pair = ""
    if len(rl_names) > len(numpy_fail):  # the deferred uniqueness of the key pair
        key = (torch.from_numpy(host["ss_item_sk::values"]).to(device) << 24) | torch.from_numpy(
            host["ss_ticket_number::values"]).to(device)
        _, inverse, group_counts = torch.unique(key, return_inverse=True, return_counts=True)
        numpy_fail.append(int((group_counts[inverse] > 1).sum()))
        del key, inverse, group_counts
        pair = (f". The key pair (ss_item_sk, ss_ticket_number): {numpy_fail[-1]} rows in "
                f"duplicated pairs, uniqueness {1 - numpy_fail[-1] / rows:.8f}")
    check(len(rl_names) == len(numpy_fail), f"egress ({label}): {len(rl_names)} constraints")
    for name, n_fail in zip(rl_names, numpy_fail):
        check(counts[name] == n_fail, f"egress ({label}): {name} fails {counts[name]} rows, "
              f"numpy {n_fail}")
    log(f"egress ({label}): the failing rows of the row-level check's constraints equal "
        "numpy's: " + "; ".join(f"{n} {v}" for n, v in zip(rl_names, numpy_fail)) + pair)

    # one row group of each split, read back, equals the rows it names
    for split in ("clean", "quarantine"):
        parquet = pq.ParquetFile(f"{out}/{split}/part-00000.parquet")
        if parquet.metadata.num_row_groups == 0:
            # every row went to the other split (over the whole table, 7a's
            # customer uniqueness quarantines every row)
            held = report.rows_clean if split == "clean" else report.rows_quarantined
            check(held == 0, f"egress ({label}): the {split} split holds no row group")
            log(f"egress ({label}): the {split} split holds no row, as the report says")
            continue
        group = parquet.read_row_group(0)
        rows_at = group.column("__row_index__").to_numpy().astype(np.int64)
        lo, hi = int(rows_at.min()), int(rows_at.max()) + 1
        keep = np.zeros(hi - lo, dtype=bool)
        keep[rows_at - lo] = True
        want_rows = dataset.slice_rows(lo, hi).filter_rows(keep).table
        for c in columns:
            a, b = group.column(c).combine_chunks(), want_rows.column(c).combine_chunks()
            if pa.types.is_dictionary(a.type):
                a = a.dictionary_decode()
            if pa.types.is_dictionary(b.type):
                b = b.dictionary_decode()
            check(a.equals(b), f"egress ({label}): {split} row group 0's {c} differs from "
                  "the in-memory rows it names")
        log(f"egress ({label}): {split} row group 0 ({group.num_rows} rows from row {lo}) "
            f"equals the in-memory rows, {len(columns)} columns")


def egress_phase(torch, np, table, rows: int, budget, requests, batches_a=EGRESS_BATCHES,
                 resume=True):
    """Phase 11: row-level egress on phase 6's table (see the module
    docstring), (a) over its first ``batches_a`` batches, then (b) when
    ``resume``; returns K1's launches of its runs."""
    import gc
    import os
    import threading

    import pyarrow.parquet as pq

    import deequ_tpu_torch as T
    from deequ_tpu_torch import config, telemetry
    from deequ_tpu_torch.egress import RowLevelSink, plan_row_sink
    from deequ_tpu_torch.egress import writer as writer_mod
    from deequ_tpu_torch.engine import scan as scan_mod
    from deequ_tpu_torch.engine.resilience import ScanKilled
    from deequ_tpu_torch.sketches import scatter_max as sm
    from deequ_tpu_torch.testing.faults import FaultInjectingDataset

    writers = []
    init = writer_mod.QuarantineWriter.__init__

    def recording_init(self, *args, **kwargs):
        init(self, *args, **kwargs)
        writers.append(self)

    def no_threads_left(label):
        check(scan_mod.active_prefetch_workers() == [], f"egress ({label}): a prefetch thread "
              "outlived its run")
        left = [t.name for t in threading.enumerate() if t.name.startswith("deequ-egress")]
        check(not left, f"egress ({label}): writer threads left: {left}")

    checks, rl = stream_checks(T), egress_check(T)
    batch = T.AnalysisEngine()._resolve_batch_size(rows)
    nb = -(-rows // batch)
    check(nb >= max(batches_a, EGRESS_RESUME_BATCHES if resume else 0),
          f"egress: {nb} batches, fewer than the phase needs")
    total = {}
    # (a) over the first batches_a batches, streamed at 7a's budget scaled
    # to their share of the rows (the whole table's budget a row, so that
    # the planner's gates and the peak check hold them as they hold the
    # whole table) or just under their estimate, against a resident run
    # of 7a's suite over the same rows
    dataset = table.slice_rows(0, batches_a * batch)
    rows_a = dataset.num_rows
    budget_a = min(budget * rows_a // rows, dataset.estimated_device_bytes(requests) - 1)
    sm.launches = sm.fused_launches = sm.codes_launches = sm.codes_rows_launches = 0
    oracle, oracle_states = resident_oracle(torch, T, config, dataset, checks, "egress (a)")
    clean_launches = k1_launches()
    for k, v in clean_launches.items():
        total[k] = total.get(k, 0) + v
    dataset.clear_device_cache()
    gc.collect()
    torch.cuda.empty_cache()
    writer_mod.QuarantineWriter.__init__ = recording_init
    out = egress_dir(rows_a, dataset.num_columns, "a")
    try:
        # (a) streamed, with every column
        states = {}

        class Keep:
            def persist(self, analyzer, state):
                states[analyzer] = state

        engine = T.AnalysisEngine()
        sm.launches = sm.fused_launches = sm.codes_launches = sm.codes_rows_launches = 0
        with config.configure(device_cache_bytes=budget_a):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            result = (T.VerificationSuite().on_data(dataset).add_checks([checks, rl])
                      .with_engine(engine).save_states_with(Keep())
                      .with_row_level_sink(RowLevelSink(out, tenant="smoke", run_id="egress-a"))
                      .run())
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        launches = k1_launches()
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        report, writer = result.row_level_egress, writers[-1]
        log_writer("a", writer, report, wall, rows_a)
        log(f"egress (a): {'resident' if engine.stream_stats is None else 'streaming'}, "
            f"{engine.data_passes} data passes; peak device memory {peak / 2**30:.3f} GiB "
            f"against the {budget_a / 2**30:.3f} GiB budget; phases "
            + fmt_phases(engine.phase_times or {}))
        check(report.status == "complete" and report.rows_written == rows_a,
              f"egress (a): {report.status}, {report.rows_written} rows written")
        check(engine.stream_stats is not None, "egress (a): the suite did not stream")
        check(engine.data_passes == 2, f"egress (a): data_passes == {engine.data_passes}")
        check(peak < budget_a, f"egress (a): peak {peak / 2**30:.3f} GiB over the budget")
        check(launches == clean_launches,
              f"egress (a): K1 launches {launches}, the resident run's {clean_launches}")
        deferred = sorted(n for n, kind in report.constraints.items() if kind == "deferred")
        log(f"egress (a): {len(report.constraints)} outcome columns, {len(deferred)} deferred "
            f"({deferred}); unsupported {report.unsupported}")
        check(not report.unsupported, f"egress (a): unsupported {report.unsupported}")
        no_threads_left("a")

        # the sink disturbs no other state: 7a's metrics, check results
        # and states equal the resident run's bit for bit
        bits, want = metric_bits(result.metrics), metric_bits(oracle.metrics)
        check(all(bits.get(k) == v for k, v in want.items()),
              "egress (a): metrics differ from the resident run's: "
              + ", ".join(k for k, v in want.items() if bits.get(k) != v)[:2000])
        statuses = [r["constraint_status"] for r in result.check_results_as_records()
                    if r["check"] == checks.description]
        check(statuses == [r["constraint_status"] for r in oracle.check_results_as_records()],
              "egress (a): 7a's check results differ from the resident run's")
        bad = [repr(a) for a in oracle_states if not states_equal(np, oracle_states[a], states[a])]
        check(not bad, f"egress (a): states differ from the resident run's: {bad[:5]}")
        log(f"egress (a): 7a's {len(want)} metrics, its check results and "
            f"{len(oracle_states)} states equal the resident run's bit for bit")
        del states, oracle, oracle_states

        check_split(torch, np, "a", out, dataset, result, rl, dataset.schema.column_names)
        device = engine.device

        # one batch's plane update under the sync debug mode, and its device ms
        plan = plan_row_sink(RowLevelSink(f"{out}/planes"), [checks, rl], dataset, engine)
        with config.configure(device_cache_bytes=budget_a):
            stream = scan_mod.stream_batches(dataset, plan.adapter.device_requests(dataset),
                                             batch, device)
            first = next(stream)
            stream.close()
        ops = plan.ops
        consts = scan_mod._to_device(ops.consts, device)
        state = scan_mod._to_device(ops.init(), device)
        ops.apply_update(state, dict(first), consts)  # warm the predicates' tables
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            ops.apply_update(state, dict(first), consts)
        except RuntimeError as exc:
            raise SmokeFailure(f"egress (a): the plane update synchronised: {exc}") from exc
        finally:
            torch.cuda.set_sync_debug_mode(0)
        plane_ms = median_ms(torch, lambda: ops.apply_update(state, dict(first), consts))
        log(f"egress (a): one batch's plane update ({plan.writer._plane_shape[0]} planes of "
            f"{batch} rows) ran under set_sync_debug_mode('error'): no host sync; "
            f"{plane_ms:.4f} ms a batch (CUDA events, median), {plane_ms * nb:.1f} ms a scan")
        del first, plan, ops, consts, state
    finally:
        shutil.rmtree(out, ignore_errors=True)
        if not resume:
            writer_mod.QuarantineWriter.__init__ = init
    check(not os.path.exists(out), f"egress (a): {out} was not removed")
    del result, dataset
    gc.collect()
    torch.cuda.empty_cache()
    if not resume:
        return total

    # (b) killed and resumed over the first EGRESS_RESUME_BATCHES batches,
    # streamed, with the scan families and a column projection
    head = table.slice_rows(0, EGRESS_RESUME_BATCHES * batch)
    head_rows = head.num_rows
    base = egress_dir(head_rows, len(EGRESS_RESUME_COLUMNS), "b")
    ckdir = checkpoint_dir(head_rows)
    rl = egress_check(T, False)
    try:
        counted = {}

        def run(label, ds, out_dir, engine, killed=False):
            sink = RowLevelSink(out_dir, columns=list(EGRESS_RESUME_COLUMNS), tenant="smoke",
                                run_id="egress-b")
            sm.launches = sm.fused_launches = sm.codes_launches = sm.codes_rows_launches = 0
            before = telemetry.get_telemetry().metrics.counters_snapshot()
            t0 = time.perf_counter()
            result = None
            with config.configure(device_cache_bytes=0):
                try:
                    result = (T.VerificationSuite().on_data(ds).add_check(rl)
                              .with_engine(engine).with_row_level_sink(sink).run())
                    check(not killed, f"egress ({label}): the scan was not killed")
                except ScanKilled as exc:
                    check(killed, f"egress ({label}): killed: {exc}")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            after = telemetry.get_telemetry().metrics.counters_snapshot()
            counted[label] = {k: v - before.get(k, 0) for k, v in after.items()
                              if v != before.get(k, 0)}
            for k, v in k1_launches().items():
                total[k] = total.get(k, 0) + v
            if result is not None:
                log_writer(label, writers[-1], result.row_level_egress, wall, head_rows)
            else:
                log(f"egress ({label}): killed after {wall:.3f} s")
            no_threads_left(label)
            return result

        whole = run("b: uninterrupted", head, f"{base}/whole", T.AnalysisEngine())
        # its realistic mix of clean and quarantined rows, held as (a) is
        check_split(torch, np, "b: uninterrupted", f"{base}/whole", head, whole, rl,
                    list(EGRESS_RESUME_COLUMNS))
        # F2: the split's row columns read back in the source's Arrow types
        source = next(iter(head.record_batches(list(EGRESS_RESUME_COLUMNS), 1))).schema
        for split in ("clean", "quarantine"):
            read = pq.read_schema(f"{base}/whole/{split}/part-00000.parquet")
            check([read.field(c).type for c in EGRESS_RESUME_COLUMNS]
                  == [source.field(c).type for c in EGRESS_RESUME_COLUMNS],
                  f"egress (b): the {split} split's schema {read} is not the source's {source}")
        log("egress (b): both split files carry the source's Arrow types: "
            + ", ".join(f"{f.name} {f.type}" for f in source))
        ckpt = T.ScanCheckpointer(ckdir, every_batches=EGRESS_CHECKPOINT_EVERY)
        engine = T.AnalysisEngine(checkpointer=ckpt)
        run("b: killed", FaultInjectingDataset(head, kill_at_batch=EGRESS_KILL_AT),
            f"{base}/resumed", engine, killed=True)
        want = list(range(EGRESS_CHECKPOINT_EVERY, EGRESS_KILL_AT + 1, EGRESS_CHECKPOINT_EVERY))
        check([c["batch_index"] for c in engine.checkpoints] == want,
              f"egress (b): checkpoints {engine.checkpoints}")
        log_checkpoints("egress (b)", engine)
        engine = T.AnalysisEngine(checkpointer=ckpt)
        t0 = time.perf_counter()
        resumed = run("b: resumed", head, f"{base}/resumed", engine)
        t_resume = time.perf_counter() - t0
        check(engine.resumed_at == want[-1] and engine.egress_rows_replayed == 0,
              f"egress (b): resumed at {engine.resumed_at}, {engine.egress_rows_replayed} rows "
              f"written again; want {want[-1]} and 0")
        got = {k: counted["b: resumed"].get(k, 0) for k in (
            "engine.resumes", "engine.egress_rows_replayed", "engine.checkpoints_written")}
        check(got == {"engine.resumes": 1, "engine.egress_rows_replayed": 0,
                      "engine.checkpoints_written": len(range(want[-1] + EGRESS_CHECKPOINT_EVERY,
                                                              EGRESS_RESUME_BATCHES + 1,
                                                              EGRESS_CHECKPOINT_EVERY))}
              and counted["b: killed"].get("engine.checkpoints_written", 0) == len(want),
              f"egress (b): counters of the resumed run {got}, of the killed run "
              f"{counted['b: killed']}")
        log(f"egress (b): counters of the resumed run {got}")
        check(resumed.row_level_egress.status == "complete", "egress (b): not complete")
        digests = split_digest(f"{base}/whole"), split_digest(f"{base}/resumed")
        check(digests[0] == digests[1], f"egress (b): the resumed split's sha256 {digests[1]} "
              f"differs from the uninterrupted run's {digests[0]}")
        check(egress_manifest(f"{base}/whole") == egress_manifest(f"{base}/resumed"),
              "egress (b): the manifests differ")
        check(not os.path.exists(f"{base}/resumed/spans")
              and not os.path.exists(f"{base}/resumed/_scan_bits.spool"),
              "egress (b): the resumed run left its span segments")
        log(f"egress (b): killed at batch {EGRESS_KILL_AT}, resumed at batch {engine.resumed_at} "
            f"in {t_resume:.3f} s with no row written again; the split's sha256 equal the "
            f"uninterrupted run's (clean {digests[0]['clean'][:16]}, quarantine "
            f"{digests[0]['quarantine'][:16]}), and so do the manifests")
        del whole, resumed
    finally:
        writer_mod.QuarantineWriter.__init__ = init
        shutil.rmtree(base, ignore_errors=True)
        shutil.rmtree(ckdir, ignore_errors=True)
    check(not os.path.exists(base) and not os.path.exists(ckdir),
          "egress (b): a directory was not removed")
    head.clear_device_cache()
    gc.collect()
    torch.cuda.empty_cache()
    return total


def egress_pair(torch, np, table, rows: int, budget, requests):
    """``--egress-only``: phase 11 (a)'s run over its first EGRESS_BATCHES
    batches through each write path of the writer, at (a)'s budget: a run
    without a checkpointer writes the split directly; one with a
    checkpointer (here one that takes no checkpoint) writes span segments
    and compacts them at the end. Both splits' sha256 and manifests must
    be equal; the walls and the writer's seconds are logged."""
    import gc
    import threading

    import deequ_tpu_torch as T
    from deequ_tpu_torch import config
    from deequ_tpu_torch.egress import RowLevelSink
    from deequ_tpu_torch.egress import writer as writer_mod

    batch = T.AnalysisEngine()._resolve_batch_size(rows)
    dataset = table.slice_rows(0, EGRESS_BATCHES * batch)
    rows_a = dataset.num_rows
    budget_a = min(budget * rows_a // rows, dataset.estimated_device_bytes(requests) - 1)
    checks, rl = stream_checks(T), egress_check(T)
    writers = []
    init = writer_mod.QuarantineWriter.__init__

    def recording_init(self, *args, **kwargs):
        init(self, *args, **kwargs)
        writers.append(self)

    digests, manifests, walls = {}, {}, {}
    writer_mod.QuarantineWriter.__init__ = recording_init
    try:
        for label in ("direct", "segments"):
            out = egress_dir(rows_a, dataset.num_columns, f"a: {label}")
            ckdir = checkpoint_dir(rows_a) if label == "segments" else None
            try:
                # the checkpointer's interval is past the last batch: the
                # writer goes through segments, and no checkpoint is taken
                engine = (T.AnalysisEngine() if ckdir is None else T.AnalysisEngine(
                    checkpointer=T.ScanCheckpointer(ckdir, every_batches=EGRESS_BATCHES + 1)))
                with config.configure(device_cache_bytes=budget_a):
                    t0 = time.perf_counter()
                    result = (T.VerificationSuite().on_data(dataset).add_checks([checks, rl])
                              .with_engine(engine)
                              .with_row_level_sink(RowLevelSink(out, tenant="smoke",
                                                                run_id="egress-a"))
                              .run())
                    torch.cuda.synchronize()
                    walls[label] = time.perf_counter() - t0
                report, writer = result.row_level_egress, writers[-1]
                log_writer(f"a: {label}", writer, report, walls[label], rows_a)
                check(report.status == "complete" and report.rows_written == rows_a,
                      f"egress (a: {label}): {report.status}, {report.rows_written} rows")
                check(writer.durable == (label == "segments") and not engine.checkpoints,
                      f"egress (a: {label}): durable {writer.durable}, checkpoints "
                      f"{engine.checkpoints}")
                digests[label] = split_digest(out)
                manifests[label] = egress_manifest(out)
                left = [t.name for t in threading.enumerate()
                        if t.name.startswith("deequ-egress")]
                check(not left, f"egress (a: {label}): writer threads left: {left}")
                del result, engine
            finally:
                shutil.rmtree(out, ignore_errors=True)
                if ckdir is not None:
                    shutil.rmtree(ckdir, ignore_errors=True)
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        writer_mod.QuarantineWriter.__init__ = init
    check(digests["direct"] == digests["segments"], f"egress (a): the direct split's sha256 "
          f"{digests['direct']} differs from the segments' {digests['segments']}")
    check(manifests["direct"] == manifests["segments"], "egress (a): the manifests differ")
    log(f"egress (a): {rows_a} rows, every column, direct {walls['direct']:.3f} s and "
        f"through segments {walls['segments']:.3f} s "
        f"({walls['segments'] / walls['direct']:.3f}x); the splits' sha256 and manifests equal")


ISOLATION_ROWS = 1 << 21  # phase 12's table: one batch of a seeded int64 column
ISOLATION_COOLDOWN_S = 30.0  # phase 12 (a)'s breaker cooldown, on a ManualClock
ISOLATION_TIMEOUT_S = 5.0  # phase 12 (c)'s launch timeout


def isolation_k1_run(torch, np, seed: int):
    """K1's fused entry through the package's entry point: the
    approximate distinct count of one seeded int64 column (one batch of
    ISOLATION_ROWS rows, about 4% nulls) on the card, its registers held
    against the plain whole-column build. Host values only."""
    import deequ_tpu_torch as T
    from deequ_tpu_torch.analyzers import ApproxCountDistinct

    rng = np.random.default_rng(seed)
    values = np.ma.masked_array(rng.integers(-(2**62), 2**62, ISOLATION_ROWS),
                                rng.random(ISOLATION_ROWS) < NULL_SHARE)
    dataset = T.Dataset.from_pydict({"x": values})
    states = {}

    class Keep:
        def persist(self, analyzer, state):
            states[analyzer] = state

    engine = T.AnalysisEngine()
    result = (T.VerificationSuite().on_data(dataset)
              .add_check(T.Check(T.CheckLevel.ERROR, "isolation").has_approx_count_distinct(
                  "x", lambda v: v > 0))
              .with_engine(engine).save_states_with(Keep()).run())
    got = states[ApproxCountDistinct("x")].registers
    plain = plain_registers(torch, np, dataset, "x", engine.device)
    dataset.clear_device_cache()
    return {"equal": bool(torch.equal(got.cpu(), plain)), "status": result.status.value,
            "device": str(engine.device),
            "batches": -(-ISOLATION_ROWS // engine._resolve_batch_size(ISOLATION_ROWS))}


def isolation_k1_child(payload):
    """Phase 12's clean child: its start by part, then
    ``isolation_k1_run`` on the card and K1's launches in this process."""
    import numpy as np
    import torch

    start = child_start(torch)
    t0 = time.perf_counter()
    out = isolation_k1_run(torch, np, payload["seed"])
    out.update(start=start, work_s=time.perf_counter() - t0, launches=k1_launches())
    return out


def isolation_segv_child(payload):
    """Phase 12 (a)'s poison: a SIGSEGV at once."""
    import signal

    from deequ_tpu_torch.testing.faults import hard_crash

    hard_crash(signal.SIGSEGV)


def isolation_assert_child(payload):
    """Phase 12 (b): a gather at an index past the end of its source on
    the card, which trips CUDA's device-side assert: a sticky error that
    leaves this process's CUDA context unusable."""
    import torch

    source = torch.arange(16, dtype=torch.float32, device="cuda")
    index = torch.full((4,), payload["index"], dtype=torch.int64, device="cuda")
    out = torch.gather(source, 0, index)
    torch.cuda.synchronize()
    return {"gathered": out.tolist()}


def isolation_sleep_child(payload):
    """Phase 12 (c): work that outlives its launch's timeout."""
    time.sleep(payload["seconds"])


def isolation_phase(torch, np, seed: int):
    """Phase 12, crash isolation (``engine/subproc.py``) on the card with
    small inputs; returns K1's launches in its children and in this
    process. (a) A child that SIGSEGVs at once, ``max_relaunches`` 2: the
    runner raises ``CrashLoopError`` after two launches, the plan's
    breaker opens and the next launch raises ``BreakerOpen`` with no
    child spawned; past the cooldown (a ``ManualClock``) one half-open
    probe runs a clean child that launches K1's fused entry on the card
    against its plain version, and the breaker closes. (b) A child whose
    gather trips CUDA's device-side assert: the error comes back in-band,
    this process's CUDA context still runs K1 bit-equal, and the next
    child runs clean. (c) A child past its ``timeout_s`` of 5 s is
    terminated and classified. Every child is reaped."""
    import multiprocessing

    from deequ_tpu_torch.engine.deadline import ManualClock
    from deequ_tpu_torch.engine.subproc import (BreakerOpen, CircuitBreaker, CrashLoopError,
                                                IsolatedRunner, ProcessCrashed)
    from deequ_tpu_torch.sketches import scatter_max as sm
    from deequ_tpu_torch.telemetry import get_telemetry

    tm = get_telemetry()
    names = ("engine.child_crashes", "engine.child_relaunches", "engine.crash_loops",
             "engine.breaker_trips", "engine.crash_resumes")
    before = {n: tm.counter(n).value for n in names}
    total = {}

    def add(launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    def clean(label, got):
        want = {"hll_scatter_max": 0, "hll_update": got["batches"], "hll_update_codes": 0,
                "hll_update_codes_rows": 0}
        check(got["equal"] and got["status"] == "Success" and got["device"].startswith("cuda"),
              f"isolation ({label}): the child's run {got}")
        check(got["launches"] == want, f"isolation ({label}): K1 launches {got['launches']}, "
              f"not {want}")
        add(got["launches"])
        log(f"isolation ({label}): a clean child on {got['device']}: {fmt_start(got['start'])}; "
            f"its run {got['work_s']:.3f} s, K1's registers equal the plain build")

    parts = {}
    t_part = time.perf_counter()
    clock = ManualClock()
    breaker = CircuitBreaker(ISOLATION_COOLDOWN_S, clock=clock)
    runner = IsolatedRunner(key="smoke:poison", max_relaunches=2, breaker=breaker)
    t0 = time.perf_counter()
    try:
        runner.run(isolation_segv_child, {})
        check(False, "isolation (a): the poison child did not crash")
    except CrashLoopError as exc:
        check(exc.launches == 2 and exc.last_signal == "SIGSEGV",
              f"isolation (a): {exc.launches} launches, last {exc.last_signal}")
        log(f"isolation (a): crash loop after {exc.launches} launches in "
            f"{time.perf_counter() - t0:.3f} s: {exc}")
    check(breaker.state == "open", f"isolation (a): the breaker is {breaker.state}")
    crashes = tm.counter("engine.child_crashes").value
    t0 = time.perf_counter()
    try:
        runner.run(isolation_k1_child, {"seed": seed})
        check(False, "isolation (a): an open breaker let a launch through")
    except BreakerOpen as exc:
        check(multiprocessing.active_children() == []
              and tm.counter("engine.child_crashes").value == crashes,
              "isolation (a): an open breaker spawned a child")
        log(f"isolation (a): refused in {(time.perf_counter() - t0) * 1e3:.3f} ms without a "
            f"child: {exc}")
    clock.advance(ISOLATION_COOLDOWN_S)
    clean("a, the half-open probe", runner.run(isolation_k1_child, {"seed": seed}))
    check(breaker.state == "closed", f"isolation (a): the probe left the breaker {breaker.state}")
    parts["a"] = time.perf_counter() - t_part

    t_part = time.perf_counter()
    runner = IsolatedRunner(key="smoke:device assert", max_relaunches=2, use_breaker=False)
    try:
        runner.run(isolation_assert_child, {"index": 1 << 20})
        check(False, "isolation (b): the out-of-range gather did not fail")
    except ProcessCrashed as exc:
        check(False, f"isolation (b): the device assert came back as a crash: {exc}")
    except Exception as exc:  # noqa: BLE001 — the child's own error, in-band
        text = f"{type(exc).__name__}: {exc}"
        check("device-side assert" in text, f"isolation (b): the child raised {text[:500]}")
        log(f"isolation (b): the child's device-side assert came back in-band: "
            f"{text.splitlines()[0][:200]}")
    sm.launches = sm.fused_launches = sm.codes_launches = sm.codes_rows_launches = 0
    here = isolation_k1_run(torch, np, seed)
    here["launches"] = k1_launches()
    check(here["equal"] and here["status"] == "Success"
          and here["launches"]["hll_update"] == here["batches"],
          f"isolation (b): this process's K1 run after the child's assert {here}")
    add(here["launches"])
    log("isolation (b): this process's CUDA context still runs K1 bit-equal to the plain build")
    clean("b, the next child", runner.run(isolation_k1_child, {"seed": seed + 1}))
    parts["b"] = time.perf_counter() - t_part

    t_part = time.perf_counter()
    runner = IsolatedRunner(key="smoke:timeout", max_relaunches=1,
                            timeout_s=ISOLATION_TIMEOUT_S, use_breaker=False)
    try:
        runner.run(isolation_sleep_child, {"seconds": 600})
        check(False, "isolation (c): the sleeping child returned")
    except CrashLoopError as exc:
        waited = time.perf_counter() - t_part
        check(exc.last_signal == "timeout" and exc.launches == 1
              and ISOLATION_TIMEOUT_S <= waited < ISOLATION_TIMEOUT_S + 60,
              f"isolation (c): {exc.launches} launches, last {exc.last_signal}, {waited:.1f} s")
        log(f"isolation (c): terminated past {ISOLATION_TIMEOUT_S} s and classified in "
            f"{waited:.3f} s: {exc}")
    parts["c"] = time.perf_counter() - t_part

    check(multiprocessing.active_children() == [], "isolation: a child was left")
    delta = {n: tm.counter(n).value - before[n] for n in names}
    want = {"engine.child_crashes": 3, "engine.child_relaunches": 1, "engine.crash_loops": 2,
            "engine.breaker_trips": 1, "engine.crash_resumes": 0}
    check(delta == want, f"isolation: counters {delta}, not {want}")
    log(f"isolation: counters {delta}; no child left; seconds by part "
        + ", ".join(f"({k}) {v:.1f}" for k, v in parts.items()))
    return total


def isolation_only(torch, np, seed: int) -> None:
    """Phases 1, 2 and 12 alone."""
    phase("1: device")
    device_phase(torch)
    phase("2: build")
    build_phase()
    phase("12: crash isolation")
    isolation_phase(torch, np, seed)


def egress_only(torch, np, rows: int, seed: int, part: str) -> None:
    """``--egress-only PART``: phases 1 and 2, phase 6's table from
    ``seed``, 7a's resident oracle, then phase 11 (a) over the WHOLE table
    at 7a's budget (``whole``: its peak held under that budget, every
    check of (a)) or ``egress_pair`` (``pair``)."""
    import deequ_tpu_torch as T
    from deequ_tpu_torch import config

    phase("1: device")
    device_phase(torch)
    phase("2: build")
    build_phase()
    phase("11's inputs: phase 6's table and 7a's column requests")
    t0 = time.perf_counter()
    table = T.Dataset.from_pydict(store_sales_full(T, np, rows, seed))
    log(f"egress-only: phase 6's table, {rows} rows, in {time.perf_counter() - t0:.3f} s")
    requests = []
    resident_oracle(torch, T, config, table, stream_checks(T), "egress-only", requests)
    table.clear_device_cache()
    torch.cuda.empty_cache()
    budget = min(DEFAULT_BUDGET, table.estimated_device_bytes(requests[-1]) - 1)
    batch = T.AnalysisEngine()._resolve_batch_size(rows)
    if part == "whole":
        phase("11: row-level egress, (a) over the whole table")
        egress_phase(torch, np, table, rows, budget, requests[-1], batches_a=-(-rows // batch),
                     resume=False)
    else:
        phase("11: (a)'s write paths paired")
        egress_pair(torch, np, table, rows, budget, requests[-1])


def mesh_only(torch, np, rows: int, seed: int, ranks: int) -> None:
    """``--mesh-only RANKS``: phases 1, 2 and 10 alone, for a machine with
    several cards (NCCL, one rank a card): phase 6's table from ``seed``,
    7a's resident oracle over it, phase 8's parquet files, then phase 10
    over ``ranks`` ranks at the package's default budget."""
    import deequ_tpu_torch as T
    from deequ_tpu_torch import config

    phase("1: device")
    device_phase(torch)
    phase("2: build")
    build_phase()
    phase("10's inputs: phase 6's table, 7a's oracle, phase 8's files")
    t0 = time.perf_counter()
    table = T.Dataset.from_pydict(store_sales_full(T, np, rows, seed))
    log(f"mesh-only: phase 6's table, {rows} rows, in {time.perf_counter() - t0:.3f} s")
    oracle, oracle_states = resident_oracle(torch, T, config, table, stream_checks(T),
                                            "mesh-only")
    table.clear_device_cache()
    torch.cuda.empty_cache()
    directory = tempfile.mkdtemp(prefix="deequ_smoke_parquet_")
    try:
        write_s, on_disk, files = write_parquet(np, table, rows, directory)
        log(f"mesh-only: wrote {files} parquet files, {on_disk / 1e9:.3f} GB, in "
            f"{write_s:.3f} s")
        phase("10: the dp mesh")
        mesh_phase(torch, np, table, rows, directory, oracle, oracle_states, DEFAULT_BUDGET,
                   ranks)
    finally:
        shutil.rmtree(directory, ignore_errors=True)


def mesh_grouping_expected(np, table, rows: int):
    """MESH_GROUPING's values computed with numpy from the in-memory
    table: a ticket is 12 consecutive rows; the key pair repeats only as
    an item twice within a ticket; the customer histogram's 1,000 bins
    are the null bin and the 999 most frequent keys, ties in key order
    (the spill's top-k rule)."""
    from deequ_tpu_torch.data.table import ColumnRequest

    tickets = -(-rows // 12)
    tail = rows - (tickets - 1) * 12
    ticket_unique = (1 if tail == 1 else 0) / rows
    item = table.materialize(ColumnRequest("ss_item_sk", "values"))
    full = rows // 12 * 12
    blocks = np.sort(item[:full].reshape(-1, 12), axis=1)
    same = blocks[:, 1:] == blocks[:, :-1]
    repeated = np.zeros(blocks.shape, dtype=bool)
    repeated[:, 1:] |= same
    repeated[:, :-1] |= same
    _, tail_counts = np.unique(item[full:], return_counts=True)
    pk_unique = (int((~repeated).sum()) + int((tail_counts == 1).sum())) / rows
    cust = table.materialize(ColumnRequest("ss_customer_sk", "values"))
    valid = table.materialize(ColumnRequest("ss_customer_sk", "mask"))
    counts = np.bincount(cust[valid])
    keys = np.flatnonzero(counts)
    order = np.lexsort((keys, -counts[keys]))
    nulls = rows - int(valid.sum())
    bins = [(str(int(k)), int(counts[k])) for k in keys[order[:1000]]]
    if nulls:
        bins = sorted(bins + [("NullValue", nulls)], key=lambda kv: -kv[1])[:1000]
    histogram = (dict(bins), len(keys) + (1 if nulls else 0))
    return [float(tickets), ticket_unique, pk_unique, histogram]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--rows", type=int, default=100_000_000)
    parser.add_argument("--mesh-only", type=int, metavar="RANKS",
                        help="run phases 1, 2 and 10 alone, phase 10 over RANKS ranks (for a "
                             "machine with several cards), and print no result lines")
    parser.add_argument("--isolation-only", action="store_true",
                        help="run phases 1, 2 and 12 (crash isolation) alone, and print no "
                             "result lines")
    parser.add_argument("--egress-only", choices=("whole", "pair"),
                        help="run phases 1 and 2, then phase 11 (a) over the whole table "
                             "(whole) or its write paths paired over 12 batches (pair), and "
                             "print no result lines")
    args = parser.parse_args(argv)

    t_start = time.perf_counter()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    try:
        import deequ_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: deequ_tpu_torch is not importable: {exc}",
              file=sys.stderr)
        return 2

    if args.mesh_only is not None:
        try:
            mesh_only(torch, np, args.rows, args.seed, args.mesh_only)
        except SmokeFailure as exc:
            print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
            return 1
        log(f"mesh-only: passed, wall {time.perf_counter() - t_start:.1f} s")
        return 0
    if args.isolation_only:
        try:
            isolation_only(torch, np, args.seed)
        except SmokeFailure as exc:
            print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
            return 1
        log(f"isolation-only: passed, wall {time.perf_counter() - t_start:.1f} s")
        return 0
    if args.egress_only:
        try:
            egress_only(torch, np, args.rows, args.seed, args.egress_only)
        except SmokeFailure as exc:
            print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
            return 1
        log(f"egress-only: passed, wall {time.perf_counter() - t_start:.1f} s")
        return 0
    try:
        phase("1: device")
        device_phase(torch)
        phase("2: build")
        build_phase()
        phase("3: kernels against their plain versions")
        scatter = kernel_phase(torch)
        k1 = [fused_kernel_phase(torch), codes_kernel_phase(torch)]
        probes = probe_kernel_phase(torch)
        # phases 4 and 6 stay resident, as they ran before the streamed
        # scan existed, so their numbers stay comparable
        from deequ_tpu_torch import config

        phase("4: main path")
        with config.configure(device_cache_bytes=RESIDENT_BUDGET):
            main_launches, coalesced_launches = main_phase(torch, np, min(args.rows, MAIN_ROWS),
                                                           args.seed)
        phase("5: scatter probe")
        launches = probe_phase()
        scatter["launches"] = launches["hll_scatter_max"]
        for record, kernel in zip(probes, ("P1", "P2", "P3")):
            record["launches"] = launches[kernel]
        phase("6: profile and suggestion")
        with config.configure(device_cache_bytes=RESIDENT_BUDGET):
            profile_launches, rows_form, table = profile_phase(torch, np, args.rows, args.seed)
        k1.append(rows_form)
        phase("7: the streamed suite and the daily pipeline")
        stream_launches, oracle, oracle_states, pack_7a, budget, requests = stream_phase(
            torch, np, table, args.rows)
        phase("8: the streamed suite over parquet files")
        parquet_dir = tempfile.mkdtemp(prefix="deequ_smoke_parquet_")
        try:
            one_thread_launches, parquet_launches, resumed_launches = parquet_phase(
                torch, np, table, args.rows, oracle, oracle_states, pack_7a, budget,
                parquet_dir)
            phase("9: resilience on the card")
            resilience_launches = resilience_phase(torch, np, table, args.rows, budget,
                                                   requests)
            phase("10: the dp mesh")
            mesh_launches = mesh_phase(torch, np, table, args.rows, parquet_dir, oracle,
                                       oracle_states, budget)
        finally:
            shutil.rmtree(parquet_dir, ignore_errors=True)
        phase("11: row-level egress")
        egress_launches = egress_phase(torch, np, table, args.rows, budget, requests)
        del table, oracle, oracle_states
        phase("12: crash isolation")
        isolation_launches = isolation_phase(torch, np, args.seed)
        # K1's main-path launches: the suite's (phase 4) and its coalesced
        # run's, the profile's, the streamed suite's, the parquet-streamed
        # suite's (one thread, the pool, the isolated children of the
        # resume), phase 9's runs, phase 10's ranks, the egress runs and
        # phase 12's children and its run in this process
        by_phase = (("4", main_launches), ("4 (coalesced)", coalesced_launches),
                    ("6", profile_launches), ("7a", stream_launches),
                    ("8 (b)", one_thread_launches), ("8 (c)", parquet_launches),
                    ("8 (d)", resumed_launches),
                    ("9", resilience_launches), ("10", mesh_launches), ("11", egress_launches),
                    ("12", isolation_launches))
        for record in k1:
            name = record["name"]
            record["launches"] = sum(launches[name] for _, launches in by_phase)
            log(f"{name}: main-path launches " + ", ".join(
                f"phase {phase} {launches[name]}" for phase, launches in by_phase))
        k1.insert(0, scatter)
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    log(f"smoke: wall {time.perf_counter() - t_start:.1f} s, the kernels' build included")
    print(json.dumps({"kernels": k1 + probes}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
