#!/usr/bin/env python3
"""Smoke test of deequ_tpu_torch on one NVIDIA GPU (built for an H100).

Run from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py [--seed 0] [--rows 100000000]

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
             host from ``--seed``, through the package's normal entry
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
             them, and with the sketch constraints too, and profile each
             for device time by kernel, the idle share and the count of
             launches and ops (the hash's elementwise ops must be gone
             from the whole suite's profile), with the KLL sort's device
             ms a batch and the seconds of host fold; then a rerun with
             the grouping constraints too (its sorts, scatters and peak
             memory), and the two forms of the spill segment count and
             of the dense scatter timed on the plans' own data;
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
             hold every field against numpy (the HLL registers against
             the plain build and each estimate against the exact count,
             the types and type counts, the two histograms, the stats,
             each of the 99 percentiles' ranks within the bound of a
             replay of every batch's KLL output); assert two passes, no
             third, and K1's launches against the planner's (the codes
             entry in its per-row form); rerun the profile on the
             resident columns, then once more under the profiler (device
             time by kernel, the idle share, the KLL sort a batch, the
             per-row codes kernel a batch); hold that kernel against its
             plain version at the path's shape and time it; then run
             ``ConstraintSuggestionRunner`` with the default rules and a
             20% holdout and hold each suggested constraint's holdout
             result against numpy's evaluation of it on the same rows.

The line before the last lists the kernels as JSON; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
package beside this script, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import math
import re
import subprocess
import sys
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
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and kernel in e.key]
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


def profile_rerun(torch, rerun, label, tables=True, hash_check=True):
    """Device time by kernel, and the device's idle share, over one more
    run on resident columns; returns the device ms and calls by PyTorch
    op. ``hash_check``: the HLL hash's elementwise ops must be gone (the
    KLL step's offset hashes C words a batch with them, so a suite with
    sketches skips the check)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rerun()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    device_ops = sum(e.count for e in prof.key_averages()
                     if e.device_type == DeviceType.CPU and e.key.startswith("aten::")
                     and e.self_device_time_total > 0)
    log(f"profile ({label}): rerun wall {wall_ms:.3f} ms, kernels {busy_ms:.3f} ms, "
        f"device idle share {1 - busy_ms / wall_ms:.3f}; "
        f"{sum(e.count for e in kernels)} kernel launches, {device_ops} PyTorch ops "
        "that ran on the device")
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
    profile_rerun(torch, base_rerun, "without filters and predicates", tables=False)
    profile_rerun(torch, full_rerun, "filters and predicates")
    op_ms = profile_rerun(torch, sketch_rerun, "whole suite with sketches, types and patterns",
                          hash_check=False)
    for op in ("aten::sort", "aten::gather", "aten::scatter_add_"):
        ms, count = op_ms.get(op, (0.0, 0))
        log(f"profile: {op} {ms:.3f} ms in {count} calls, {ms / nb:.4f} ms a batch")
    grouping_phase(torch, np, T, dataset, engine, grouping_rerun, rows, nb, batch, collected)
    return launches


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


def grouping_phase(torch, np, T, dataset, engine, grouping_rerun, rows, nb, batch, collected):
    """The rerun with the grouping constraints, profiled, with its peak
    memory; then the two forms of the spill segment count on each
    collector's own keys, and of the dense per-batch scatter at the
    dense plans' widths."""
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
    op_ms = profile_rerun(torch, grouping_rerun, "whole suite with the grouping constraints",
                          hash_check=False)
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
    profile and the codes rows form's kernel record."""
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

    # the planner's HLL units over these columns: the launches a batch
    units, _ = vectorize.plan_scan_units(
        dataset, [T.ApproxCountDistinct(c) for c in columns])
    per_batch = {"hll_scatter_max": 0, "hll_update": 0, "hll_update_codes": 0,
                 "hll_update_codes_rows": 0}
    for unit in units:
        if unit.requests[0].repr != "codes":
            per_batch["hll_update"] += 1
            continue
        width = unit.ops.consts["h1"].shape[1]
        bitmap = sm.plan_codes(len(unit.members), batch, width, sms).bitmap
        per_batch["hll_update_codes" if bitmap else "hll_update_codes_rows"] += 1
        log(f"profile: codes unit over {[a.column for a in unit.members]}, D={width} "
            f"({'bitmap' if bitmap else 'rows'} form)")
    expected = {k: v * nb for k, v in per_batch.items()}

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

    # the rerun on the resident columns, then again under the profiler
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
    profile_device_time(torch, rerun, nb)

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
    return launches, record_


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
    """Every field of the profile against numpy on the host columns (or
    an exact sort on the card where numpy would take minutes)."""
    from deequ_tpu_torch.data.table import ColumnRequest

    def host(c, rep):
        return dataset.materialize(ColumnRequest(c, rep))

    def close(a, b, rtol):
        return math.isclose(a, b, rel_tol=rtol, abs_tol=rtol)

    check(profiles.num_records == rows, f"num_records {profiles.num_records}")
    columns = dataset.schema.column_names
    check(list(profiles.profiles) == columns, "profiled columns differ from the table's")
    zip_values = None
    for c in columns:
        p = profiles[c]
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
                           "Integral": n_int, "Boolean": 0, "String": int(mask.sum()) - n_int}
            check(p.type_counts == want_counts, f"type counts of {c}: {p.type_counts} vs {want_counts}")
            want_kind = "Integral" if c == "ca_zip" else "String"
            check(p.data_type.value == want_kind and p.is_data_type_inferred,
                  f"type of {c}: {p.data_type} (inferred {p.is_data_type_inferred})")
            if c == "ca_zip":
                parsed = np.array([float(v) for v in dictionary])
                zip_values = parsed[codes[codes >= 0]]
        else:
            check(p.data_type.value == kind and not p.is_data_type_inferred, f"type of {c}")
        # HLL: registers against the plain build, the estimate against
        # the exact distinct count (a sort on the card)
        registers = states[T.ApproxCountDistinct(c)].registers
        check(torch.equal(registers, plain_registers(torch, np, dataset, c, device)),
              f"HLL registers of {c} differ from the plain whole-column build")
        rep = "codes" if kind == "String" else dataset.hll_repr(c)
        values = dataset.device_column(ColumnRequest(c, rep), device)
        valid = dataset.device_column(ColumnRequest(c, "mask"), device)
        exact = int(torch.unique(values[valid]).numel())
        err = abs(p.approximate_num_distinct_values - exact) / max(exact, 1)
        check(err <= 3 * 1.04 / math.sqrt(16384),
              f"HLL estimate of {c}: {p.approximate_num_distinct_values} vs exact {exact}")
        log(f"profile: {c}: completeness {p.completeness}, approx distinct "
            f"{p.approximate_num_distinct_values:.1f} (exact {exact}, error {err:.5f}), "
            f"type {p.data_type.value}")
    check(zip_values is not None, "ca_zip was not checked")

    # histograms: exactly the speculated low-cardinality columns
    quantity = host("ss_quantity", "values")[host("ss_quantity", "mask")]
    q_counts = np.bincount(quantity)
    want = {str(v): int(q_counts[v]) for v in np.nonzero(q_counts)[0]}
    want["NullValue"] = rows - len(quantity)
    cat = host("i_category", "codes")
    c_counts = np.bincount(cat + 1, minlength=len(CATEGORIES) + 1)
    want_cat = {name: int(c_counts[i + 1]) for i, name in enumerate(CATEGORIES) if c_counts[i + 1]}
    want_cat["NullValue"] = int(c_counts[0])
    for c, w in (("ss_quantity", want), ("i_category", want_cat)):
        got = {k: v.absolute for k, v in profiles[c].histogram.values.items()}
        check(got == w, f"histogram of {c}: {got} vs {w}")
        check(all(v.ratio == v.absolute / rows for v in profiles[c].histogram.values.values()),
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
        if c == "ca_zip":
            vals = zip_values
        else:
            vals = host(c, "values")[host(c, "mask")].astype(np.float64)
        mean = float(vals.mean())
        want = {"mean": mean, "sum": float(vals.sum()), "minimum": float(vals.min()),
                "maximum": float(vals.max()),
                "std_dev": float(np.sqrt(np.mean((vals - mean) ** 2)))}
        rtol = RTOL_F32 if c == "ss_wholesale_cost" else RTOL_F64
        for field, w in want.items():
            got = getattr(p, field)
            ok = got == w if field in ("minimum", "maximum") else close(got, w, rtol)
            check(ok, f"{field} of {c}: {got!r} vs numpy {w!r}")
        outs, i = units[c]
        replay, bound = kll_replay(outs, i)
        state = states[T.ApproxQuantiles(c, PERCENTILES)]
        check(all(np.array_equal(a, b) for a, b in zip(
            state.to_arrays().values(), replay.to_arrays().values())),
              f"sketch of {c} differs from the replay of its outputs")
        x = torch.from_numpy(f32_like_xla(np, vals).astype(np.float64)).to(device)
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
        log(f"profile: {c}: stats equal numpy; 99 percentiles within the rank bound "
            f"{bound / n:.6f} (worst error {err:.6f})")
    log(f"profile: every field equals numpy; worst percentile rank error {worst:.6f}")


def profile_device_time(torch, rerun, nb):
    """Device time by kernel, the idle share, launches and ops of one
    profile rerun; the KLL sort's device ms a batch by its shape, and the
    codes rows kernel's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        rerun()
        wall_ms = (time.perf_counter() - t0) * 1e3
    averages = prof.key_averages()
    kernels = [e for e in averages if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    ops = [e for e in averages if e.device_type == DeviceType.CPU and e.key.startswith("aten::")
           and e.self_device_time_total > 0]
    log(f"profile (profile_rerun): wall {wall_ms:.3f} ms, kernels {busy_ms:.3f} ms, device idle "
        f"share {1 - busy_ms / wall_ms:.3f}; {sum(e.count for e in kernels)} kernel launches, "
        f"{sum(e.count for e in ops)} PyTorch ops that ran on the device")
    log("profile (profile_rerun): device time by kernel:")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]:
        log(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:6d}x  {e.key[:100]}")
    log("profile (profile_rerun): device time by PyTorch op:")
    for e in sorted(ops, key=lambda e: -e.self_device_time_total)[:15]:
        log(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:6d}x  {e.key}")
    for e in prof.key_averages(group_by_input_shape=True):
        if e.key == "aten::sort" and e.self_device_time_total > 0:
            log(f"profile (profile_rerun): aten::sort over {e.input_shapes[0] if e.input_shapes else '?'}: "
                f"{e.self_device_time_total / 1e3:.3f} ms in {e.count} calls, "
                f"{e.self_device_time_total / 1e3 / e.count:.4f} ms a call")
    rows_kernel = [e for e in kernels if "hll_codes_rows_kernel" in e.key]
    check(bool(rows_kernel), "the profile rerun launched no hll_codes_rows_kernel")
    ms = sum(e.self_device_time_total for e in rows_kernel) / 1e3
    n = sum(e.count for e in rows_kernel)
    log(f"profile (profile_rerun): hll_codes_rows_kernel {ms:.3f} ms in {n} launches, "
        f"{ms / n:.4f} ms a batch")


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


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--rows", type=int, default=100_000_000)
    args = parser.parse_args(argv)

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

    try:
        log("== phase 1: device")
        device_phase(torch)
        log("== phase 2: build")
        build_phase()
        log("== phase 3: kernels against their plain versions")
        scatter = kernel_phase(torch)
        k1 = [fused_kernel_phase(torch), codes_kernel_phase(torch)]
        probes = probe_kernel_phase(torch)
        log("== phase 4: main path")
        main_launches = main_phase(torch, np, args.rows, args.seed)
        log("== phase 5: scatter probe")
        launches = probe_phase()
        scatter["launches"] = launches["hll_scatter_max"]
        for record, kernel in zip(probes, ("P1", "P2", "P3")):
            record["launches"] = launches[kernel]
        log("== phase 6: profile and suggestion")
        profile_launches, rows_form = profile_phase(torch, np, args.rows, args.seed)
        k1.append(rows_form)
        # K1's main-path launches: the suite's (phase 4) and the profile's
        for record in k1:
            record["launches"] = main_launches[record["name"]] + profile_launches[record["name"]]
        k1.insert(0, scatter)
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
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
