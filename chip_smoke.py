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
             same function, at the shapes the main path gives the kernel.
             K1 has two entries: ``(idx, rho)`` and the fused update from
             raw values (``hll_update``), which is also timed against the
             parent's unfused chain; one call of each entry runs under
             ``torch.cuda.set_sync_debug_mode("error")`` to show that
             neither reads the device back, and each is timed with the
             SM count read on every launch and cached. The probe kernels
             P1-P3 are held against theirs in every case; P1's and P2's
             plan is logged, one call of each runs under the sync debug
             mode, the host time of P2's launch path is split step by
             step, and their skip and load options are timed;
4. main    — run one VerificationSuite on a table shaped like TPC-DS
             ``store_sales`` (spec v3, section 2.3.12), generated on the
             host from ``--seed``, through the package's normal entry
             points: statistics, completeness, approximate distinct
             counts, ``where=`` filters on each group family, Compliance
             predicates, correlation and string lengths. Check the
             launch counts of both K1 entries (the fused one twice a
             batch, ``(idx, rho)`` once), one data pass and one state
             fetch, HLL registers against the plain version over whole
             (filtered) columns, and every metric against numpy; then
             time reruns on the resident columns with and without the
             filter and predicate constraints, and profile both for
             device time by kernel and the idle share (the hash's
             elementwise ops must be gone from the whole suite's
             profile);
5. probe   — run the scatter probe (``deequ_tpu_torch.tools
             .scatter_probe``) in-process in default mode (P1-P3 against
             the library scatter, B = 2^21) and in ``--prod`` mode (K1 at
             C = 40, B = 2^21); every variant must be bit-identical, and
             the P1-P3 launches are counted from this run.

The line before the last lists the kernels as JSON; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
package beside this script, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import math
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

    def hashed(cols, rows, valid_share=0.96):
        h = torch.randint(0, 1 << 32, (2, cols, rows), generator=gen,
                          device=dev, dtype=torch.int64)
        mask = torch.rand((cols, rows), generator=gen, device=dev) < valid_share
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
        "presence C=1 B=16 (main path)": hashed(1, 16, valid_share=0.6),
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

    presence = cases["presence C=1 B=16 (main path)"]
    sm_cache_ab(torch, "hll_scatter_max at C=1 B=16",
                lambda: sm._launch(*presence, M))
    # the main path gives this entry only the presence path's shape
    # (i_category: C=1, B=16); C=4, B=2^21, where numeric columns used to
    # reach it, is logged for comparison with earlier records
    stacked = timed(*cases["random C=4 B=2^21"])
    log(f"hll_scatter_max at {stacked['shape']}: kernel {stacked['ms']:.4f} ms, "
        f"plain {stacked['plain_ms']:.4f} ms, library {stacked['library_ms']:.4f} ms")
    return kernel_record(
        "hll_scatter_max", "deequ_tpu_torch/csrc/scatter_max.cu",
        "deequ_tpu/sketches/pallas_scatter.py:108", max_err=max_err,
        **timed(*cases["presence C=1 B=16 (main path)"]),
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

    # neither K1 entry reads the device back: one fused call and one
    # presence-path call (C=1, B=16, a 16-entry dictionary) under the
    # sync debug mode, which raises on a synchronising call
    codes = torch.randint(-1, 10, (1, 16), generator=gen, device=dev, dtype=torch.int32)
    luts = torch.randint(0, 1 << 32, (2, 1, 16), generator=gen, device=dev)
    zero1 = torch.zeros((4, M), dtype=torch.int8, device=dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        sm.hll_update(main_values, main_mask, cases["int64 C=4 B=2^21 with a row mask"][2], zero1)
        hll.registers_from_codes(codes, codes >= 0, luts[0], luts[1])
    except RuntimeError as exc:
        raise SmokeFailure(f"a K1 entry synchronised with the host: {exc}") from exc
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    log("hll_update and the presence path ran under set_sync_debug_mode('error'): "
        "no host sync")

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
    except RuntimeError as exc:
        raise SmokeFailure(f"a probe launch synchronised with the host: {exc}") from exc
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    log("P1 and P2 ran under set_sync_debug_mode('error'): no host sync")

    launch_host_split(torch, pk, zero, warm, packed)

    for name, regs_name, fn in (
        ("probe_two_stream_kernel", "zeroed", lambda: pk._launch_two_stream(zero, idx, rho, True)),
        ("probe_two_stream_kernel", "warm", lambda: pk._launch_two_stream(warm, idx, rho, True)),
        ("probe_packed_kernel", "zeroed", lambda: pk._launch_packed(zero, packed, True, True)),
        ("probe_packed_kernel", "warm", lambda: pk._launch_packed(warm, packed, True, True)),
        ("probe_gmin_kernel", "warm", lambda: pk._launch_gmin(warm, packed, True)),
    ):
        log(f"{name} device time alone into {regs_name} registers: "
            f"{device_ms(torch, fn, name):.4f} ms")
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
    gmin = (zero.data_ptr(), packed.data_ptr(), out.data_ptr(), rows, m, 1, p.blocks,
            512, stream)
    steps = {
        "the ctypes call (argument conversion, cudaLaunchKernelEx)":
            lambda: pk._library().probe_packed_launch(*args),
        "the same call refused before the launch (conversion and call alone)":
            lambda: pk._library().probe_packed_launch(*refused),
        "P3's ctypes call for comparison (9 arguments, a <<<>>> launch)":
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


def profile_rerun(torch, rerun, label, tables=True):
    """Device time by kernel, and the device's idle share, over one more
    run on resident columns."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rerun()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    log(f"profile ({label}): rerun wall {wall_ms:.3f} ms, kernels {busy_ms:.3f} ms, "
        f"device idle share {1 - busy_ms / wall_ms:.3f}")
    if not tables:
        return
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
    check(hash_ms < 1.0, f"the hash's elementwise ops still take {hash_ms:.3f} ms")


def main_phase(torch, np, rows: int, seed: int):
    import deequ_tpu_torch as T
    from deequ_tpu_torch.analyzers import ApproxCountDistinct
    from deequ_tpu_torch.data.table import ColumnRequest
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
    hll_where = ("ss_item_sk", "ss_customer_sk")

    states = {}

    class Keep:
        def persist(self, analyzer, state):
            states[analyzer] = state

    engine = T.AnalysisEngine()
    check(engine.device.type == "cuda", f"default engine device is {engine.device}")
    batch = engine._resolve_batch_size(rows)
    nb = -(-rows // batch)
    sm.launches = 0
    sm.fused_launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = (
        T.VerificationSuite().on_data(dataset).add_checks([checks, filters])
        .with_engine(engine).save_states_with(Keep()).run()
    )
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    launches = {"hll_scatter_max": sm.launches, "hll_update": sm.fused_launches}
    phases = dict(engine.phase_times or {})

    failed = [
        f"{cr.constraint}: {cr.message}"
        for check_ in (checks, filters)
        for cr in result.check_results[check_].constraint_results
        if cr.status.value != "Success"
    ]
    for line in failed:
        log(f"  FAILED {line}")
    # the four int64 keys stack into one HLL group and the two filtered
    # int64 keys into another, each a fused update a batch; i_category is
    # a single on the presence path, an (idx, rho) launch a batch
    expected = {"hll_scatter_max": nb, "hll_update": 2 * nb}
    check(launches == expected, f"K1 launches {launches}, expected {expected}")
    check(engine.data_passes == 1, f"data_passes == {engine.data_passes}")
    check(engine.device_fetches == 1, f"device_fetches == {engine.device_fetches}")
    check(result.status.value == "Success", f"status {result.status}: {failed}")

    # HLL registers against the plain version over whole columns
    def plain_registers(col, keep=None):
        kind = dataset.schema.kind_of(col).value
        if kind == "String":
            codes = dataset.device_column(ColumnRequest(col, "codes"), engine.device)
            lut1, lut2 = (torch.from_numpy(h.astype(np.int64)).to(engine.device)
                          for h in hll.dictionary_hash_pairs(dataset.dictionary(col)))
        else:
            values = dataset.device_column(ColumnRequest(col, "values"), engine.device)
        mask = dataset.device_column(ColumnRequest(col, "mask"), engine.device)
        if keep is not None:
            mask = mask & torch.from_numpy(keep).to(engine.device)
        regs = torch.zeros(hll.M, dtype=torch.int32, device=engine.device)
        step = 1 << 24
        for s in range(0, rows, step):
            m = mask[s:s + step]
            if kind == "String":
                c = codes[s:s + step].long().clamp(min=0)
                h1, h2 = lut1[c], lut2[c]
            else:
                h1, h2 = hll.hash_pair_numeric(values[s:s + step])
            idx, rho = hll.index_and_rank(h1, h2, m)
            regs = torch.maximum(regs, sm.scatter_max_plain(idx[None], rho[None], hll.M)[0])
        return regs.to(torch.int8).cpu()

    for c in keys + ["i_category"]:
        got = states[ApproxCountDistinct(c)].registers
        check(torch.equal(got, plain_registers(c)),
              f"HLL registers of {c} differ from the plain whole-column build")
    q = cols["ss_quantity"]
    over_50 = ~np.ma.getmaskarray(q) & (np.asarray(q.data) > 50)
    for c in hll_where:
        got = states[ApproxCountDistinct(c, where="ss_quantity > 50")].registers
        check(torch.equal(got, plain_registers(c, over_50)),
              f"filtered HLL registers of {c} differ from the plain build")
    log("main: HLL registers equal the plain whole-column build for "
        f"{len(keys) + 1} columns and {len(hll_where)} filtered columns")

    # reruns over the now-resident columns time the scan alone: the base
    # suite, and the suite with the filter and predicate constraints
    def rerun(check_list):
        def run():
            T.VerificationSuite().on_data(dataset).add_checks(check_list).with_engine(
                engine).run()
            torch.cuda.synchronize()
        return run

    base_rerun, full_rerun = rerun([checks]), rerun([checks, filters])
    t0 = time.perf_counter()
    base_rerun()
    t_base = time.perf_counter() - t0
    t0 = time.perf_counter()
    full_rerun()
    t_rerun = time.perf_counter() - t0

    log(f"main: generate {t_gen:.3f} s, Dataset {t_ds:.3f} s, run {t_run:.3f} s "
        f"(upload {phases.get('resident_s', float('nan')):.3f} s, scan "
        f"{phases.get('scan_s', float('nan')):.3f} s), rerun on resident "
        f"columns {t_rerun:.3f} s")
    log(f"main: {rows / t_run:.0f} rows/s end to end (first run, upload "
        f"included), {rows / t_rerun:.0f} rows/s on resident columns "
        f"({rows / t_base:.0f} rows/s without the filter and predicate "
        f"constraints, {t_base:.3f} s); {nb} batches of {batch} rows, "
        f"K1 launches {launches}, "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    profile_rerun(torch, base_rerun, "without filters and predicates", tables=False)
    profile_rerun(torch, full_rerun, "whole suite")
    return launches


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
    at full width; returns the P1-P3 launches of this run."""
    from deequ_tpu_torch.tools import probe_kernels as pk
    from deequ_tpu_torch.tools import scatter_probe

    for kernel in pk.launches:
        pk.launches[kernel] = 0
    records = [scatter_probe.run(["--b", "21"]),
               scatter_probe.run(["--prod", "--cols", "40", "--b", "21"])]
    launches = dict(pk.launches)
    for record in records:
        wrong = [n for n, v in record["variants"].items() if not v["bit_identical"]]
        check(not wrong, f"probe {record['mode']}: {wrong} differ from the library scatter")
    for kernel, n in launches.items():
        check(n > 0, f"the probe launched {kernel} no time")
    log(f"probe: every variant bit-identical in both modes; launches {launches}")
    return launches


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
        k1 = [kernel_phase(torch), fused_kernel_phase(torch)]
        probes = probe_kernel_phase(torch)
        log("== phase 4: main path")
        launches = main_phase(torch, np, args.rows, args.seed)
        for record in k1:
            record["launches"] = launches[record["name"]]
        log("== phase 5: scatter probe")
        launches = probe_phase()
        for record, kernel in zip(probes, ("P1", "P2", "P3")):
            record["launches"] = launches[kernel]
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
