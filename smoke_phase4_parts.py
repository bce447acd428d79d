"""Phase 4 of a checkout's ``chip_smoke.py`` alone, with its seconds by
part: each named function of the smoke that ``main_phase`` calls is timed
exclusive of the others it calls, and the rest of ``main_phase`` is one
more part. Run it from the root of the checkout whose smoke it times (an
older checkout's too), on a machine with a CUDA card:

    python3 smoke_phase4_parts.py [--batches 24]

It runs phases 1 and 2 (the device, the kernels' build) first and prints
one JSON line of parts last; it exits 1 when the phase fails."""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.getcwd())

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from deequ_tpu_torch import config  # noqa: E402

# the smoke's functions that main_phase calls, where they exist
PARTS = ["store_sales", "filter_checks", "sketch_checks", "grouping_checks", "plain_registers",
         "check_sketch_states", "check_grouping_plans", "telemetry_reruns", "k1_in_ranges",
         "profile_rerun", "f5_cost", "grouping_phase", "median_ms"]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--batches", type=int, default=24,
                        help="batches of 2^21 rows of phase 4's table")
    args = parser.parse_args(argv)
    spent, stack = {}, []

    def timed(name, fn):
        def wrapper(*a, **kw):
            t0 = time.perf_counter()
            stack.append(0.0)
            try:
                return fn(*a, **kw)
            finally:
                total = time.perf_counter() - t0
                spent[name] = spent.get(name, 0.0) + total - stack.pop()
                if stack:
                    stack[-1] += total
        return wrapper

    for name in PARTS:
        if hasattr(cs, name):
            setattr(cs, name, timed(name, getattr(cs, name)))
    try:
        cs.device_phase(torch)
        cs.build_phase()
        t0 = time.perf_counter()
        with config.configure(device_cache_bytes=cs.RESIDENT_BUDGET):
            cs.main_phase(torch, np, args.batches << 21, 0)
        wall = time.perf_counter() - t0
    except cs.SmokeFailure as exc:
        print(f"FAILED: {exc}", flush=True)
        return 1
    spent["main_phase (the rest)"] = wall - sum(spent.values())
    print("phase 4 parts: " + json.dumps({"root": os.getcwd(), "wall_s": wall,
                                          "parts_s": spent}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
