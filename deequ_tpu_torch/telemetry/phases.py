"""PhaseClock: wall-time decomposition buckets for the scan paths.

Counterpart of ``deequ_tpu/telemetry/phases.py``, with its buckets, so
the ``scan_phases`` events of both packages read alike. In the port's
scan (``engine/scan.py``): ``host_wait_s`` — blocked pulling the next
batch (a resident slice, or a streamed batch from the prefetch thread or
the ingest pool); ``put_s`` — a streamed batch's copy to the device;
``dispatch_s`` — a batch's update dispatched (the FIRST batch's is split
out as ``first_step_s``: it carries the kernels' first-use costs);
``sync_s`` — blocked on the device in a fetch (drains, the final fetch).

The SUM is at most the pass's wall; the buckets are host clocks around
asynchronous work, so each alone is indicative.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Iterator


class PhaseClock:
    def __init__(self, mode: str):
        self.times: Dict[str, object] = {
            "host_wait_s": 0.0, "put_s": 0.0, "dispatch_s": 0.0,
            "first_step_s": 0.0, "sync_s": 0.0, "mode": mode,
        }
        self._steps = 0

    def timed_iter(self, iterator) -> Iterator:
        """Yield from ``iterator``, accumulating time blocked in its
        ``__next__`` into host_wait_s (keeps the caller a for-loop)."""
        it = iter(iterator)
        while True:
            t0 = time.perf_counter()
            try:
                item = next(it)
            except StopIteration:
                return
            self.times["host_wait_s"] += time.perf_counter() - t0
            yield item

    @contextlib.contextmanager
    def phase(self, key: str) -> Iterator[None]:
        if key == "dispatch_s":
            self._steps += 1
            if self._steps == 1:
                key = "first_step_s"
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.times[key] += time.perf_counter() - t0
