"""Metrics registry: counters, gauges, and latency histograms.

Counterpart of ``deequ_tpu/telemetry/metrics.py``. The registry is the
one place operational counts live. Counters are always on: a bump is
one locked integer add per pass- or batch-granularity event; only
spans, export and listeners are gated by the telemetry ``enabled`` flag
(see runtime.py).

The names the port's engine uses are the JAX package's:

- ``transfer.bytes``            host->device bytes copied (data layer)
- ``engine.scans`` / ``engine.data_passes``
- ``engine.device_fetches`` / ``engine.fetch_bytes``  synchronising fetches
- ``engine.vectorize.units`` / ``engine.vectorize.stacked_members``
- ``grouping.spill.<path>``     spill/fallback decisions per path
- ``runner.runs`` / ``runner.analyzer_failures``
- ``repository.saves`` / ``repository.loads``
- ``checks.evaluated``

The JAX package's ``engine.traces`` and ``engine.plan_cache.*`` count
machinery the port does not have (it compiles nothing per plan); the
port never bumps them.
"""

from __future__ import annotations

import bisect
import math
import re
import threading
from typing import Dict, Optional, Sequence, Tuple

# latency buckets (seconds) — wide enough for both a 2ms dispatch and a
# 10-minute streamed pass
DEFAULT_LATENCY_BUCKETS: Tuple[float, ...] = (
    0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0, 60.0, 600.0,
)


class Counter:
    """Monotonic counter. ``inc`` is safe from any thread."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += int(n)

    @property
    def value(self) -> int:
        return self._value


class Gauge:
    """Last-write-wins scalar (e.g. the batch size a run resolved)."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    @property
    def value(self) -> float:
        return self._value


class Histogram:
    """Fixed-bucket latency histogram (cumulative, Prometheus-style)."""

    __slots__ = ("name", "buckets", "_counts", "_count", "_sum",
                 "_min", "_max", "_lock")

    def __init__(
        self, name: str, buckets: Optional[Sequence[float]] = None
    ):
        self.name = name
        self.buckets = tuple(sorted(buckets or DEFAULT_LATENCY_BUCKETS))
        self._counts = [0] * (len(self.buckets) + 1)  # +inf tail
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        value = float(value)
        idx = bisect.bisect_left(self.buckets, value)
        with self._lock:
            self._counts[idx] += 1
            self._count += 1
            self._sum += value
            self._min = min(self._min, value)
            self._max = max(self._max, value)

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            cumulative = {}
            running = 0
            for bound, n in zip(self.buckets, self._counts):
                running += n
                cumulative[bound] = running
            return {
                "count": self._count,
                "sum": self._sum,
                "min": self._min if self._count else None,
                "max": self._max if self._count else None,
                "buckets": cumulative,
            }


def _prom_name(name: str) -> str:
    return "deequ_tpu_" + re.sub(r"[^a-zA-Z0-9_]", "_", name)


class MetricsRegistry:
    """Named instrument registry; get-or-create is thread-safe and the
    returned instruments are stable, so hot paths can cache them."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        with self._lock:
            inst = self._counters.get(name)
            if inst is None:
                inst = self._counters[name] = Counter(name)
            return inst

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            inst = self._gauges.get(name)
            if inst is None:
                inst = self._gauges[name] = Gauge(name)
            return inst

    def histogram(
        self, name: str, buckets: Optional[Sequence[float]] = None
    ) -> Histogram:
        with self._lock:
            inst = self._histograms.get(name)
            if inst is None:
                inst = self._histograms[name] = Histogram(name, buckets)
            return inst

    # -- export ---------------------------------------------------------

    def counters_snapshot(self) -> Dict[str, int]:
        with self._lock:
            return {k: c.value for k, c in sorted(self._counters.items())}

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            counters = {k: c.value for k, c in sorted(self._counters.items())}
            gauges = {k: g.value for k, g in sorted(self._gauges.items())}
            histograms = {
                k: h.snapshot() for k, h in sorted(self._histograms.items())
            }
        return {
            "counters": counters,
            "gauges": gauges,
            "histograms": histograms,
        }

    def to_prometheus(self) -> str:
        """Prometheus text exposition (0.0.4) of every instrument."""
        snap = self.snapshot()
        lines = []
        for name, value in snap["counters"].items():
            pname = _prom_name(name)
            lines.append(f"# TYPE {pname} counter")
            lines.append(f"{pname} {value}")
        for name, value in snap["gauges"].items():
            pname = _prom_name(name)
            lines.append(f"# TYPE {pname} gauge")
            lines.append(f"{pname} {value}")
        for name, h in snap["histograms"].items():
            pname = _prom_name(name)
            lines.append(f"# TYPE {pname} histogram")
            for bound, n in h["buckets"].items():
                lines.append(f'{pname}_bucket{{le="{bound}"}} {n}')
            lines.append(f'{pname}_bucket{{le="+Inf"}} {h["count"]}')
            lines.append(f"{pname}_sum {h['sum']}")
            lines.append(f"{pname}_count {h['count']}")
        return "\n".join(lines) + "\n"

    def reset(self) -> None:
        """Drop every instrument (tests only — counters are meant to be
        process-monotonic so deltas can be snapshotted around runs)."""
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()
