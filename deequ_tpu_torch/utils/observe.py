"""Per-pass wall-time metadata of a run (``ctx.run_metadata``).

Counterpart of ``deequ_tpu/utils/observe.py``: :class:`RunMetadata` and
:class:`PassTiming` are the result-facing shape of a run's timings,
built from the run's telemetry summary
(:meth:`RunMetadata.from_telemetry_summary`); with telemetry off the
runner records each pass itself, its wall time ending after the pass's
synchronising fetch. :func:`timed_pass` and :func:`profiler_trace` are
the JAX package's shims over the telemetry layer.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Iterator, List, Optional


@dataclass
class PassTiming:
    name: str  # "scan" | "grouping" | "direct" | custom
    wall_s: float
    rows: int
    num_analyzers: int

    @property
    def rows_per_sec(self) -> float:
        return self.rows / self.wall_s if self.wall_s > 0 else 0.0


@dataclass
class RunMetadata:
    """Timings for one AnalysisRunner run, plus notable engine events
    (the grouping planner's path of each plan, say)."""

    passes: List[PassTiming] = field(default_factory=list)
    events: List[dict] = field(default_factory=list)

    @property
    def total_wall_s(self) -> float:
        return sum(p.wall_s for p in self.passes)

    def record(self, name: str, wall_s: float, rows: int, num_analyzers: int) -> None:
        self.passes.append(PassTiming(name, wall_s, rows, num_analyzers))

    def merge(self, other: Optional["RunMetadata"]) -> "RunMetadata":
        """Always a fresh instance: no passes list is shared between
        contexts."""
        if other is None:
            return RunMetadata(list(self.passes), list(self.events))
        return RunMetadata(self.passes + other.passes, self.events + other.events)

    @staticmethod
    def merge_optional(
        a: Optional["RunMetadata"], b: Optional["RunMetadata"]
    ) -> Optional["RunMetadata"]:
        if a is None and b is None:
            return None
        if a is None:
            return b.merge(None)
        return a.merge(b)

    @staticmethod
    def from_telemetry_summary(summary: Optional[dict]) -> Optional["RunMetadata"]:
        """The pass and event shape rebuilt from a telemetry run summary
        (``telemetry/runtime.py::RunCapture``)."""
        if summary is None:
            return None
        metadata = RunMetadata()
        for p in summary.get("passes", []):
            metadata.record(p["pass"], p["wall_s"], p["rows"], p["num_analyzers"])
        metadata.events.extend(summary.get("events", []))
        return metadata

    def as_records(self) -> List[dict]:
        return [
            {
                "pass": p.name,
                "wall_s": round(p.wall_s, 6),
                "rows": p.rows,
                "num_analyzers": p.num_analyzers,
                "rows_per_sec": round(p.rows_per_sec, 1),
            }
            for p in self.passes
        ]


@contextlib.contextmanager
def timed_pass(
    metadata: Optional[RunMetadata], name: str, rows: int, num_analyzers: int
) -> Iterator[None]:
    """Time a pass through the telemetry layer (a ``pass:<name>`` span,
    its annotation and listener callbacks) and record it into
    ``metadata``. Prefer ``get_telemetry().pass_span(...)``."""
    if metadata is None:
        yield
        return
    from deequ_tpu_torch.telemetry import get_telemetry

    with get_telemetry().pass_span(name, rows, num_analyzers) as span:
        yield
    metadata.record(name, span.wall_s, rows, num_analyzers)


@contextlib.contextmanager
def profiler_trace(log_dir: str) -> Iterator[None]:
    """Shim for :func:`deequ_tpu_torch.telemetry.profiler_trace`."""
    from deequ_tpu_torch.telemetry import profiler_trace as _trace

    with _trace(log_dir) as prof:
        yield prof
