"""Per-pass wall-time metadata of a run (``ctx.run_metadata``).

Counterpart of ``deequ_tpu/utils/observe.py``: :class:`RunMetadata` and
:class:`PassTiming` are the result-facing shape of a run's timings. The
JAX package builds them from its telemetry summaries; this package has
no telemetry layer yet, so the runner records each pass itself
(``analyzers/runner.py``), its wall time ending after the pass's
synchronising fetch.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional


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
