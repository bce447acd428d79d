"""Operational records: the system's own run metrics, persisted through
the SAME MetricsRepository as data-quality metrics.

The VLDB'18 deequ paper frames the system around metric time series;
here the monitor monitors itself: each repository-persisted run also
stores a small set of ``Entity.DATASET``-scoped DoubleMetrics (wall,
rows/sec, bytes shipped, cache hit counts, spill counts) under the same
``ResultKey`` — so the existing ``anomalydetection/`` strategies can
alert when e.g. rows/sec or bytes/row regresses across runs, with zero
new query machinery (``repository.load().for_analyzers([
OperationalAnalyzer("rows_per_sec")])`` is a plain metric series).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

from deequ_tpu_torch.analyzers.base import (
    Analyzer,
    MetricCalculationException,
)
from deequ_tpu_torch.metrics.metric import DoubleMetric, Entity, Metric
from deequ_tpu_torch.utils.trylike import Success

# the catalog of per-run operational metrics (the JAX package's; the
# port's runs record 0 plan cache hits and misses and 0 traces)
OPERATIONAL_METRICS = (
    "wall_s",            # whole-run wall (run capture root)
    "pass_wall_s",       # sum of per-pass walls
    "rows",              # rows scanned (max over passes)
    "rows_per_sec",      # rows / wall_s
    "transfer_bytes",    # host->device bytes shipped during the run
    "bytes_per_row",     # transfer_bytes / rows
    "plan_cache_hits",
    "plan_cache_misses",
    "traces",            # fused-update retraces
    "spill_events",      # grouping spill/fallback decisions
)


@dataclass(frozen=True)
class OperationalAnalyzer(Analyzer):
    """Pseudo-analyzer keying one operational metric in the repository.

    Never runs against data — it exists so operational records ride the
    ordinary AnalysisResult serde/query path (repository/serde.py
    registers it) and anomaly strategies can load their series."""

    metric: str

    @property
    def name(self) -> str:
        return "Operational"

    @property
    def entity(self) -> Entity:
        return Entity.DATASET

    @property
    def instance(self) -> str:
        return self.metric

    def compute_metric_from_state(self, state: Optional[Any]) -> Metric:
        raise MetricCalculationException(
            "OperationalAnalyzer is repository-only; its values come "
            "from telemetry run summaries, never from data"
        )


def operational_values(summary: Optional[Dict[str, Any]]) -> Dict[str, float]:
    """Flatten a telemetry run summary into the operational metric
    values worth trending across runs."""
    if not summary:
        return {}
    passes = summary.get("passes", [])
    counters = summary.get("counters", {})
    wall = float(summary.get("wall_s", 0.0))
    rows = max((int(p.get("rows", 0)) for p in passes), default=0)
    values: Dict[str, float] = {
        "wall_s": wall,
        "pass_wall_s": float(sum(p.get("wall_s", 0.0) for p in passes)),
        "rows": float(rows),
        "transfer_bytes": float(counters.get("transfer.bytes", 0)),
        "plan_cache_hits": float(counters.get("engine.plan_cache.hits", 0)),
        "plan_cache_misses": float(
            counters.get("engine.plan_cache.misses", 0)
        ),
        "traces": float(counters.get("engine.traces", 0)),
        "spill_events": float(
            sum(
                v
                for k, v in counters.items()
                if k.startswith("grouping.spill.")
            )
        ),
    }
    if rows and wall > 0:
        values["rows_per_sec"] = rows / wall
        values["bytes_per_row"] = values["transfer_bytes"] / rows
    return values


def operational_metrics(
    summary: Optional[Dict[str, Any]],
) -> Dict[Analyzer, Metric]:
    """Build the {OperationalAnalyzer -> DoubleMetric} map persisted
    alongside a run's data-quality metrics (empty when telemetry was
    disabled for the run)."""
    return {
        OperationalAnalyzer(name): DoubleMetric(
            Entity.DATASET, "Operational", name, Success(float(value))
        )
        for name, value in operational_values(summary).items()
    }


def slo_metrics(
    snapshot: Optional[Dict[str, Any]],
) -> Dict[Analyzer, Metric]:
    """Flatten an ``SloTracker.snapshot()`` into repository-persistable
    operational records: per class ``slo.class.<name>.attained`` and
    ``.budget_burn`` (per tenant under ``slo.tenant.<name>.*``) — so
    the anomaly strategies can alert on p99 drift from the SAME metric
    series machinery as everything else."""
    if not snapshot:
        return {}
    out: Dict[Analyzer, Metric] = {}
    for scope, key in (("class", "classes"), ("tenant", "tenants")):
        for name, stats in (snapshot.get(key) or {}).items():
            for field in ("attained", "budget_burn"):
                value = stats.get(field)
                if value is None or value != value or value in (
                    float("inf"), float("-inf")
                ):
                    continue
                instance = f"slo.{scope}.{name}.{field}"
                out[OperationalAnalyzer(instance)] = DoubleMetric(
                    Entity.DATASET, "Operational", instance,
                    Success(float(value)),
                )
    return out
