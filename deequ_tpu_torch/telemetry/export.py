"""Structured export helpers: summary serde, summary merging, JSONL
artifact reading, the live metrics endpoint, and SLO tracking.

The *summary* is the per-run dict produced by ``RunCapture.summary``
(runtime.py) and attached to ``AnalyzerContext``/``VerificationResult``
— plain JSON-serializable data by construction, so persistence is
``json.dumps``/``loads`` with a round-trip identity (tested in
tests/test_telemetry.py).

:func:`serve_metrics` is the live fleet plane: a stdlib-only HTTP
endpoint exposing the registry's Prometheus text at ``/metrics`` and a
caller-supplied JSON health snapshot at ``/healthz``. Nothing here
starts unless explicitly asked (zero-cost-when-off: no thread, no
socket). :class:`SloTracker` turns the ``service.queue_wait_s.<class>``
histograms into latency-objective attainment and error-budget burn.
"""

from __future__ import annotations

import bisect
import json
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence


def summary_to_json(summary: Dict[str, Any], indent: int = 2) -> str:
    return json.dumps(summary, indent=indent, default=str)


def summary_from_json(text: str) -> Dict[str, Any]:
    return json.loads(text)


def merge_summaries(
    summaries: Sequence[Optional[Dict[str, Any]]],
) -> Optional[Dict[str, Any]]:
    """Fold several per-run summaries (e.g. the profiler's passes over
    the same dataset) into one: walls add, pass/event/span lists
    concatenate in order, counter deltas add. ``None`` entries are
    skipped; all-None means no telemetry was captured."""
    present = [s for s in summaries if s]
    if not present:
        return None
    if len(present) == 1:
        return present[0]
    counters: Dict[str, float] = {}
    for s in present:
        for k, v in s.get("counters", {}).items():
            counters[k] = counters.get(k, 0) + v
    return {
        "run_id": present[0].get("run_id"),
        "run_ids": [s.get("run_id") for s in present],
        "name": present[0].get("name", "run"),
        "wall_s": sum(s.get("wall_s", 0.0) for s in present),
        "passes": [p for s in present for p in s.get("passes", [])],
        "events": [e for s in present for e in s.get("events", [])],
        "spans": [sp for s in present for sp in s.get("spans", [])],
        "counters": counters,
    }


def summarize_phases(events: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """Sum ``scan_phases`` events into one wall-decomposition dict (the
    shape bench.py and tools/obs_report.py report)."""
    out: Dict[str, Any] = {}
    for e in events:
        if e.get("event") != "scan_phases":
            continue
        for k, v in e.items():
            if isinstance(v, float):
                out[k] = out.get(k, 0.0) + v
        out["scan_passes"] = out.get("scan_passes", 0) + 1
    return {
        k: (round(v, 3) if isinstance(v, float) else v)
        for k, v in out.items()
    }


class MetricsServer:
    """Handle on a running :func:`serve_metrics` endpoint."""

    def __init__(self, httpd: Any, thread: threading.Thread):
        self._httpd = httpd
        self._thread = thread
        self.port: int = httpd.server_address[1]
        self.host: str = httpd.server_address[0]

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def close(self) -> None:
        try:
            self._httpd.shutdown()
            self._httpd.server_close()
        except Exception:  # noqa: BLE001 — idempotent close
            pass
        self._thread.join(timeout=5.0)


def serve_metrics(
    port: int,
    registry: Optional[Any] = None,
    health: Optional[Callable[[], Dict[str, Any]]] = None,
    host: str = "127.0.0.1",
) -> MetricsServer:
    """Start the live observability endpoint on a daemon thread
    (stdlib ``http.server`` only — no new dependencies):

    - ``GET /metrics`` — Prometheus 0.0.4 text from ``registry``
      (default: the process telemetry's registry)
    - ``GET /healthz`` — ``health()`` rendered as JSON (queue depths,
      slices active, breaker states, shed counts when wired by
      ``VerificationService``); ``{"status": "ok"}`` if no callback
    - ``GET /fleetz`` — the health payload's ``fleet`` section alone
      (lease epoch, peer ages, adoptions, fenced writes — docs/
      SERVICE.md "Fleet failover"); ``{"status": "no fleet"}`` when
      the replica is not a fleet member

    ``port=0`` binds an ephemeral port (read it off the returned
    handle). The caller owns shutdown via ``MetricsServer.close()``.
    """
    import http.server

    if registry is None:
        from deequ_tpu_torch.telemetry.runtime import get_telemetry

        registry = get_telemetry().metrics

    class _Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 — http.server API
            if self.path.split("?", 1)[0] == "/metrics":
                body = registry.to_prometheus().encode("utf-8")
                ctype = "text/plain; version=0.0.4; charset=utf-8"
            elif self.path.split("?", 1)[0] == "/healthz":
                try:
                    payload = health() if health is not None else {
                        "status": "ok"
                    }
                except Exception as exc:  # noqa: BLE001 — a broken
                    # health probe must report, not 500-and-hide
                    payload = {"status": "error", "error": str(exc)}
                body = json.dumps(payload, default=str).encode("utf-8")
                ctype = "application/json"
            elif self.path.split("?", 1)[0] == "/fleetz":
                try:
                    full = health() if health is not None else {}
                    payload = full.get("fleet") or {"status": "no fleet"}
                except Exception as exc:  # noqa: BLE001 — same
                    # report-don't-hide contract as /healthz
                    payload = {"status": "error", "error": str(exc)}
                body = json.dumps(payload, default=str).encode("utf-8")
                ctype = "application/json"
            else:
                self.send_error(404)
                return
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):  # silence per-request stderr spam
            pass

    httpd = http.server.ThreadingHTTPServer((host, int(port)), _Handler)
    httpd.daemon_threads = True
    thread = threading.Thread(  # lint-ok: thread-discipline: daemon endpoint thread owned by MetricsServer.close(), not scan teardown
        target=httpd.serve_forever,
        name="deequ-tpu-metrics",
        daemon=True,
    )
    thread.start()
    return MetricsServer(httpd, thread)


def parse_slo_objectives(spec: str) -> Dict[str, float]:
    """Parse the ``service_slo_objectives`` config string —
    ``"interactive=1.0,batch=30"`` — into ``{class: seconds}``.
    Malformed pairs are skipped (config must never crash a service)."""
    out: Dict[str, float] = {}
    for pair in (spec or "").split(","):
        pair = pair.strip()
        if not pair or "=" not in pair:
            continue
        key, _, value = pair.partition("=")
        try:
            out[key.strip()] = float(value)
        except ValueError:
            continue
    return out


class SloTracker:
    """Per-class (and optionally per-tenant) latency SLOs over the
    existing ``service.queue_wait_s.<class>`` histograms.

    For each objective the tracker reports *attainment* (the fraction
    of observed waits at or under the objective, resolved conservatively
    against the histogram's bucket bounds) and *error-budget burn*:
    ``(1 - attained) / (1 - target)`` — burn 1.0 means the budget is
    exactly spent, >1 means the objective is being violated faster than
    the target tolerates. Snapshots are plain dicts so they persist as
    oprecords (`telemetry/oprecords.py:slo_metrics`) and serve from
    ``/healthz``.
    """

    def __init__(
        self,
        objectives: Dict[str, float],
        target: float = 0.99,
        registry: Optional[Any] = None,
        prefix: str = "service.queue_wait_s",
    ):
        if registry is None:
            from deequ_tpu_torch.telemetry.runtime import get_telemetry

            registry = get_telemetry().metrics
        self.objectives = dict(objectives)
        self.target = float(target)
        self.registry = registry
        self.prefix = prefix

    def _attainment(self, hist_snap: Dict[str, Any],
                    objective_s: float) -> Dict[str, Any]:
        count = int(hist_snap.get("count", 0))
        buckets = hist_snap.get("buckets", {})
        bounds = sorted(buckets)
        # conservative: observations credited to the objective are the
        # cumulative count at the largest bucket bound <= objective
        idx = bisect.bisect_right(bounds, objective_s) - 1
        within = int(buckets[bounds[idx]]) if idx >= 0 else 0
        attained = (within / count) if count else 1.0
        budget = 1.0 - self.target
        burn = ((1.0 - attained) / budget) if budget > 0 else (
            0.0 if attained >= 1.0 else float("inf")
        )
        return {
            "objective_s": objective_s,
            "count": count,
            "within": within,
            "attained": round(attained, 6),
            "budget_burn": round(burn, 6),
        }

    def snapshot(self) -> Dict[str, Any]:
        """Per-class objectives read ``<prefix>.<class>``; a
        ``tenant:<name>`` objective reads ``<prefix>.tenant.<name>``
        (observed by the scheduler only while SLO tracking is on)."""
        histograms = self.registry.snapshot()["histograms"]
        classes: Dict[str, Any] = {}
        tenants: Dict[str, Any] = {}
        for key, objective_s in sorted(self.objectives.items()):
            if key.startswith("tenant:"):
                name = key.split(":", 1)[1]
                hist = histograms.get(f"{self.prefix}.tenant.{name}")
                bucket_map = tenants
                out_key = name
            else:
                hist = histograms.get(f"{self.prefix}.{key}")
                bucket_map = classes
                out_key = key
            if hist is None:
                hist = {"count": 0, "buckets": {}}
            bucket_map[out_key] = self._attainment(hist, objective_s)
        return {
            "target": self.target,
            "classes": classes,
            "tenants": tenants,
        }

    def tenant_objectives(self) -> Dict[str, float]:
        return {
            key.split(":", 1)[1]: obj
            for key, obj in self.objectives.items()
            if key.startswith("tenant:")
        }


def read_jsonl(path: str) -> List[Dict[str, Any]]:
    """Parse a telemetry JSONL artifact (skips unparseable lines — the
    log may be appended by several processes)."""
    records: List[Dict[str, Any]] = []
    with open(path, "r", encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                records.append(json.loads(line))
            except json.JSONDecodeError:
                continue
    return records
