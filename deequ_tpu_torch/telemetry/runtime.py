"""Telemetry runtime: ONE object owning the tracer, the metrics
registry, the listener set, and structured export.

Layers and their gating:

- **counters/gauges/histograms** (metrics.py) — always on; a bump per
  pass or batch event is one locked integer add.
- **spans, engine events, run captures, listeners, JSONL** — gated by
  ``enabled`` (default on; ``DEEQU_TPU_TELEMETRY=0`` or
  ``configure(enabled=False)`` turns them into shared no-ops with no
  measurable cost to a scan).
- **JSONL event log** — off until a path is configured
  (``configure(jsonl_path=...)`` or ``DEEQU_TPU_TELEMETRY_JSONL``);
  every finished span, engine event, and run summary appends one line.

A *run capture* scopes spans/events/pass records to one logical run
(one ``AnalysisRunner.do_analysis_run``); its ``summary()`` is the dict
attached to ``AnalyzerContext``/``VerificationResult`` and is what the
repository persists as operational records (oprecords.py).
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
from collections import deque
from typing import Any, Dict, Iterator, List, Optional

from deequ_tpu_torch.telemetry.listeners import RunListener
from deequ_tpu_torch.telemetry.metrics import MetricsRegistry
from deequ_tpu_torch.telemetry.spans import (
    NOOP_SPAN,
    NOOP_SPAN_CM,
    Span,
    TraceContext,
    Tracer,
    clock,
    epoch,
    next_span_id,
)

_NOOP_SCOPE = contextlib.nullcontext(None)

_run_ids = itertools.count(1)
_UNSET = object()


class RunCapture:
    """Spans/events/pass records of one logical run, plus the counter
    snapshot taken at run start so the summary reports DELTAS."""

    def __init__(self, run_id: int, name: str, counters_before: Dict[str, int]):
        self.run_id = run_id
        self.name = name
        self.counters_before = counters_before
        self.spans: List[Dict[str, Any]] = []
        self.events: List[Dict[str, Any]] = []
        self.passes: List[Dict[str, Any]] = []
        self.wall_s = 0.0
        # the summary computed when the run context exits (None while
        # the run is still open) — what callers attach to results
        self.final: Optional[Dict[str, Any]] = None

    def summary(self, counters_now: Dict[str, int]) -> Dict[str, Any]:
        before = self.counters_before
        counters = {
            k: v - before.get(k, 0)
            for k, v in counters_now.items()
            if v - before.get(k, 0) != 0
        }
        return {
            "run_id": self.run_id,
            "name": self.name,
            "wall_s": self.wall_s,
            "passes": list(self.passes),
            "events": list(self.events),
            "spans": list(self.spans),
            "counters": counters,
        }


class _NoopCapture:
    """Stand-in when telemetry is disabled: absorbs nothing, summarizes
    to None (callers then skip metadata/summary attachment)."""

    run_id = 0
    name = ""
    spans: List = []
    events: List = []
    passes: List = []
    wall_s = 0.0
    final = None

    def summary(self, counters_now=None):  # noqa: ARG002
        return None


NOOP_CAPTURE = _NoopCapture()


class Telemetry:
    """The unified telemetry runtime. A process-default instance is
    reachable via :func:`get_telemetry`; tests may instantiate their own
    for isolation."""

    def __init__(
        self,
        enabled: Optional[bool] = None,
        jsonl_path: Optional[str] = None,
        annotate: bool = True,
    ):
        if enabled is None:
            enabled = os.environ.get(
                "DEEQU_TPU_TELEMETRY", "1"
            ).lower() not in ("0", "false", "off")
        if jsonl_path is None:
            jsonl_path = os.environ.get("DEEQU_TPU_TELEMETRY_JSONL") or None
        self.enabled = bool(enabled)
        self.metrics = MetricsRegistry()
        self.tracer = Tracer(annotate=annotate)
        # fleet-timeline tag for every span record this process emits
        # (set per-host in the distributed service, per-child in spawn
        # children); empty = untagged
        self.process_label = os.environ.get(
            "DEEQU_TPU_TELEMETRY_PROCESS", ""
        )
        # best-effort callbacks fed every finished span RECORD (the
        # spawn boundary streams child spans to the parent through one)
        self._span_sinks: List[Any] = []
        self._listeners: List[RunListener] = []
        self._local = threading.local()
        self._jsonl_path = jsonl_path
        self._jsonl_lock = threading.Lock()
        # global ring of recent span records/events (debugging aid when
        # no capture is active); bounded so long processes never grow
        self._recent: deque = deque(maxlen=4096)
        self._recent_lock = threading.Lock()

    # -- configuration --------------------------------------------------

    def configure(
        self,
        enabled: Optional[bool] = None,
        jsonl_path: Any = _UNSET,
        annotate: Optional[bool] = None,
        process: Optional[str] = None,
    ) -> "Telemetry":
        if enabled is not None:
            self.enabled = bool(enabled)
        if jsonl_path is not _UNSET:
            self._jsonl_path = jsonl_path
        if annotate is not None:
            self.tracer.annotate = bool(annotate)
        if process is not None:
            self.process_label = process
        return self

    @property
    def jsonl_path(self) -> Optional[str]:
        return self._jsonl_path

    # -- listeners ------------------------------------------------------

    def add_listener(self, listener: RunListener) -> RunListener:
        self._listeners.append(listener)
        return listener

    def remove_listener(self, listener: RunListener) -> None:
        try:
            self._listeners.remove(listener)
        except ValueError:
            pass

    @property
    def listeners(self) -> List[RunListener]:
        return list(self._listeners)

    def _dispatch(self, method: str, *args: Any) -> None:
        for listener in self._listeners:
            try:
                getattr(listener, method)(*args)
            except Exception:  # noqa: BLE001 — a broken listener must
                # never fail a run; the counter keeps it from being
                # silent
                self.metrics.counter("telemetry.listener_errors").inc()

    # -- counters passthrough ------------------------------------------

    def counter(self, name: str):
        return self.metrics.counter(name)

    # -- captures -------------------------------------------------------

    def _captures(self) -> List[RunCapture]:
        stack = getattr(self._local, "captures", None)
        if stack is None:
            stack = []
            self._local.captures = stack
        return stack

    @contextlib.contextmanager
    def run(self, name: str = "run") -> Iterator[RunCapture]:
        """Open a run capture: spans/events/pass records finished on
        this thread while the context is live are scoped to it."""
        if not self.enabled:
            yield NOOP_CAPTURE
            return
        cap = RunCapture(
            next(_run_ids), name, self.metrics.counters_snapshot()
        )
        self._dispatch("on_run_start", cap.run_id, name)
        stack = self._captures()
        stack.append(cap)
        t0 = clock()
        try:
            with self.tracer.span(
                f"run:{name}", on_finish=self._on_span_finish, run=name
            ):
                yield cap
        finally:
            cap.wall_s = clock() - t0
            if cap in stack:
                stack.remove(cap)
            summary = cap.summary(self.metrics.counters_snapshot())
            cap.final = summary
            self._write_jsonl(
                {"type": "run_summary", **_summary_sans_spans(summary)}
            )
            self._dispatch("on_run_end", cap.run_id, name, summary)

    # -- spans ----------------------------------------------------------

    def span(self, name: str, **attributes: Any):
        """A nested span (see spans.Tracer); shared no-op when
        disabled."""
        if not self.enabled:
            return NOOP_SPAN_CM
        return self.tracer.span(
            name, on_finish=self._on_span_finish, **attributes
        )

    def _on_span_finish(self, sp: Span) -> None:
        self._ingest_record(sp.as_record())

    def _ingest_record(self, record: Dict[str, Any]) -> None:
        """Route one finished span RECORD to captures, the recent ring,
        span sinks, and the JSONL log — live and replayed spans share
        this path."""
        if self.process_label and not record.get("process"):
            record["process"] = self.process_label
        captures = self._captures()
        if captures:
            record["run_id"] = captures[-1].run_id
            for cap in captures:
                cap.spans.append(record)
        with self._recent_lock:
            self._recent.append(record)
        for sink in self._span_sinks:
            try:
                sink(record)
            except Exception:  # noqa: BLE001 — a broken sink must never
                # fail a run (same contract as listeners)
                self.metrics.counter("telemetry.listener_errors").inc()
        self._write_jsonl(record)

    # -- trace propagation ----------------------------------------------

    def trace_scope(self, ctx: Optional[TraceContext]):
        """Make ``ctx`` the ambient trace on this thread (no-op when
        telemetry is disabled or ``ctx`` is None — the zero-cost-off
        path allocates nothing)."""
        if not self.enabled or ctx is None:
            return _NOOP_SCOPE
        return self.tracer.trace_scope(ctx)

    def current_trace(self) -> Optional[TraceContext]:
        if not self.enabled:
            return None
        return self.tracer.current_trace()

    def add_span_sink(self, sink: Any) -> Any:
        self._span_sinks.append(sink)
        return sink

    def remove_span_sink(self, sink: Any) -> None:
        try:
            self._span_sinks.remove(sink)
        except ValueError:
            pass

    def emit_span(
        self,
        name: str,
        wall_s: float = 0.0,
        *,
        trace: Optional[TraceContext] = None,
        span_id: Optional[int] = None,
        parent_id: Optional[int] = None,
        started_at: Optional[float] = None,
        **attributes: Any,
    ) -> Optional[Dict[str, Any]]:
        """Record a span that was MEASURED rather than lived-through: a
        queue wait read off ticket timestamps, a lease wait, a phase
        bucket. Parent resolution: explicit ``parent_id`` > current
        open span on this thread > ambient trace root > None. Pass
        ``span_id=trace.span_id`` (with ``parent_id=None``) to emit the
        trace's reserved root."""
        if not self.enabled:
            return None
        ctx = trace if trace is not None else self.tracer.current_trace()
        sid = span_id if span_id is not None else next_span_id()
        if parent_id is None and span_id is None:
            current = self.tracer.current()
            if current is not None:
                parent_id = current.span_id
            elif ctx is not None:
                parent_id = ctx.span_id
        sp = Span(
            name=name,
            span_id=sid,
            parent_id=parent_id,
            thread=threading.current_thread().name,
            started_at=(
                started_at if started_at is not None
                else epoch() - max(0.0, wall_s)
            ),
            wall_s=max(0.0, float(wall_s)),
            attributes=dict(attributes),
            trace_id=ctx.trace_id if ctx is not None else None,
            process=ctx.process if ctx is not None else "",
        )
        record = sp.as_record()
        self._ingest_record(record)
        return record

    def replay_spans(
        self,
        records: List[Dict[str, Any]],
        *,
        root_parent_id: Optional[int] = None,
        trace_id: Optional[str] = None,
        process: str = "",
    ) -> List[Dict[str, Any]]:
        """Re-ingest span records produced by ANOTHER process (a spawn
        child): span ids are remapped onto this process's counter so
        they cannot collide, internal parentage is preserved, and any
        record whose parent is unknown re-roots under
        ``root_parent_id``. Returns the re-ingested records."""
        if not self.enabled or not records:
            return []
        id_map = {
            r["span_id"]: next_span_id()
            for r in records
            if isinstance(r.get("span_id"), int)
        }
        out: List[Dict[str, Any]] = []
        for r in records:
            if not isinstance(r, dict) or r.get("type") != "span":
                continue
            rec = dict(r)
            rec["span_id"] = id_map.get(rec.get("span_id"), next_span_id())
            parent = rec.get("parent_id")
            # the anchor check comes FIRST: the child's local id counter
            # can collide with the shipped parent id, and a span that
            # parents to the anchor must stay on it, not follow the
            # colliding child id through the remap
            if parent == root_parent_id and parent is not None:
                pass  # already anchored on the shipped parent span
            elif parent in id_map:
                rec["parent_id"] = id_map[parent]
            else:
                rec["parent_id"] = root_parent_id
            if trace_id is not None:
                rec["trace_id"] = trace_id
            if process and not rec.get("process"):
                rec["process"] = process
            rec.pop("run_id", None)  # re-attributed by _ingest_record
            self._ingest_record(rec)
            out.append(rec)
        return out

    @contextlib.contextmanager
    def pass_span(
        self, name: str, rows: int = 0, num_analyzers: int = 0
    ) -> Iterator[Any]:
        """An engine pass: a span named ``pass:<name>`` plus the
        on_pass_start/end listener callbacks and a per-run pass record.
        Always measures wall (two clock calls per PASS — nothing per
        batch) so the RunMetadata compatibility shim keeps working even
        when span capture is off."""
        if not self.enabled:
            t0 = clock()
            sp = Span(name=f"pass:{name}", span_id=0, parent_id=None,
                      thread="", started_at=0.0)
            try:
                yield sp
            finally:
                sp.wall_s = clock() - t0
            return
        self._dispatch("on_pass_start", name, rows, num_analyzers)
        sp_out = None
        try:
            with self.tracer.span(
                f"pass:{name}",
                on_finish=self._on_span_finish,
                rows=rows,
                num_analyzers=num_analyzers,
            ) as sp:
                sp_out = sp
                yield sp
        finally:
            if sp_out is not None:
                record = {
                    "pass": name,
                    "wall_s": sp_out.wall_s,
                    "rows": rows,
                    "num_analyzers": num_analyzers,
                }
                for cap in self._captures():
                    cap.passes.append(record)
                self.metrics.histogram("pass.wall_s").observe(
                    sp_out.wall_s
                )
                self._dispatch(
                    "on_pass_end", name, sp_out.wall_s, rows, num_analyzers
                )

    # -- engine events --------------------------------------------------

    def event(self, name: str, **fields: Any) -> Dict[str, Any]:
        """A structured engine event ({"event": name, **fields}):
        captured per-run, JSONL-logged, and fanned out to
        ``on_engine_event`` listeners."""
        record = {"event": name, **fields}
        if not self.enabled:
            return record
        captures = self._captures()
        for cap in captures:
            cap.events.append(record)
        with self._recent_lock:
            self._recent.append({"type": "event", **record})
        self._write_jsonl(
            {
                "type": "event",
                "run_id": captures[-1].run_id if captures else None,
                **record,
            }
        )
        self._dispatch("on_engine_event", record)
        return record

    def analyzer_computed(self, analyzer: Any, metric: Any) -> None:
        """Fan an (analyzer, metric) result out to listeners."""
        if self.enabled:
            self._dispatch("on_analyzer_computed", analyzer, metric)

    def check_evaluated(self, check: Any, result: Any) -> None:
        """Fan an evaluated check out to listeners."""
        if self.enabled:
            self._dispatch("on_check_evaluated", check, result)

    def recent(self) -> List[Dict[str, Any]]:
        with self._recent_lock:
            return list(self._recent)

    # -- export ---------------------------------------------------------

    def _write_jsonl(self, record: Dict[str, Any]) -> None:
        path = self._jsonl_path
        if not path:
            return
        try:
            line = json.dumps(record, default=str)
        except TypeError:
            line = json.dumps({"type": "unserializable", "repr": repr(record)})
        with self._jsonl_lock:
            with open(path, "a", encoding="utf-8") as fh:
                fh.write(line + "\n")


def _summary_sans_spans(summary: Dict[str, Any]) -> Dict[str, Any]:
    out = dict(summary)
    out.pop("spans", None)
    return out


_default = Telemetry()
_default_lock = threading.Lock()


def get_telemetry() -> Telemetry:
    """The process-default Telemetry instance."""
    return _default


def configure(
    enabled: Optional[bool] = None,
    jsonl_path: Any = _UNSET,
    annotate: Optional[bool] = None,
    process: Optional[str] = None,
) -> Telemetry:
    """Configure the process-default instance (see
    ``Telemetry.configure``)."""
    with _default_lock:
        return _default.configure(
            enabled=enabled,
            jsonl_path=jsonl_path,
            annotate=annotate,
            process=process,
        )
