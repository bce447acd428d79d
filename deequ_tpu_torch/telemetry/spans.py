"""Span tracer: nested, attribute-carrying spans with thread-local
context.

Counterpart of ``deequ_tpu/telemetry/spans.py``. Each finished span
carries (name, span_id, parent_id, thread, wall_s, attributes); nesting
is tracked per-thread, so concurrent runs (or the engine's prefetch and
ingest workers) can never corrupt each other's parentage. When
annotation is on, every span also opens a
``torch.profiler.record_function`` range under the SAME
``deequ_tpu:<name>`` label, and, once CUDA is initialised in the
process (the run's device is a card), an NVTX range of that name: a
profiler trace (``profiler_trace``) and the in-repo timings share
names, so a kernel-level investigation and a span report line up 1:1.
An annotation never decides which path runs, and never swallows an
error raised inside its span.

The clock helpers here are the one home of ``time.perf_counter`` for
the layers that report through telemetry.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator, Optional

_span_ids = itertools.count(1)


def next_span_id() -> int:
    """A fresh process-unique span id (synthetic spans, replay remaps)."""
    return next(_span_ids)


def clock() -> float:
    """Monotonic seconds: the timing source for callers outside the
    telemetry layer."""
    return time.perf_counter()


def epoch() -> float:
    """Epoch seconds — the sanctioned wall-clock source (span
    ``started_at`` ordering; service layers use injected clocks and
    never call this directly)."""
    return time.time()


@dataclass(frozen=True)
class TraceContext:
    """The identity a run's spans share across threads and processes.

    ``trace_id`` names the run; ``span_id`` is the id RESERVED for the
    run's synthetic root span (emitted at terminal), so spans started
    anywhere under this context parent to the root before the root
    itself exists. ``process`` tags spans for fleet-timeline merges of
    per-host JSONL artifacts."""

    trace_id: str
    span_id: int
    process: str = ""

    @classmethod
    def mint(cls, seed: str = "", process: str = "") -> "TraceContext":
        suffix = uuid.uuid4().hex[:8]
        trace_id = f"{seed}-{suffix}" if seed else suffix
        return cls(trace_id=trace_id, span_id=next(_span_ids),
                   process=process)

    def child(self, span_id: int) -> "TraceContext":
        """The same trace re-anchored under ``span_id`` (what crosses
        the spawn boundary: the child's roots parent here)."""
        return TraceContext(trace_id=self.trace_id, span_id=span_id,
                            process=self.process)

    def encode(self) -> str:
        return f"{self.trace_id}:{self.span_id}:{self.process}"

    @classmethod
    def decode(cls, text: str) -> Optional["TraceContext"]:
        parts = text.split(":", 2)
        if len(parts) < 2:
            return None
        try:
            span_id = int(parts[1])
        except ValueError:
            return None
        return cls(trace_id=parts[0], span_id=span_id,
                   process=parts[2] if len(parts) > 2 else "")


@dataclass
class Span:
    name: str
    span_id: int
    parent_id: Optional[int]
    thread: str
    started_at: float  # epoch seconds (export ordering across threads)
    wall_s: float = 0.0
    attributes: Dict[str, Any] = field(default_factory=dict)
    trace_id: Optional[str] = None
    process: str = ""

    def set(self, **attrs: Any) -> "Span":
        self.attributes.update(attrs)
        return self

    def as_record(self) -> Dict[str, Any]:
        record = {
            "type": "span",
            "name": self.name,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "thread": self.thread,
            "started_at": round(self.started_at, 6),
            "wall_s": round(self.wall_s, 6),
            "attributes": dict(self.attributes),
        }
        # trace identity only when a TraceContext was ambient — untraced
        # runs keep the classic record shape byte-for-byte
        if self.trace_id is not None:
            record["trace_id"] = self.trace_id
            if self.process:
                record["process"] = self.process
        return record


class _NoopSpan:
    """Shared do-nothing span for the disabled path."""

    __slots__ = ()
    wall_s = 0.0

    def set(self, **attrs: Any) -> "_NoopSpan":
        return self


NOOP_SPAN = _NoopSpan()
# reusable: nullcontext always returns its enter_result, so ONE instance
# serves every disabled span() call with zero allocation
NOOP_SPAN_CM = contextlib.nullcontext(NOOP_SPAN)


def _runs_on_cuda() -> bool:
    """Whether the configured engine device is CUDA (``config.device``;
    None means "cuda"), whatever the process has touched so far."""
    from deequ_tpu_torch import config

    return (config.options().device or "cuda").startswith("cuda")


class _Annotation:
    """``torch.profiler.record_function("deequ_tpu:<name>")``, plus an
    NVTX range of that name when the run's device is CUDA."""

    __slots__ = ("_label", "_record", "_nvtx")

    def __init__(self, label: str):
        self._label = label
        self._record = None
        self._nvtx = False

    def __enter__(self):
        import torch

        self._record = torch.profiler.record_function(self._label)
        self._record.__enter__()
        if _runs_on_cuda() and torch.backends.cuda.is_built():
            torch.cuda.nvtx.range_push(self._label)
            self._nvtx = True
        return self

    def __exit__(self, *exc):
        import torch

        if self._nvtx:
            torch.cuda.nvtx.range_pop()
        self._record.__exit__(*exc)
        return False  # an error inside the span propagates


def _trace_annotation(name: str) -> _Annotation:
    return _Annotation(f"deequ_tpu:{name}")


class Tracer:
    """Thread-safe span context. Each thread owns its span stack; the
    finished-span callback is invoked on the finishing thread."""

    def __init__(self, annotate: bool = True):
        self.annotate = annotate
        self._local = threading.local()

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = []
            self._local.stack = stack
        return stack

    def current(self) -> Optional[Span]:
        stack = self._stack()
        return stack[-1] if stack else None

    def current_trace(self) -> Optional[TraceContext]:
        return getattr(self._local, "trace", None)

    @contextlib.contextmanager
    def trace_scope(self, ctx: Optional[TraceContext]) -> Iterator[None]:
        """Make ``ctx`` the ambient trace on this thread: spans started
        with an empty stack parent to ``ctx.span_id`` and every span
        carries ``ctx.trace_id`` until the scope exits."""
        prev = getattr(self._local, "trace", None)
        self._local.trace = ctx
        try:
            yield
        finally:
            self._local.trace = prev

    @contextlib.contextmanager
    def span(
        self,
        name: str,
        on_finish: Optional[Callable[[Span], None]] = None,
        **attributes: Any,
    ) -> Iterator[Span]:
        stack = self._stack()
        ctx = getattr(self._local, "trace", None)
        sp = Span(
            name=name,
            span_id=next(_span_ids),
            parent_id=(
                stack[-1].span_id
                if stack
                else (ctx.span_id if ctx is not None else None)
            ),
            thread=threading.current_thread().name,
            started_at=time.time(),
            attributes=dict(attributes),
            trace_id=ctx.trace_id if ctx is not None else None,
            process=ctx.process if ctx is not None else "",
        )
        stack.append(sp)
        annotation = _trace_annotation(name) if self.annotate else None
        t0 = time.perf_counter()
        try:
            if annotation is None:
                yield sp
            else:
                with annotation:
                    yield sp
        finally:
            sp.wall_s = time.perf_counter() - t0
            # pop by identity: an exception while a child span is still
            # open must not mis-pop the parent
            if stack and stack[-1] is sp:
                stack.pop()
            elif sp in stack:
                stack.remove(sp)
            if on_finish is not None:
                on_finish(sp)


@contextlib.contextmanager
def profiler_trace(log_dir: str) -> Iterator[Any]:
    """Capture a ``torch.profiler`` trace of the wrapped block (CPU
    activity, and CUDA activity when the configured device is CUDA and
    this build of torch can trace it, so that a block holding the
    process's first card run records its kernels) and write it
    as a Chrome trace into ``log_dir`` (``trace.json``; open it in
    Perfetto or ``chrome://tracing``). Span annotations inside the block
    appear in it under their ``deequ_tpu:<name>`` labels. Yields the
    profiler, whose ``events()`` a caller may read after the block."""
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if _runs_on_cuda() and ProfilerActivity.CUDA in torch.profiler.supported_activities():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.__enter__()
    try:
        yield prof
    finally:
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
