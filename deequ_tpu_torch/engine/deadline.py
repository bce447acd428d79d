"""Deadlines, cooperative cancellation, and watchdog supervision.

Counterpart of ``deequ_tpu/engine/deadline.py``. ``engine/resilience.py``
makes the fused scan survive batches that FAIL; this module makes it
survive batches that HANG, and gives every run a wall-clock budget,
which the reference deequ inherits from the schedulers it runs under.
Pieces:

- :class:`RunBudget` — a wall deadline plus an optional per-batch
  stall limit, measured on an INJECTABLE clock
  (:class:`MonotonicClock` for production, :class:`ManualClock` for
  tests — no resilience test ever wall-sleeps; fake time is advanced
  by the fault that is actually hanging, so healthy real-time work can
  never trip a spurious stall).
- :class:`CancelToken` — thread-safe, composable (parent cancellation
  propagates to children; a child can cancel independently), carries a
  reason. External cancellation, SIGTERM mapping, and the profiler's
  shared multi-pass budget all ride the same token.
- :class:`ScanSupervisor` + :class:`Watchdog` — per-scan supervision.
  The scan loop notes progress per batch (which re-arms the stall
  timer); the streaming consumer polls its prefetch queue with a short
  timeout and checks the supervisor on every empty poll; the watchdog
  THREAD covers the stages that cannot poll (the resident chunk-staging
  generator blocked inside a hung read) by setting the armed interrupt
  event, which releases the blocked source so it raises
  :class:`~deequ_tpu_torch.engine.resilience.ScanStalled` — a
  ``TransientScanError``, so a stall flows straight into the
  retry -> quarantine -> ``ScanDegradation`` path.
- :class:`ScanInterrupted` (``RunCancelled`` / ``DeadlineExceeded``) —
  derives from ``BaseException`` exactly like ``ScanKilled``: the
  retry/quarantine machinery catches ``Exception`` only, so an
  interrupt unwinds to the engine loop, which exits CLEANLY — persists
  a final checkpoint cursor (resume is bit-identical), records a :class:`ScanInterruption` on the engine, and
  returns partial states so the runner still computes partial metrics.
- :class:`AdmissionController` — a FIFO ticket queue bounding
  concurrent runs (``config.max_concurrent_runs``); queued runs wait
  under their own deadline instead of oversubscribing the device.
- :func:`install_graceful_shutdown` — opt-in SIGTERM handler that maps
  process shutdown onto the process-wide shutdown
  :class:`CancelToken`, so an orchestrator's TERM becomes a
  checkpointed, resumable exit instead of lost work.

The user-facing API is ``deadline=`` and ``cancel=`` on
``AnalysisRunner.do_analysis_run`` and ``VerificationSuite``, and their
builders' ``with_deadline``/``with_cancel``. A stall counts
``engine.stalls_detected`` (a ``scan_stalled`` event, emitted on the
scan's thread by ``ScanSupervisor.flush_stall_events``) and a queued
run ``engine.runs_queued``, as in the JAX package.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence

from deequ_tpu_torch.telemetry import get_telemetry

# --------------------------------------------------------------------------
# Interrupt exceptions
# --------------------------------------------------------------------------


class ScanInterrupted(BaseException):
    """A cooperative interrupt (cancellation or deadline exhaustion).

    A ``BaseException`` ON PURPOSE, same pattern as
    :class:`~deequ_tpu_torch.engine.resilience.ScanKilled`: the batch-level
    retry/quarantine machinery catches ``Exception`` only, so an
    interrupt tunnels through it to the engine's scan loop — which is
    the ONE place that handles it (final checkpoint, interruption
    record, clean partial-result exit). It never escapes a run."""

    kind = "interrupted"


class RunCancelled(ScanInterrupted):
    """External cancellation: a :class:`CancelToken` fired (user code,
    a parent token, or the SIGTERM shutdown token)."""

    kind = "cancelled"


class DeadlineExceeded(ScanInterrupted):
    """The run's :class:`RunBudget` wall deadline is exhausted (or an
    admission-queued run waited past it)."""

    kind = "deadline"


# --------------------------------------------------------------------------
# Clocks (injectable — tests never wall-sleep)
# --------------------------------------------------------------------------


class MonotonicClock:
    """Production clock: ``time.monotonic``."""

    def now(self) -> float:
        return time.monotonic()

    def queue_poll_s(self, stall_s: Optional[float] = None) -> float:
        """Real-time poll interval for blocking waits supervised on this
        clock — short enough to detect a stall promptly, long enough
        not to burn CPU."""
        if stall_s:
            return max(min(stall_s / 4.0, 0.5), 0.01)
        return 0.25


class ManualClock:
    """Deterministic test clock: ``now()`` only moves via ``advance``.

    Fake time is advanced by whatever is ACTUALLY consuming it — a
    ``hang_at_batch`` fault ticks the clock while it blocks, a
    ``slow_batch`` fault advances it by the configured delay — never by
    a free-running timer, so healthy batches that take real wall time
    (a jit compile, a slow CI host) can NEVER trip a spurious stall.
    ``queue_poll_s`` is a tiny REAL timeout so supervised waits re-check
    fake time thousands of times per real second."""

    def __init__(self, start: float = 0.0):
        self._now = float(start)
        self._lock = threading.Lock()

    def now(self) -> float:
        with self._lock:
            return self._now

    def advance(self, seconds: float) -> float:
        with self._lock:
            self._now += float(seconds)
            return self._now

    def queue_poll_s(self, stall_s: Optional[float] = None) -> float:
        return 0.002


# --------------------------------------------------------------------------
# Cancellation
# --------------------------------------------------------------------------


class CancelToken:
    """Thread-safe cancellation flag with a reason and parent/child
    composition: cancelling a parent cancels every child (transitively);
    a child cancels independently without touching its parent. Linking
    to an already-cancelled parent cancels the child immediately."""

    def __init__(self, parent: Optional["CancelToken"] = None):
        self._event = threading.Event()
        self._reason: Optional[str] = None
        self._lock = threading.Lock()
        self._children: List["CancelToken"] = []
        if parent is not None:
            parent._link(self)

    def _link(self, child: "CancelToken") -> None:
        with self._lock:
            if not self._event.is_set():
                self._children.append(child)
                return
            reason = self._reason
        child.cancel(reason or "cancelled")

    def child(self) -> "CancelToken":
        return CancelToken(parent=self)

    def cancel(self, reason: str = "cancelled") -> None:
        with self._lock:
            if self._event.is_set():
                return
            self._reason = reason
            self._event.set()
            children = list(self._children)
            self._children = []  # delivered; drop the references
        for c in children:
            c.cancel(reason)

    @property
    def cancelled(self) -> bool:
        return self._event.is_set()

    @property
    def reason(self) -> Optional[str]:
        return self._reason

    def raise_if_cancelled(self) -> None:
        if self._event.is_set():
            raise RunCancelled(self._reason or "cancelled")

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._event.wait(timeout)

    def __repr__(self) -> str:
        state = (
            f"cancelled: {self._reason!r}" if self.cancelled else "active"
        )
        return f"CancelToken({state})"


# --------------------------------------------------------------------------
# Run budget
# --------------------------------------------------------------------------


@dataclass
class RunBudget:
    """A run's time envelope: optional wall ``deadline_s`` and optional
    per-batch ``stall_s`` limit, both measured on ``clock``. ``start()``
    pins the epoch LAZILY on first use and is idempotent, so one budget
    shared across a multi-scan run (the profiler's three passes, the
    runner's deferred fallbacks) burns a single envelope rather than
    restarting per scan."""

    deadline_s: Optional[float] = None
    stall_s: Optional[float] = None
    clock: Any = field(default_factory=MonotonicClock)
    _started_at: Optional[float] = field(
        default=None, init=False, repr=False, compare=False
    )

    def start(self) -> "RunBudget":
        if self._started_at is None:
            self._started_at = self.clock.now()
        return self

    def elapsed(self) -> float:
        if self._started_at is None:
            return 0.0
        return self.clock.now() - self._started_at

    def remaining(self) -> Optional[float]:
        """Seconds left until the deadline (None = no deadline).
        Negative once exhausted."""
        if self.deadline_s is None:
            return None
        return self.deadline_s - self.elapsed()

    def expired(self) -> bool:
        remaining = self.remaining()
        return remaining is not None and remaining < 0

    def check(self) -> None:
        if self.expired():
            raise DeadlineExceeded(
                f"run deadline of {self.deadline_s}s exhausted "
                f"(elapsed {self.elapsed():.3f}s)"
            )


# --------------------------------------------------------------------------
# Interruption record (rides AnalyzerContext / VerificationResult)
# --------------------------------------------------------------------------


@dataclass
class ScanInterruption:
    """Provenance for a run that exited early: why, how far it got, and
    whether a resumable checkpoint cursor was persisted. Metrics on an
    interrupted run cover batches ``[0, batch_index)`` — correct over
    the rows scanned; ``config.degradation_policy`` decides what that
    does to a VerificationSuite status (same floor as quarantine)."""

    kind: str  # "cancelled" | "deadline"
    reason: str
    batch_index: int = 0
    row_offset: int = 0
    checkpointed: bool = False

    @staticmethod
    def merge_optional(
        a: Optional["ScanInterruption"], b: Optional["ScanInterruption"]
    ) -> Optional["ScanInterruption"]:
        # the FIRST interrupt is the one that stopped the run; later
        # scans in the same run short-circuit against it
        return a if a is not None else b

    def to_dict(self) -> Dict[str, Any]:
        return {
            "kind": self.kind,
            "reason": self.reason,
            "batch_index": self.batch_index,
            "row_offset": self.row_offset,
            "checkpointed": self.checkpointed,
        }


# --------------------------------------------------------------------------
# Supervision
# --------------------------------------------------------------------------


class ScanSupervisor:
    """Per-scan supervision state shared by the scan loop, the
    streaming prefetch consumer, and the watchdog thread.

    Progress model: ``note_arrival()`` (called inside the batch
    iterator as each item lands) re-arms the stall timer — "armed per
    batch". Detection is ONE rule, elapsed-since-last-arrival >
    ``stall_s``, checked from three places so whichever stage is
    actually blocked reports it: on item arrival (a slow batch), on an
    empty prefetch poll (a hung streaming worker), and from the
    watchdog thread (a hung stage that cannot poll — the resident
    staging generator). The watchdog cannot raise into the blocked
    thread, so it INTERRUPTS instead: it sets the armed interrupt event
    (handed to the source via ``dataset.attach_interrupt``), and the
    released source raises ``ScanStalled`` from the blocked call."""

    def __init__(
        self,
        budget: Optional[RunBudget] = None,
        tokens: Sequence[Optional[CancelToken]] = (),
    ):
        self.budget = budget.start() if budget is not None else None
        self.tokens: List[CancelToken] = [t for t in tokens if t is not None]
        self.clock = budget.clock if budget is not None else MonotonicClock()
        self._lock = threading.Lock()
        self._last_progress = self.clock.now()
        self._stall_counted = False
        self._interrupt_event: Optional[threading.Event] = None
        self._watchdog: Optional["Watchdog"] = None
        self.stalls = 0
        self._stall_events: List[Dict[str, Any]] = []

    # -- configuration views -------------------------------------------

    @property
    def stall_s(self) -> Optional[float]:
        return self.budget.stall_s if self.budget is not None else None

    def poll_s(self) -> float:
        return self.clock.queue_poll_s(self.stall_s)

    # -- interrupt checks (consumer side) ------------------------------

    def check(self) -> None:
        """Raise the pending interrupt, if any (cancel before deadline:
        an explicit cancel is the more specific reason)."""
        for token in self.tokens:
            token.raise_if_cancelled()
        if self.budget is not None:
            self.budget.check()

    def interrupted(self) -> bool:
        return any(t.cancelled for t in self.tokens) or (
            self.budget is not None and self.budget.expired()
        )

    def _stalled(self, at: Optional[float] = None) -> bool:
        stall = self.stall_s
        if not stall:
            return False
        with self._lock:
            last = self._last_progress
        return (self.clock.now() if at is None else at) - last > stall

    def on_wait(self) -> None:
        """Called by the streaming consumer on every EMPTY prefetch
        poll: the one moment it is provably blocked on the source."""
        self.check()
        if self._stalled():
            self._record_stall()
            self.reset_progress()  # the retry must not re-trip instantly
            from deequ_tpu_torch.engine.resilience import ScanStalled

            raise ScanStalled(
                f"no batch for more than {self.stall_s}s "
                "(prefetch queue empty) — stalled source"
            )

    def note_arrival(self, produced_at: Optional[float] = None) -> None:
        """Called inside the batch iterator as each item lands. A batch
        that took longer than ``stall_s`` end to end is itself a stall
        (this is what catches a slow batch the consumer never had to
        poll for); a timely batch re-arms the timer. ``produced_at`` is
        the clock when a prefetch thread queued the item: an item queued
        in time is not stalled by the time it waited in the queue while
        the consumer worked on the ones before it."""
        if self._stalled(produced_at):
            self._record_stall()
            self.reset_progress()
            from deequ_tpu_torch.engine.resilience import ScanStalled

            raise ScanStalled(
                f"batch exceeded the {self.stall_s}s stall limit"
            )
        self.reset_progress()

    def reset_progress(self) -> None:
        """Re-arm the stall timer (each batch arrival; each iterator
        (re)start — a retried iterator must start with a fresh window)."""
        with self._lock:
            self._last_progress = self.clock.now()
            self._stall_counted = False

    # -- blocked-source interruption -----------------------------------

    def arm_source(self) -> threading.Event:
        """A FRESH interrupt event for the next source iterator (fresh
        per restart: a consumed event from the previous stall must not
        pre-release the retry)."""
        event = threading.Event()
        with self._lock:
            self._interrupt_event = event
        return event

    def release_source(self) -> None:
        """Unblock whatever holds the armed interrupt event (watchdog
        on stall/cancel/deadline; consumer teardown on exit) — the
        hung-prefetch-worker release valve."""
        with self._lock:
            event = self._interrupt_event
        if event is not None:
            event.set()

    def _record_stall(self) -> None:
        with self._lock:
            if self._stall_counted:
                return  # watchdog + consumer race: count once per arm
            self._stall_counted = True
            self.stalls += 1
            # the event is deferred: this may run on the watchdog thread,
            # and run captures are thread-scoped; the engine flushes the
            # events on the scan's thread at the scan's end
            self._stall_events.append({"stall_s": self.stall_s, "stalls": self.stalls})
        get_telemetry().counter("engine.stalls_detected").inc()

    def flush_stall_events(self) -> None:
        """Emit the deferred ``scan_stalled`` events on the calling
        thread (the engine's scan thread, inside any live run capture)."""
        with self._lock:
            pending, self._stall_events = self._stall_events, []
        tm = get_telemetry()
        for fields in pending:
            tm.event("scan_stalled", **fields)

    def watchdog_check(self) -> None:
        """One watchdog tick: on stall, cancellation, or deadline,
        interrupt the blocked source. The consumer-side checks then
        classify — stall retries/quarantines, cancel/deadline exit."""
        interrupt = self.interrupted()
        if self._stalled():
            self._record_stall()
            interrupt = True
        if interrupt:
            self.release_source()

    # -- watchdog lifecycle --------------------------------------------

    def start_watchdog(self) -> None:
        if self._watchdog is None:
            self._watchdog = Watchdog(self)
            self._watchdog.start()

    def stop_watchdog(self) -> None:
        if self._watchdog is not None:
            self._watchdog.stop()
            self._watchdog = None


class Watchdog:
    """Background thread driving :meth:`ScanSupervisor.watchdog_check`
    at the supervisor's poll interval. Daemon + joined-with-timeout on
    stop, so a scan can never leak it."""

    def __init__(self, supervisor: ScanSupervisor):
        self._supervisor = supervisor
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="deequ-tpu-torch-watchdog"
        )

    def start(self) -> None:
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(self._supervisor.poll_s()):
            try:
                self._supervisor.watchdog_check()
            except Exception:  # noqa: BLE001 — the watchdog must not die
                pass

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=2.0)


# --------------------------------------------------------------------------
# Admission control
# --------------------------------------------------------------------------


class AdmissionController:
    """FIFO bounded admission for analysis runs: at most ``limit`` run
    concurrently, the rest queue IN ORDER (a plain semaphore wakes
    waiters arbitrarily — ticket order makes queueing fair and
    testable). Waiters poll in short real intervals so a queued run's
    own :class:`RunBudget` (possibly on a fake clock) and cancel token
    stay live while it waits.

    High-watermark gate: with
    ``watermark_bytes`` set, a run also queues while admitting its
    ``estimated_bytes`` (engine.estimated_run_bytes, from the scan's
    row-capacity geometry) would push the byte sum of ACTIVE runs past
    the watermark — concurrent runs queue instead of co-OOMing. A
    single run larger than the whole watermark still admits when
    nothing else is active (it must run eventually; backoff is its
    safety net)."""

    def __init__(self) -> None:
        self._cond = threading.Condition()
        self._active = 0
        self._active_bytes = 0
        self._queue: "deque[int]" = deque()
        self._next_ticket = 0
        self.queued_total = 0  # runs that ever had to queue

    def _admissible_locked(
        self, limit: int, estimated_bytes: int, watermark_bytes: int
    ) -> bool:
        if limit > 0 and self._active >= limit:
            return False
        if (
            watermark_bytes > 0
            and estimated_bytes > 0
            and self._active > 0
            and self._active_bytes + estimated_bytes > watermark_bytes
        ):
            return False
        return True

    def acquire(
        self,
        limit: int,
        budget: Optional[RunBudget] = None,
        tokens: Sequence[Optional[CancelToken]] = (),
        estimated_bytes: int = 0,
        watermark_bytes: int = 0,
    ) -> None:
        """Block until admitted. ``limit <= 0`` means no concurrency
        bound (the watermark alone gates). Raises
        :class:`DeadlineExceeded` / :class:`RunCancelled` if the run's
        envelope closes while it is still queued — a run that cannot
        start in time must not start."""
        live = [t for t in tokens if t is not None]
        if budget is not None:
            budget.start()  # the envelope opens at submission: time
            # spent queued counts against the deadline (idempotent —
            # the scan supervisor re-starting it later is a no-op)
        with self._cond:
            if not self._queue and self._admissible_locked(
                limit, estimated_bytes, watermark_bytes
            ):
                self._active += 1
                self._active_bytes += max(0, int(estimated_bytes))
                return
            ticket = self._next_ticket
            self._next_ticket += 1
            self._queue.append(ticket)
            self.queued_total += 1
            get_telemetry().counter("engine.runs_queued").inc()
            try:
                while not (
                    self._queue[0] == ticket
                    and self._admissible_locked(
                        limit, estimated_bytes, watermark_bytes
                    )
                ):
                    for token in live:
                        token.raise_if_cancelled()
                    if budget is not None and budget.expired():
                        raise DeadlineExceeded(
                            "queued for admission past the run deadline "
                            f"({budget.deadline_s}s)"
                        )
                    self._cond.wait(timeout=0.02)
                self._queue.popleft()
                self._active += 1
                self._active_bytes += max(0, int(estimated_bytes))
            except BaseException:
                if ticket in self._queue:
                    self._queue.remove(ticket)
                self._cond.notify_all()
                raise

    def release(self, estimated_bytes: int = 0) -> None:
        with self._cond:
            self._active -= 1
            self._active_bytes = max(
                0, self._active_bytes - max(0, int(estimated_bytes))
            )
            self._cond.notify_all()

    def snapshot(self) -> Dict[str, int]:
        with self._cond:
            return {
                "active": self._active,
                "queued": len(self._queue),
                "active_bytes": self._active_bytes,
            }


_ADMISSION = AdmissionController()


def admission_controller() -> AdmissionController:
    """The process-wide admission controller
    (``config.max_concurrent_runs`` bounds it; 0 disables)."""
    return _ADMISSION


# --------------------------------------------------------------------------
# Graceful shutdown (SIGTERM -> process-wide cancellation)
# --------------------------------------------------------------------------


_shutdown_lock = threading.Lock()
_shutdown_token = CancelToken()
_shutdown_installed = False


def shutdown_token() -> CancelToken:
    """The process-wide shutdown token. Engine supervisors watch it
    once a graceful-shutdown handler is installed."""
    return _shutdown_token


def shutdown_installed() -> bool:
    return _shutdown_installed


def reset_shutdown_token() -> CancelToken:
    """Replace the shutdown token with a fresh one (tests; or a worker
    that survived a drain request and wants to serve again)."""
    global _shutdown_token
    with _shutdown_lock:
        _shutdown_token = CancelToken()
        return _shutdown_token


def install_graceful_shutdown(
    signals: Sequence[int] = None,
) -> Callable[[], None]:
    """Opt-in: map SIGTERM (by default) onto the process-wide shutdown
    token, so an orchestrator's TERM lands mid-scan as a cooperative
    cancel — final checkpoint persisted, partial metrics returned,
    prefetch worker joined — instead of lost work. Returns an
    ``uninstall()`` callable restoring the previous handlers. Must be
    called from the main thread (CPython signal rule)."""
    import signal as _signal

    global _shutdown_installed
    if signals is None:
        signals = (_signal.SIGTERM,)

    def _handler(signum, frame):  # noqa: ARG001 — signal signature
        shutdown_token().cancel(
            f"received signal {_signal.Signals(signum).name}"
        )

    previous = {}
    for sig in signals:
        previous[sig] = _signal.signal(sig, _handler)
    with _shutdown_lock:
        _shutdown_installed = True

    def uninstall() -> None:
        global _shutdown_installed
        for sig, old in previous.items():
            _signal.signal(sig, old)
        with _shutdown_lock:
            _shutdown_installed = False

    return uninstall
