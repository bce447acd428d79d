"""Crash isolation: run a scan or a verification in a child process.

Counterpart of ``deequ_tpu/engine/subproc.py``. The in-process
resilience layers (retry, quarantine, checkpoint, watchdog, OOM backoff)
live inside the process: a hard crash (a segfault, the OOM killer, a
stray SIGKILL) or a sticky CUDA error (a device-side assert leaves the
process's CUDA context unusable) takes the whole process down with
them. This module makes the PROCESS the fault domain.

- :class:`IsolatedRunner` runs a picklable callable in a child started
  with ``multiprocessing.get_context("spawn")`` (a parent that has
  initialised CUDA cannot fork). The child is given the parent's
  ``config.options().device`` (``configure`` is a process global and
  does not cross spawn) and applies it before it makes a tensor; a
  parent with no explicit device gives a child that runs on ``cuda``
  and raises in-band when there is none, as ``config.resolve_device``
  does: a child never falls back to the CPU. The result and the child's
  telemetry summary come back over a pipe, and a child's death is
  classified by its exit status: a signal (negative ``exitcode``) or a
  128+N status becomes :class:`ProcessCrashed`, a
  :class:`TransientScanError`.
- Every message on the pipe is framed with the standard pickler
  (``pickle.dumps`` and ``send_bytes``): ``import torch`` registers
  reductions with multiprocessing's own pickler that would ship a CPU
  tensor as a file descriptor the exiting child must still serve, and a
  CUDA tensor as an IPC handle of a dead process. The standard pickler
  copies a tensor's bytes. Work that runs on the card returns host
  values (numpy or Python numbers): a CUDA tensor in a result would be
  rebuilt on the parent's card.
- Relaunch from a checkpoint: ``ScanCheckpointer`` cursors are durable,
  so the runner relaunches the same callable and the scan resumes from
  the last cursor, bit-equal to an uninterrupted run.
- The crash-loop bound: ``config.crash_max_relaunches`` launches without
  checkpoint progress (a ``progress_probe`` observes the cursors between
  launches; ``checkpoint_progress_probe``) raise :class:`CrashLoopError`.
- :class:`CircuitBreaker`: a breaker per plan key. A crash loop trips
  it OPEN; launches then fail fast (:class:`BreakerOpen`) until
  ``config.crash_breaker_cooldown_s`` has passed, when ONE half-open
  probe is let through: its success closes the breaker, another crash
  loop opens it again. Clocks are injectable (``ManualClock``).

Children are always joined and reaped, in ``finally`` blocks. The
telemetry names are the JAX package's: ``engine.child_crashes``,
``engine.child_relaunches``, ``engine.crash_loops``,
``engine.crash_resumes``, ``engine.breaker_trips`` and the
``child_crashed``, ``child_relaunched``, ``crash_resumed`` and
``crash_breaker_*`` events. A child's spans stream back as they finish
and are replayed under the launching span, tagged ``/child``.
"""

from __future__ import annotations

import multiprocessing
import os
import pickle
import signal as _signal
import threading
from typing import Any, Callable, Dict, Optional, Tuple

from deequ_tpu_torch.engine.deadline import CancelToken, MonotonicClock
from deequ_tpu_torch.engine.resilience import TransientScanError

#: the parent's ``TraceContext.encode()`` in a child's environment
#: (trace id : the launching span's id : process label): the child roots
#: its spans there and streams each finished span back as a
#: ``("span", record)`` frame ahead of its result
CHILD_TRACE_ENV = "DEEQU_TPU_CHILD_TRACE"

#: a fleet replica's epoch guard in a child's environment (JSON:
#: fleet_dir / replica / epoch): a child re-reads the named lease chain
#: before each durable persist and stops persisting once the parent was
#: fenced (``child_epoch_fenced``)
CHILD_EPOCH_ENV = "DEEQU_TPU_CHILD_EPOCH"


class ProcessCrashed(TransientScanError):
    """The child died without delivering a result: killed by a signal or
    exited with a crash status. Transient on purpose: the checkpoint
    survives the crash, so a relaunch resumes the scan."""

    def __init__(
        self,
        message: str,
        *,
        exitcode: Optional[int] = None,
        signal_name: Optional[str] = None,
        launches: int = 1,
    ):
        super().__init__(message)
        self.exitcode = exitcode
        self.signal_name = signal_name
        self.launches = launches


class CrashLoopError(Exception):
    """The same work crashed the child ``crash_max_relaunches`` times
    without checkpoint progress: a poison batch or plan. The run fails
    cleanly and the plan's circuit breaker trips."""

    def __init__(
        self,
        message: str,
        *,
        launches: int,
        last_exitcode: Optional[int] = None,
        last_signal: Optional[str] = None,
    ):
        super().__init__(message)
        self.launches = launches
        self.last_exitcode = last_exitcode
        self.last_signal = last_signal


class BreakerOpen(Exception):
    """The plan's crash-loop breaker is OPEN: the launch is refused
    without a child. ``retry_after_s`` says when the next half-open
    probe will be let through."""

    def __init__(self, message: str, *, retry_after_s: float, key: str):
        super().__init__(message)
        self.retry_after_s = max(0.0, float(retry_after_s))
        self.key = key


class _ChildError(RuntimeError):
    """Carries a child's exception that did not survive pickling: its
    class name and traceback text come back instead."""

    def __init__(self, error_class: str, message: str, traceback_text: str):
        super().__init__(f"{error_class}: {message}")
        self.error_class = error_class
        self.traceback_text = traceback_text


# -- the circuit breaker -----------------------------------------------------

CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"


class CircuitBreaker:
    """Crash-loop breaker for ONE plan key: closed -> (crash loop) open
    -> (cooldown) half-open probe -> closed on success, open on another
    crash loop. ``clock`` is anything with ``.now() -> float``."""

    def __init__(self, cooldown_s: float, clock: Optional[Any] = None):
        self.cooldown_s = float(cooldown_s)
        self._clock = clock or MonotonicClock()
        self._lock = threading.Lock()
        self._state = CLOSED
        self._opened_at = 0.0
        self._probing = False

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def admit(self, key: str = "") -> None:
        """Raise :class:`BreakerOpen` unless a launch may go ahead. An
        OPEN breaker past its cooldown lets exactly one HALF_OPEN probe
        through; launches during the probe are refused."""
        from deequ_tpu_torch.telemetry import get_telemetry

        with self._lock:
            if self._state == CLOSED:
                return
            elapsed = self._clock.now() - self._opened_at
            if self._state == OPEN and elapsed >= self.cooldown_s:
                self._state = HALF_OPEN
                self._probing = True
                get_telemetry().event("crash_breaker_half_open", key=key)
                return
            if self._state == HALF_OPEN and not self._probing:
                self._probing = True
                return
            retry_after = max(0.0, self.cooldown_s - elapsed)
            raise BreakerOpen(
                f"crash-loop breaker open for {key or 'plan'} (retry in {retry_after:.1f}s)",
                retry_after_s=retry_after, key=key)

    def record_success(self, key: str = "") -> None:
        from deequ_tpu_torch.telemetry import get_telemetry

        with self._lock:
            was = self._state
            self._state = CLOSED
            self._probing = False
        if was != CLOSED:
            get_telemetry().event("crash_breaker_closed", key=key)

    def record_crash_loop(self, key: str = "") -> None:
        from deequ_tpu_torch.telemetry import get_telemetry

        with self._lock:
            self._state = OPEN
            self._opened_at = self._clock.now()
            self._probing = False
        tm = get_telemetry()
        tm.counter("engine.breaker_trips").inc()
        tm.event("crash_breaker_open", key=key, cooldown_s=self.cooldown_s)


_breakers: Dict[str, CircuitBreaker] = {}
_breakers_lock = threading.Lock()


def breaker_for(key: str, cooldown_s: Optional[float] = None,
                clock: Optional[Any] = None) -> Optional[CircuitBreaker]:
    """The process-wide breaker of a plan key (made at first use); None
    when breakers are off (``crash_breaker_cooldown_s <= 0``)."""
    from deequ_tpu_torch import config

    if cooldown_s is None:
        cooldown_s = config.options().crash_breaker_cooldown_s
    if cooldown_s is None or cooldown_s <= 0:
        return None
    with _breakers_lock:
        breaker = _breakers.get(key)
        if breaker is None:
            breaker = CircuitBreaker(cooldown_s, clock=clock)
            _breakers[key] = breaker
        return breaker


def reset_breakers() -> None:
    """Drop every registered breaker (test isolation)."""
    with _breakers_lock:
        _breakers.clear()


def breaker_states() -> Dict[str, str]:
    """The state of every registered breaker, by plan key."""
    with _breakers_lock:
        items = list(_breakers.items())
    return {key: breaker.state for key, breaker in items}


# -- the checkpoint progress probe -------------------------------------------


def checkpoint_progress_probe(path: str) -> Callable[[], Tuple]:
    """A progress probe over a ``ScanCheckpointer`` directory: a callable
    whose value changes whenever a checkpoint cursor under ``path``
    advances (an egress cursor's durable span or spool offset counts
    too). The runner compares its values across launches: a crash later
    than the previous one is progress, not a loop. Blobs are read with
    the checkpointer's own unpickler, which refuses the JAX package's."""

    def probe() -> Tuple:
        import io

        from deequ_tpu_torch.io.state_provider import _PortUnpickler
        from deequ_tpu_torch.io.storage import storage_for

        storage = storage_for(path)
        out = []
        for key in sorted(storage.list_keys("scan-ckpt-")):
            raw = storage.read_bytes(key)
            if raw is None:
                continue
            try:
                payload = _PortUnpickler(io.BytesIO(raw)).load()
            except Exception:  # noqa: BLE001 — a torn blob tells nothing
                continue
            cursor = payload.get("cursor") if isinstance(payload, dict) else None
            batch_index = getattr(cursor, "batch_index", None)
            if batch_index is None:
                continue
            egress = getattr(cursor, "egress", None)
            if egress is not None:
                out.append((key, int(batch_index),
                            int(getattr(egress, "last_durably_flushed_span_seq", -1)),
                            int(getattr(egress, "plane_spool_offset", 0))))
            else:
                out.append((key, int(batch_index)))
        return tuple(out)

    return probe


# a spawned child's hook: the egress writer calls notify_egress_progress
# after every durable flush, which streams an ("egress", record) frame to
# the parent (installed by _child_main); elsewhere it does nothing
_egress_notify: Optional[Callable[[Dict[str, Any]], None]] = None


def notify_egress_progress(record: Dict[str, Any]) -> None:
    """Report a durable egress flush to the isolation parent, if any. No
    listener costs nothing; a torn pipe never fails the flush."""
    hook = _egress_notify
    if hook is not None:
        hook(record)


# -- the pipe ----------------------------------------------------------------


def _send(conn: Any, message: Any) -> None:
    """One frame of the standard pickler: a tensor's bytes are copied,
    never shared through a descriptor or a CUDA IPC handle."""
    conn.send_bytes(pickle.dumps(message, protocol=pickle.HIGHEST_PROTOCOL))


def _recv(conn: Any) -> Any:
    return pickle.loads(conn.recv_bytes())


# -- the child ---------------------------------------------------------------

# the cancel token of THIS process when it runs as an isolated child:
# _child_main makes it fresh and a watcher thread fires it when the
# parent sends ("cancel", reason) down the control pipe, so a cancel
# reaches a spawned scan as it reaches one in the process (a clean exit
# at the next batch boundary, a final checkpoint, a partial result)
_child_cancel: Optional[CancelToken] = None


def child_cancel_token() -> CancelToken:
    """The cancel token a spawned child's work observes (a fresh one
    that never fires outside a child)."""
    global _child_cancel
    if _child_cancel is None:
        _child_cancel = CancelToken()
    return _child_cancel


def child_epoch_fenced() -> bool:
    """True when this process carries a fleet epoch guard
    (``CHILD_EPOCH_ENV``) whose lease chain has moved past the epoch it
    was given: the parent replica was fenced, so this child must stop its
    durable persists too. False without a guard, or when the guard cannot
    be read (an unreadable fleet directory must not stall a healthy
    child)."""
    raw = os.environ.get(CHILD_EPOCH_ENV, "")
    if not raw:
        return False
    try:
        import json

        from deequ_tpu_torch.io.storage import storage_for

        guard = json.loads(raw)
        replica, epoch = guard["replica"], int(guard["epoch"])
        storage = storage_for(guard["fleet_dir"])
        for key in storage.list_keys(f"leases/lease-{replica}-"):
            blob = storage.read_bytes(key)
            if blob is None:
                continue
            body = json.loads(blob)
            if body.get("replica") == replica and int(body.get("epoch", 0)) > epoch:
                return True
        return False
    except Exception:  # noqa: BLE001 — a guard that cannot be read stays open
        return False


def _child_trace(tm: Any) -> Optional[Any]:
    """The parent's trace (``CHILD_TRACE_ENV``) as this child's ambient
    context, tagged ``/child`` so a merged timeline tells the processes
    apart."""
    from deequ_tpu_torch.telemetry.spans import TraceContext

    ctx = TraceContext.decode(os.environ.get(CHILD_TRACE_ENV, ""))
    if ctx is None or not tm.enabled:
        return None
    label = f"{ctx.process}/child" if ctx.process else "child"
    return TraceContext(ctx.trace_id, ctx.span_id, process=label)


def _watch_parent_cancel(cancel_conn: Any, token: CancelToken) -> None:
    """The child's watcher: one blocking read of the control pipe. A
    ``("cancel", reason)`` frame fires the token; the end of the pipe
    (the run ended without a cancel) ends the watcher."""
    try:
        msg = _recv(cancel_conn)
    except Exception:  # noqa: BLE001 — the pipe closed: no cancel came
        return
    if isinstance(msg, tuple) and msg and msg[0] == "cancel":
        token.cancel(str(msg[1] if len(msg) > 1 else "cancelled by parent"))


def _apply_child_env(env: Dict[str, Optional[str]]) -> None:
    for name, value in env.items():
        if value is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = value


def _shippable_error(exc: BaseException) -> BaseException:
    """``exc`` when it survives a pickle round trip, else a
    :class:`_ChildError` that carries its name and traceback."""
    import traceback

    try:
        pickle.loads(pickle.dumps(exc, protocol=pickle.HIGHEST_PROTOCOL))
        return exc
    except Exception:  # noqa: BLE001 — an exception that cannot cross
        return _ChildError(type(exc).__name__, str(exc),
                           "".join(traceback.format_exception(exc)))


def _child_main(
    conn: Any,
    cancel_conn: Any,
    fn: Callable[[Any], Any],
    payload: Any,
    device: Optional[str] = None,
    env: Optional[Dict[str, Optional[str]]] = None,
) -> None:
    """The spawn entry point: apply the parent's device, run
    ``fn(payload)`` and send ``("ok", result, telemetry_summary)`` or
    ``("err", exception, telemetry_summary)``. A device the child cannot
    use raises in-band. A crash sends nothing and the parent classifies
    the exit status, but every span finished before it has streamed out
    as a ``("span", record)`` frame."""
    _apply_child_env(env or {})
    from deequ_tpu_torch import config

    if device is not None:
        config.set_option(device=device)
    from deequ_tpu_torch.telemetry import get_telemetry

    tm = get_telemetry()
    global _child_cancel, _egress_notify
    _child_cancel = CancelToken()
    # a daemon by design: it blocks on the control pipe for the child's
    # whole life, touches no scan, and dies with the process
    threading.Thread(target=_watch_parent_cancel, args=(cancel_conn, _child_cancel),
                     daemon=True, name="deequ-torch-child-cancel").start()
    send_lock = threading.Lock()

    def stream(kind: str):
        def send(record: Dict[str, Any]) -> None:
            try:
                with send_lock:
                    _send(conn, (kind, record))
            except Exception:  # noqa: BLE001 — best effort: never fails the run
                pass
        return send

    ctx = _child_trace(tm)
    if ctx is not None:
        tm.add_span_sink(stream("span"))
    # egress frames flow traced or not: the parent's crash-loop count
    # needs them whenever a sink run is isolated
    _egress_notify = stream("egress")
    cap = None
    try:
        with tm.trace_scope(ctx):
            with tm.run("isolated_child") as cap:
                # the child's device is resolved before any work: a
                # CUDA device without a GPU raises here, in-band
                config.resolve_device()
                result = fn(payload)
        message = ("ok", result, cap.final)
    except BaseException as exc:  # noqa: BLE001 — the boundary: the exception
        # (interrupts included) is shipped to the parent, which raises it
        message = ("err", _shippable_error(exc), getattr(cap, "final", None))
    try:
        with send_lock:
            try:
                _send(conn, message)
            except Exception:  # noqa: BLE001 — a result that cannot cross
                _send(conn, ("err", _ChildError(
                    "UnpicklableResult",
                    f"child result of type {type(message[1]).__name__} cannot cross the pipe",
                    ""), None))
    finally:
        conn.close()


# -- the parent --------------------------------------------------------------


def _classify_exit(exitcode: Optional[int]) -> Tuple[str, Optional[str]]:
    """(description, signal name) of a child that died without a message.
    A negative exit code is a signal (multiprocessing's convention);
    128+N is the shell's."""
    if exitcode is None:
        return "child vanished without an exit status", None
    signum = None
    if exitcode < 0:
        signum = -exitcode
    elif exitcode >= 128:
        signum = exitcode - 128
    if signum is not None:
        try:
            name = _signal.Signals(signum).name
        except ValueError:
            name = f"signal {signum}"
        return f"child killed by {name} (exitcode {exitcode})", name
    return f"child exited with status {exitcode} before replying", None


class IsolatedRunner:
    """Run picklable work in spawned children, resuming across crashes
    from durable checkpoints.

    ``run(fn, payload)`` runs ``fn(payload)`` in a child and returns its
    result. On a crash the child is relaunched, so ``fn`` must be
    resumable (a scan with a checkpointer is). Launches without progress
    are bounded by ``max_relaunches``; the breaker of ``key`` (when on)
    refuses work fast after a crash loop. ``timeout_s`` bounds each
    launch: past it the child is terminated, then killed, and the launch
    counts as a crash. ``cancel_token`` firing sends the child one
    cancel frame and keeps waiting for its partial result.
    """

    def __init__(
        self,
        *,
        key: str = "",
        max_relaunches: Optional[int] = None,
        timeout_s: Optional[float] = None,
        progress_probe: Optional[Callable[[], Any]] = None,
        breaker: Optional[CircuitBreaker] = None,
        use_breaker: bool = True,
        clock: Optional[Any] = None,
        cancel_token: Optional[CancelToken] = None,
        epoch_guard: Optional[str] = None,
    ):
        from deequ_tpu_torch import config

        opts = config.options()
        self.key = key
        self.max_relaunches = (int(opts.crash_max_relaunches) if max_relaunches is None
                               else int(max_relaunches))
        self.timeout_s = timeout_s
        self.progress_probe = progress_probe
        if breaker is None and use_breaker and key:
            breaker = breaker_for(key, clock=clock)
        self.breaker = breaker
        self.cancel_token = cancel_token
        # the last ("egress", record) frame of any child: durable egress
        # between scan checkpoints is progress too (run)
        self._last_egress_frame: Optional[Dict[str, Any]] = None
        self.epoch_guard = epoch_guard
        self._ctx = multiprocessing.get_context("spawn")

    # -- one launch ------------------------------------------------------

    def _wait(self, parent_conn: Any, cancel_send: Any, spans: list) -> Tuple[Any, bool]:
        """Read span and egress frames until the final message, the end
        of the pipe or the timeout: (message or None, whether the
        timeout expired). With a cancel token the wait is sliced, so a
        cancel reaches the child promptly."""
        clk = MonotonicClock()
        deadline = clk.now() + self.timeout_s if self.timeout_s is not None else None
        cancel_sent = False
        while True:
            token = self.cancel_token
            if token is not None and not cancel_sent and token.cancelled:
                cancel_sent = True
                try:
                    _send(cancel_send, ("cancel", token.reason or "cancelled"))
                except Exception:  # noqa: BLE001 — the child is gone: classified below
                    pass
            remaining = None if deadline is None else max(0.0, deadline - clk.now())
            if remaining is not None and remaining <= 0.0:
                return None, True
            wait = remaining
            if token is not None:
                wait = 0.05 if remaining is None else min(0.05, remaining)
            if not parent_conn.poll(wait):
                if token is not None:
                    continue
                return None, True
            msg = _recv(parent_conn)
            if isinstance(msg, tuple) and len(msg) == 2 and msg[0] in ("span", "egress"):
                if isinstance(msg[1], dict):
                    if msg[0] == "span":
                        spans.append(msg[1])
                    else:
                        self._last_egress_frame = msg[1]
                continue
            return msg, False

    def _launch_once(self, fn: Callable[[Any], Any], payload: Any, launches: int) -> Any:
        from deequ_tpu_torch import config
        from deequ_tpu_torch.telemetry import get_telemetry

        tm = get_telemetry()
        parent_conn, child_conn = self._ctx.Pipe(duplex=False)
        # the control pipe, parent -> child: at most one cancel frame
        cancel_recv, cancel_send = self._ctx.Pipe(duplex=False)
        # the ambient trace, anchored at the parent's open span, so the
        # child's spans nest where the launch happened; it and the epoch
        # guard are the child's arguments, never this process's
        # environment, so concurrent launches cannot leak them
        shipped_parent: Optional[int] = None
        shipped = None
        ctx = tm.current_trace()
        if ctx is not None:
            current = tm.tracer.current()
            shipped_parent = current.span_id if current is not None else ctx.span_id
            shipped = ctx.child(shipped_parent)
        env = {CHILD_TRACE_ENV: shipped.encode() if shipped is not None else None,
               CHILD_EPOCH_ENV: self.epoch_guard or None}
        proc = self._ctx.Process(
            target=_child_main,
            args=(child_conn, cancel_recv, fn, payload, config.options().device, env),
            daemon=False,
        )
        message = None
        timed_out = False
        spans: list = []
        try:
            proc.start()
            child_conn.close()  # the child holds the real ends
            cancel_recv.close()
            try:
                message, poll_expired = self._wait(parent_conn, cancel_send, spans)
            except (EOFError, OSError):
                message, poll_expired = None, False  # the pipe torn by a dying child
            # a timeout is a poll that expired while the child lives; an
            # end of pipe wakes poll while a dying child may still look
            # alive, and that is a crash to classify by its exit status
            if (message is None and poll_expired and self.timeout_s is not None
                    and proc.is_alive()):
                timed_out = True
                proc.terminate()
        finally:
            for end in (child_conn, cancel_recv, cancel_send):
                end.close()
            if proc.pid is not None:
                proc.join(self.timeout_s)
                if proc.is_alive():  # terminate ignored: kill
                    proc.kill()
                    proc.join()
            parent_conn.close()
            exitcode = proc.exitcode
            proc.close()

        # the child's streamed spans join the parent's trace whatever the
        # outcome, re-rooted under the span the launch shipped
        if spans:
            tm.replay_spans(spans, root_parent_id=shipped_parent)
        if timed_out or message is None:
            if timed_out:
                description, signal_name = (f"child exceeded {self.timeout_s}s and was "
                                            "terminated"), "timeout"
            else:
                description, signal_name = _classify_exit(exitcode)
            tm.counter("engine.child_crashes").inc()
            tm.event("child_crashed", key=self.key, exitcode=exitcode, signal=signal_name,
                     launches=launches, spans_streamed=len(spans))
            raise ProcessCrashed(description, exitcode=exitcode, signal_name=signal_name,
                                 launches=launches)
        status, value, child_summary = message
        _merge_child_telemetry(tm, child_summary)
        if status == "ok":
            return value
        raise value

    # -- the relaunch loop -----------------------------------------------

    def run(self, fn: Callable[[Any], Any], payload: Any = None) -> Any:
        """``fn(payload)`` in a child, relaunched across crashes until it
        completes, raises in-band, or crashes ``max_relaunches`` times at
        one position."""
        from deequ_tpu_torch.telemetry import get_telemetry

        tm = get_telemetry()
        if self.breaker is not None:
            self.breaker.admit(self.key)
        last_progress = self.progress_probe() if self.progress_probe is not None else None
        last_egress = self._last_egress_frame
        crashes_here = 0  # crashes since the last progress seen
        launches = 0
        last_crash: Optional[ProcessCrashed] = None
        while True:
            launches += 1
            try:
                result = self._launch_once(fn, payload, launches)
            except ProcessCrashed as crash:
                last_crash = crash
                crashes_here += 1
                if self.progress_probe is not None:
                    progress = self.progress_probe()
                    if progress != last_progress:
                        last_progress = progress
                        crashes_here = 1  # this crash, at the new position
                # a durable egress flush streamed by the child is progress
                if self._last_egress_frame != last_egress:
                    last_egress = self._last_egress_frame
                    crashes_here = 1
                if crashes_here >= self.max_relaunches:
                    if self.breaker is not None:
                        self.breaker.record_crash_loop(self.key)
                    tm.counter("engine.crash_loops").inc()
                    raise CrashLoopError(
                        f"{self.key or 'run'} crashed {crashes_here} launches in a row "
                        f"without checkpoint progress (last: {crash})",
                        launches=launches, last_exitcode=crash.exitcode,
                        last_signal=crash.signal_name) from crash
                tm.counter("engine.child_relaunches").inc()
                tm.event("child_relaunched", key=self.key, launches=launches,
                         crashes_at_position=crashes_here)
                continue
            if self.breaker is not None:
                self.breaker.record_success(self.key)
            if launches > 1:
                tm.counter("engine.crash_resumes").inc()
                tm.event("crash_resumed", key=self.key, launches=launches,
                         last_signal=last_crash.signal_name if last_crash else None)
            return result


def _merge_child_telemetry(tm: Any, summary: Optional[Dict[str, Any]]) -> None:
    """Fold a child's run summary into the parent's telemetry: counter
    deltas add up and events replay, so a report reads one stream."""
    if not summary:
        return
    for name, delta in (summary.get("counters") or {}).items():
        try:
            tm.counter(name).inc(int(delta))
        except Exception:  # noqa: BLE001 — a malformed child counter
            continue
    for record in summary.get("events") or []:
        if not isinstance(record, dict) or "event" not in record:
            continue
        fields = {k: v for k, v in record.items() if k != "event"}
        try:
            tm.event(record["event"], **fields)
        except TypeError:  # a field named like a parameter of event()
            continue


def run_isolated(fn: Callable[[Any], Any], payload: Any = None, **kwargs: Any) -> Any:
    """``IsolatedRunner(**kwargs).run(fn, payload)``."""
    return IsolatedRunner(**kwargs).run(fn, payload)
