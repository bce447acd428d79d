"""Deterministic fault injection for scan resilience tests.

Counterpart of ``deequ_tpu/testing/faults.py``, around the port's
``Dataset`` and ``ParquetDataset``: ``device_batches`` (a resident
scan), ``host_batches`` (a streamed one) and ``ingest_work_items`` (the
ordered ingest pool).

:class:`FaultInjectingDataset` wraps any Dataset and injects faults at
exact batch indices — every fault is a pure function of the configured
indices and the wrapper's mutable fault ledger (no RNG, no wall clock),
so a failing test replays byte-for-byte:

- ``transient={index: n}`` — the batch raises
  :class:`~deequ_tpu_torch.engine.resilience.TransientScanError` for its
  first ``n`` reads, then succeeds (raise-then-succeed: the retry path);
- ``permanent={index, ...}`` — the batch always raises ``ValueError``
  (a decode error: deterministic, must quarantine without retries);
- ``corrupt={index, ...}`` — the batch's arrays arrive truncated (the
  integrity-check path: quarantined, never shipped to the device);
- ``kill_at_batch=N`` — producing batch N raises
  :class:`~deequ_tpu_torch.engine.resilience.ScanKilled` (a BaseException:
  the scan unwinds like real process death, and with ``kill_once`` the
  next run survives — the checkpoint/resume differential tests);
- ``hang_at_batch={index: n}`` — producing the batch BLOCKS until the
  scan supervisor's watchdog interrupts it (the hung-source path: the
  wrapper spins on the interrupt event the engine attaches via
  ``attach_interrupt``, advancing the injectable ``clock`` by
  ``hang_tick_s`` per spin so fake-clock stall detection fires without
  any real sleeping), then raises
  :class:`~deequ_tpu_torch.engine.resilience.ScanStalled`; the batch re-hangs
  ``n`` times (one per retry attempt) before serving normally;
- ``slow_batch={index: delay_s}`` — producing the batch advances the
  injectable ``clock`` by ``delay_s`` once (the slow-but-arriving path:
  stall/deadline detection on a batch that DOES show up);
- ``on_batch={index: callable}`` — the callable runs every time the
  batch is produced, before fault checks (the deterministic trigger for
  cancel-mid-scan tests: cancel a token at exactly batch k);
- ``crash_at_batch=N`` — producing batch N HARD-CRASHES the process
  (``signal.raise_signal(SIGSEGV)``, with ``os._exit(139)`` as the
  fallback): no exception, no unwinding, no atexit — the deterministic
  stand-in for a real segfault of the runtime, for a supervisor that
  relaunches the process (the JAX package's ``engine/subproc.py``). ``crash_token_path`` gives
  cross-process crash-once semantics: the in-memory ledger dies WITH
  the process, so the wrapper drops a marker file before crashing and a
  relaunched child that finds the marker serves the batch normally.
  Without a token path the batch is POISON — it crashes every launch,
  which is exactly what the crash-loop breaker tests need;
- ``crash_every_n=k`` — every k-th batch hard-crashes (token-gated per
  index when ``crash_token_path`` is set, so each crash fires once
  across the run's relaunch chain).

Memory-pressure faults (engine/memory.py) fire through the engine's
``oom_probe`` protocol — the engine calls ``probe(stage, index, rows)``
INSIDE its guarded transfer/dispatch/finalize stages, so an injected
OOM rides the exact classification path a live device allocation
failure would, with zero real memory pressure:

- ``oom_at_batch={index: n}`` (or a bare iterable, n=1) — the unit's
  dispatch raises a simulated ``RESOURCE_EXHAUSTED`` for its first
  ``n`` attempts at that index, then succeeds (raise-then-succeed:
  backoff shrinks, the retried sub-batches pass);
- ``oom_every_n=k`` — every k-th unit's dispatch OOMs once;
- ``oom_rows_over=limit`` — ANY dispatch/transfer wider than ``limit``
  rows OOMs: the natural geometric-backoff fault (the scan settles at
  the first effective size <= limit; exact analog of a device that
  fits only so many rows);
- ``oom_transfer_at={index: n}`` — like ``oom_at_batch`` but fired at
  the transfer (host -> device copy) stage;
- ``oom_finalize=n`` / ``oom_deferred=n`` — the first ``n``
  collector-finalize / deferred-path probes OOM (the spill downgrade
  chain in analyzers/grouping.py).

The fault ledger (remaining transient raises, remaining hangs, one-shot
slow delays, remaining OOMs, the kill flag) is SHARED across iterator
restarts and re-runs of the same wrapper instance, mirroring a real
flaky source that eventually serves the batch.
"""

from __future__ import annotations

import os
import signal
from typing import Any, Callable, Dict, Iterable, Iterator, Optional, Set

from deequ_tpu_torch.engine.memory import simulated_device_oom
from deequ_tpu_torch.engine.resilience import (
    ScanKilled,
    ScanStalled,
    TransientScanError,
)


def hard_crash(signum: Optional[int] = None) -> None:
    """Kill THIS process the way a real fault would: raise the signal
    (default SIGSEGV — the parent sees exitcode ``-signum``), falling
    back to ``os._exit(128 + signum)`` (the shell convention, e.g. 139)
    when the signal somehow returns. Never raises, never unwinds, never
    runs atexit — by design."""
    num = int(signum) if signum is not None else int(signal.SIGSEGV)
    try:
        signal.raise_signal(num)
    except Exception:  # noqa: BLE001 — no signal support: exit hard
        pass
    os._exit(128 + num)


class FaultInjectingDataset:
    """Wrap a Dataset, injecting faults at configured batch indices.

    Everything not overridden here (``num_rows``, ``schema``,
    ``fingerprint``, cache internals, ...) delegates to the inner
    dataset, so the wrapper is drop-in for the engine's resident and
    streamed paths. Fault indices are batch indices.
    """

    def __init__(
        self,
        inner: Any,
        transient: Optional[Dict[int, int]] = None,
        permanent: Optional[Iterable[int]] = None,
        corrupt: Optional[Iterable[int]] = None,
        kill_at_batch: Optional[int] = None,
        kill_once: bool = True,
        crash_at_batch: Optional[int] = None,
        crash_every_n: int = 0,
        crash_token_path: Optional[str] = None,
        crash_signum: Optional[int] = None,
        hang_at_batch: Optional[Any] = None,
        slow_batch: Optional[Dict[int, float]] = None,
        on_batch: Optional[Dict[int, Callable[[], None]]] = None,
        clock: Optional[Any] = None,
        hang_tick_s: float = 0.25,
        oom_at_batch: Optional[Any] = None,
        oom_every_n: int = 0,
        oom_rows_over: int = 0,
        oom_transfer_at: Optional[Any] = None,
        oom_finalize: int = 0,
        oom_deferred: int = 0,
        decode_transient: Optional[Dict[int, int]] = None,
        decode_permanent: Optional[Iterable[int]] = None,
    ):
        self._inner = inner
        self._transient_remaining = dict(transient or {})
        self._permanent: Set[int] = set(permanent or ())
        self._corrupt: Set[int] = set(corrupt or ())
        self._kill_at_batch = kill_at_batch
        self._kill_once = kill_once
        self._killed = False
        # hard-crash faults (process death, not exceptions)
        self._crash_at_batch = crash_at_batch
        self._crash_every_n = int(crash_every_n)
        self._crash_token_path = crash_token_path
        self._crash_signum = crash_signum
        # hang_at_batch accepts {index: n_hangs} or a bare iterable of
        # indices (one hang each)
        if hang_at_batch is None:
            self._hangs_remaining: Dict[int, int] = {}
        elif isinstance(hang_at_batch, dict):
            self._hangs_remaining = dict(hang_at_batch)
        else:
            self._hangs_remaining = {i: 1 for i in hang_at_batch}
        self._slow_remaining = dict(slow_batch or {})
        self._on_batch = dict(on_batch or {})
        self._clock = clock
        self._hang_tick_s = float(hang_tick_s)
        self._interrupt_event: Optional[Any] = None
        # memory-pressure ledgers ({index: n} or bare iterable, n=1)
        self._oom_remaining = self._oom_spec(oom_at_batch)
        self._oom_transfer_remaining = self._oom_spec(oom_transfer_at)
        self._oom_every_n = int(oom_every_n)
        self._oom_every_fired: Set[int] = set()
        self._oom_rows_over = int(oom_rows_over)
        self._oom_finalize_remaining = int(oom_finalize)
        self._oom_deferred_remaining = int(oom_deferred)
        # r10 worker-stage faults: fired inside ``item.decode()`` on a
        # pool WORKER thread (simulated worker death), surfacing
        # through the ordered reassembly stage at the batch's exact
        # sequence position
        self._decode_transient_remaining = dict(decode_transient or {})
        self._decode_permanent: Set[int] = set(decode_permanent or ())
        # observability for assertions: every fault actually fired
        self.faults_fired: list = []

    @staticmethod
    def _oom_spec(spec: Optional[Any]) -> Dict[int, int]:
        if spec is None:
            return {}
        if isinstance(spec, dict):
            return {int(k): int(v) for k, v in spec.items()}
        return {int(i): 1 for i in spec}

    def oom_probe(self, stage: str, index: int = 0, rows: int = 0) -> None:
        """Engine protocol hook (engine/memory.py ``oom_probe_of``):
        called inside the guarded transfer/dispatch/finalize stages
        with the unit index and the dispatch width in rows; raises a
        simulated ``RESOURCE_EXHAUSTED`` when a configured
        memory-pressure fault is due at that point."""

        def fire():
            self.faults_fired.append(("oom", stage, index, int(rows)))
            raise simulated_device_oom(rows, f"{stage}@{index}")

        if stage == "finalize":
            if self._oom_finalize_remaining > 0:
                self._oom_finalize_remaining -= 1
                fire()
            return
        if stage == "deferred":
            if self._oom_deferred_remaining > 0:
                self._oom_deferred_remaining -= 1
                fire()
            return
        # a device that fits only `limit` rows: any wider allocation
        # fails, at full size AND at still-too-wide backed-off sizes —
        # the scan settles at the first effective size <= limit
        if self._oom_rows_over and rows > self._oom_rows_over:
            fire()
        ledger = (
            self._oom_transfer_remaining
            if stage == "transfer"
            else self._oom_remaining
        )
        remaining = ledger.get(index, 0)
        if remaining > 0:
            ledger[index] = remaining - 1
            fire()
        if (
            self._oom_every_n > 0
            and stage == "dispatch"
            and (index + 1) % self._oom_every_n == 0
            and index not in self._oom_every_fired
        ):
            self._oom_every_fired.add(index)
            fire()

    def attach_interrupt(self, event: Any) -> None:
        """Engine protocol hook: the scan supervisor hands the source an
        Event it will set when the watchdog wants the source unblocked
        (a fresh one per iterator (re)start)."""
        self._interrupt_event = event

    def __getattr__(self, name: str) -> Any:
        return getattr(self._inner, name)

    # -- fault core ----------------------------------------------------

    def _fire_hook(self, index: int) -> None:
        hook = self._on_batch.get(index)
        if hook is not None:
            self.faults_fired.append(("hook", index))
            hook()

    def _maybe_slow(self, index: int) -> None:
        delay = self._slow_remaining.pop(index, None)
        if delay is None:
            return
        self.faults_fired.append(("slow", index))
        if self._clock is not None:
            self._clock.advance(delay)

    def _maybe_hang(self, index: int) -> None:
        remaining = self._hangs_remaining.get(index, 0)
        if remaining <= 0:
            return
        self._hangs_remaining[index] = remaining - 1
        self.faults_fired.append(("hang", index))
        ev = self._interrupt_event
        if ev is None:
            # no supervisor armed this source: a real hang would block
            # forever — self-report the stall instead of deadlocking
            # the test process
            if self._clock is not None:
                self._clock.advance(self._hang_tick_s)
            raise ScanStalled(
                f"injected hang at batch {index} (no supervisor attached)"
            )
        ticks = 0
        while not ev.is_set():
            # the hang is where fake time passes: tick the injectable
            # clock so the watchdog's stall rule (now - last_progress >
            # stall_s) trips without any real sleeping, then yield the
            # GIL briefly so the watchdog thread actually runs
            if self._clock is not None:
                self._clock.advance(self._hang_tick_s)
            ev.wait(0.001)
            ticks += 1
            if ticks > 20_000:  # ~20s real: supervision is broken
                raise RuntimeError(
                    f"injected hang at batch {index} was never "
                    "interrupted by the watchdog"
                )
        raise ScanStalled(f"injected hang at batch {index} interrupted")

    def _crash_due(self, index: int) -> bool:
        if self._crash_at_batch is not None and index == self._crash_at_batch:
            return True
        return (
            self._crash_every_n > 0
            and index > 0
            and index % self._crash_every_n == 0
        )

    def _maybe_crash(self, index: int) -> None:
        """Hard process death at ``index`` — fires BEFORE the softer
        faults (a segfault does not politely defer to a retry)."""
        if not self._crash_due(index):
            return
        if self._crash_token_path is not None:
            token = f"{self._crash_token_path}.crashed-b{index}"
            if os.path.exists(token):
                return  # this launch already paid the crash here
            with open(token, "x", encoding="utf-8") as fh:
                fh.write(f"batch {index}\n")
                fh.flush()
                os.fsync(fh.fileno())
        hard_crash(self._crash_signum)

    def _check_faults(self, index: int) -> None:
        """Raise the configured fault for ``index``, if any — BEFORE the
        item is yielded, so the engine's failing-index arithmetic
        (start + items_yielded) lands exactly on ``index``."""
        self._maybe_crash(index)
        if (
            self._kill_at_batch is not None
            and index == self._kill_at_batch
            and not (self._kill_once and self._killed)
        ):
            self._killed = True
            self.faults_fired.append(("kill", index))
            raise ScanKilled(f"injected kill at batch {index}")
        if index in self._permanent:
            self.faults_fired.append(("permanent", index))
            raise ValueError(f"injected decode error at batch {index}")
        remaining = self._transient_remaining.get(index, 0)
        if remaining > 0:
            self._transient_remaining[index] = remaining - 1
            self.faults_fired.append(("transient", index))
            raise TransientScanError(
                f"injected transient error at batch {index} "
                f"({remaining - 1} more)"
            )

    def _maybe_corrupt(self, index: int, batch: Dict[str, Any]):
        """The batch with every array cut to half its rows (at least
        one): numpy arrays and tensors alike; host payloads (dictionary
        deltas) pass."""
        if index not in self._corrupt:
            return batch
        self.faults_fired.append(("corrupt", index))
        out = {}
        for k, v in batch.items():
            shape = getattr(v, "shape", None)
            out[k] = v[: max(shape[0] // 2, 1)] if shape else v
        return out

    def _produce(self, index: int) -> None:
        """Every reader-side fault of ``index``, in the JAX package's
        order, BEFORE the item is yielded (the failing index is then
        start + items yielded)."""
        self._fire_hook(index)
        self._maybe_slow(index)
        self._maybe_hang(index)
        self._check_faults(index)

    # -- Dataset surface -----------------------------------------------

    def device_batches(self, requests, batch_size: int, device, start_batch: int = 0
                       ) -> Iterator[Dict[str, Any]]:
        """A resident scan's batches (device views), faults applied."""
        index = start_batch
        for batch in self._inner.device_batches(requests, batch_size, device,
                                                start_batch=start_batch):
            self._produce(index)
            yield self._maybe_corrupt(index, batch)
            index += 1

    def host_batches(self, requests, batch_size: int, start_batch: int = 0
                     ) -> Iterator[Dict[str, Any]]:
        """A streamed scan's host batches, faults applied (on the
        prefetch thread)."""
        index = start_batch
        for batch in self._inner.host_batches(requests, batch_size, start_batch=start_batch):
            self._produce(index)
            yield self._maybe_corrupt(index, batch)
            index += 1

    # the ordered ingest pool engages only on a dataset whose CLASS
    # declares support (a bare __getattr__ delegation would let the
    # engine reach the INNER planner and bypass every fault here), so the
    # wrapper declares it exactly when its inner dataset does, and wraps
    # each work item in its own fault surface
    @property
    def supports_parallel_ingest(self) -> bool:
        return bool(getattr(type(self._inner), "supports_parallel_ingest", False))

    def _check_decode_faults(self, index: int) -> None:
        """A dead worker: raised inside ``decode()`` on the pool worker
        that took the batch."""
        if index in self._decode_permanent:
            self.faults_fired.append(("decode_permanent", index))
            raise ValueError(f"injected worker decode error at batch {index}")
        remaining = self._decode_transient_remaining.get(index, 0)
        if remaining > 0:
            self._decode_transient_remaining[index] = remaining - 1
            self.faults_fired.append(("decode_transient", index))
            raise TransientScanError(
                f"injected worker death at batch {index} ({remaining - 1} more)"
            )

    def ingest_work_items(self, requests, batch_size: int, start_batch: int = 0):
        """The pool's twin of ``host_batches``: the reader-side faults
        fire before the item is yielded; corruption and the decode
        faults ride the item to the worker."""
        index = start_batch
        for item in self._inner.ingest_work_items(requests, batch_size, start_batch=start_batch):
            self._produce(index)
            yield _FaultyIngestItem(self, item)
            index += 1


class _FaultyIngestItem:
    """One wrapped work item: the decode faults (a dead worker,
    corruption) fire on whichever worker runs ``decode()``; ``commit``
    passes through."""

    __slots__ = ("_owner", "_item")

    def __init__(self, owner: FaultInjectingDataset, item: Any):
        self._owner = owner
        self._item = item

    @property
    def index(self) -> int:
        return self._item.index

    @property
    def width(self) -> int:
        return self._item.width

    @property
    def final(self) -> bool:
        return self._item.final

    @property
    def deferred(self):
        return self._item.deferred

    def decode(self):
        index = self._item.index
        self._owner._check_decode_faults(index)
        return self._owner._maybe_corrupt(index, self._item.decode())

    def commit(self, decoded):
        return self._item.commit(decoded)
