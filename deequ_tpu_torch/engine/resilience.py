"""Batch-level fault domains for the fused scan.

Counterpart of ``deequ_tpu/engine/resilience.py``. The reference deequ
inherits Spark's task retry: a lost partition is recomputed and the
aggregation never notices. The port drives its own scan loop, so each
source batch is a fault domain of its own:

- :class:`RetryPolicy` — per-batch retry with exponential backoff and
  DETERMINISTIC jitter (a seeded hash of (batch, attempt), never
  ``random``), and an injectable ``sleep`` so tests wait no wall time.
  ``config.scan_retry`` holds the active policy.
- transient or deterministic: IO and transfer errors
  (:class:`TransientScanError`, ``OSError`` and its timeout and
  connection subclasses) are retried; decode and shape errors are not.
  Allocation failures are a third class (``engine/memory.py``): they
  are not transient (the same batch at the same size fails again), so
  the scan answers them with the adaptive batch backoff, and only its
  terminal ``BackoffExhausted`` reaches the quarantine here.
- :class:`ScanDegradation` — what a degraded scan lost: rows skipped,
  batches quarantined, error classes, one :class:`BatchFailure` a
  quarantined batch. It rides ``AnalyzerContext`` and
  ``VerificationResult``; ``config.degradation_policy`` maps it onto a
  verification status.
- :func:`resilient_batches` — the loop the scans pull their batches from:
  yields ``(index, item)``, rebuilds the source from the failing index
  on a transient error (a generator that raised is dead, so sources
  take ``start_batch``) and quarantines a batch that exhausts its
  attempts or fails deterministically.
- :class:`ScanKilled` — the fault harness's stand-in for process death.
  A ``BaseException`` ON PURPOSE: the retry and quarantine machinery
  catches ``Exception`` only, so a kill unwinds the whole scan as a
  real SIGKILL would, leaving a checkpoint as the only survivor.

Monoid states make this safe: a quarantined batch never enters the
fold, and a spill collector's unwritten buffer slots count as
sentinels.
"""

from __future__ import annotations

import hashlib
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

from deequ_tpu_torch.telemetry import get_telemetry


class TransientScanError(Exception):
    """A source error worth retrying (flaky IO, a throttled read, a
    transfer hiccup): the policy backs off and reads the batch again."""


class BatchIntegrityError(Exception):
    """A batch arrived structurally wrong (short arrays). Deterministic
    by definition, so it is quarantined at once, never retried."""


class ScanKilled(BaseException):
    """Deterministic stand-in for process death (the fault harness's
    ``kill_at_batch``). A ``BaseException`` so that no ``except
    Exception`` of the retry path swallows it."""


class ScanStalled(TransientScanError):
    """A batch exceeded the run's per-batch stall limit
    (``RunBudget.stall_s``), noticed by the deadline supervisor
    (``engine/deadline.py``). Transient ON PURPOSE: a stall is retried
    and quarantined once it keeps stalling."""


#: exception types the retry policy treats as transient (TimeoutError
#: and ConnectionError are OSError subclasses, listed for the reader)
TRANSIENT_ERROR_TYPES: Tuple[type, ...] = (
    TransientScanError,
    OSError,
    TimeoutError,
    ConnectionError,
)


def is_transient(exc: BaseException) -> bool:
    return isinstance(exc, TRANSIENT_ERROR_TYPES)


@dataclass(frozen=True)
class RetryPolicy:
    """Per-batch retry with exponential backoff and deterministic jitter.

    ``delay_s(batch_index, attempt)`` is a pure function of the policy
    and its arguments (the jitter is a seeded hash), so a retried run is
    reproducible and equals the JAX package's delays. ``sleep`` is
    injectable (None means ``time.sleep``)."""

    max_attempts: int = 3
    backoff_base_s: float = 0.05
    backoff_multiplier: float = 2.0
    backoff_max_s: float = 2.0
    jitter: float = 0.25  # +/- fraction of the deterministic delay
    seed: int = 0
    sleep: Optional[Callable[[float], None]] = None

    def delay_s(self, batch_index: int, attempt: int) -> float:
        """Backoff before retry number ``attempt`` (1-based) of a batch."""
        base = min(
            self.backoff_base_s * self.backoff_multiplier ** (attempt - 1),
            self.backoff_max_s,
        )
        if not self.jitter:
            return base
        digest = hashlib.blake2b(
            f"{self.seed}:{batch_index}:{attempt}".encode(), digest_size=8
        ).digest()
        frac = int.from_bytes(digest, "big") / 2.0**64  # [0, 1)
        return base * (1.0 + self.jitter * (2.0 * frac - 1.0))

    def sleep_for(self, seconds: float) -> None:
        (self.sleep or time.sleep)(seconds)


@dataclass
class BatchFailure:
    """One quarantined batch (the error as strings, so the record
    pickles into checkpoints and JSON)."""

    batch_index: int
    rows: int
    error_class: str
    message: str
    attempts: int

    def to_dict(self) -> Dict[str, Any]:
        return {
            "batch_index": self.batch_index,
            "rows": self.rows,
            "error_class": self.error_class,
            "message": self.message,
            "attempts": self.attempts,
        }


@dataclass
class ScanDegradation:
    """What a degraded scan lost, and why. ``rows_skipped`` is the exact
    row count of the quarantined batches, so a consumer can bound a
    metric's error (skipped over total rows)."""

    batches_quarantined: int = 0
    rows_skipped: int = 0
    retries: int = 0
    failures: List[BatchFailure] = field(default_factory=list)

    @property
    def is_degraded(self) -> bool:
        return self.batches_quarantined > 0

    @property
    def error_classes(self) -> List[str]:
        return sorted({f.error_class for f in self.failures})

    def record_quarantine(
        self, batch_index: int, rows: int, exc: BaseException, attempts: int
    ) -> None:
        self.batches_quarantined += 1
        self.rows_skipped += int(rows)
        self.failures.append(
            BatchFailure(
                batch_index=int(batch_index),
                rows=int(rows),
                error_class=type(exc).__name__,
                message=str(exc)[:500],
                attempts=int(attempts),
            )
        )
        tm = get_telemetry()
        tm.counter("engine.batches_quarantined").inc()
        tm.event("batch_quarantined", batch_index=int(batch_index), rows=int(rows),
                 error_class=type(exc).__name__, attempts=int(attempts))

    def record_retry(self) -> None:
        self.retries += 1
        get_telemetry().counter("engine.batch_retries").inc()

    def merge(self, other: Optional["ScanDegradation"]) -> "ScanDegradation":
        if other is None:
            return self
        return ScanDegradation(
            batches_quarantined=self.batches_quarantined + other.batches_quarantined,
            rows_skipped=self.rows_skipped + other.rows_skipped,
            retries=self.retries + other.retries,
            failures=self.failures + other.failures,
        )

    @staticmethod
    def merge_optional(
        a: Optional["ScanDegradation"], b: Optional["ScanDegradation"]
    ) -> Optional["ScanDegradation"]:
        if a is None:
            return b
        return a.merge(b)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "batches_quarantined": self.batches_quarantined,
            "rows_skipped": self.rows_skipped,
            "retries": self.retries,
            "error_classes": self.error_classes,
            "failures": [f.to_dict() for f in self.failures],
        }


def retry_transient(
    fn: Callable[[], Any],
    policy: RetryPolicy,
    batch_index: int,
    degradation: ScanDegradation,
):
    """Run ``fn``, retrying TRANSIENT failures per the policy (a stage
    that needs no source rebuild). Deterministic errors and exhaustion
    re-raise: the caller decides between quarantine and abort."""
    attempts = 0
    while True:
        try:
            return fn()
        except Exception as exc:  # noqa: BLE001 — classified below
            attempts += 1
            if is_transient(exc) and attempts < policy.max_attempts:
                degradation.record_retry()
                policy.sleep_for(policy.delay_s(batch_index, attempts))
                continue
            raise


def resilient_batches(
    make_iter: Callable[[int], Iterator[Any]],
    policy: RetryPolicy,
    degradation: ScanDegradation,
    rows_for: Callable[[int], int],
    start: int = 0,
    validate: Optional[Callable[[int, Any], None]] = None,
    close: Optional[Callable[[Iterator[Any]], None]] = None,
) -> Iterator[Tuple[int, Any]]:
    """Yield ``(index, item)`` from ``make_iter(start)`` with one fault
    domain an item.

    A generator that raised is dead, so a retry builds the source again
    from the failing index (``make_iter`` is a factory over a start
    index); ``close(it)`` tears the old source down first (its threads
    joined, its copies waited on), or ``it.close()`` without one:

    - transient error, attempts left: back off (deterministic delay,
      injectable sleep) and rebuild from the same index;
    - transient exhaustion or a deterministic error: quarantine the item
      (recorded with its exact row count) and rebuild from the next;
    - ``validate(index, item)`` raising: corruption, quarantined WITHOUT
      a rebuild (the source itself is still good);
    - ``ScanKilled`` and every other ``BaseException``: never caught
      here; the source is torn down and the exception unwinds the scan.

    The failing index is always ``start + items already yielded``: the
    prefetch queue is FIFO, so an error raised on a prefetch thread
    surfaces in source order."""
    def teardown(source) -> None:
        if close is not None:
            close(source)
        elif hasattr(source, "close"):
            source.close()

    index = start
    attempts = 0
    it = make_iter(index)
    try:
        while True:
            try:
                item = next(it)
            except StopIteration:
                return
            except Exception as exc:  # noqa: BLE001 — classified below
                attempts += 1
                teardown(it)
                if is_transient(exc) and attempts < policy.max_attempts:
                    degradation.record_retry()
                    policy.sleep_for(policy.delay_s(index, attempts))
                else:
                    degradation.record_quarantine(index, rows_for(index), exc, attempts)
                    attempts = 0
                    index += 1
                it = make_iter(index)
                continue
            if validate is not None:
                try:
                    validate(index, item)
                except Exception as exc:  # noqa: BLE001 — the corruption path
                    degradation.record_quarantine(index, rows_for(index), exc, 1)
                    attempts = 0
                    index += 1
                    continue
            attempts = 0
            yield index, item
            index += 1
    finally:
        teardown(it)
