"""Memory-pressure classification and adaptive batch backoff.

Counterpart of ``deequ_tpu/engine/memory.py``. The reference deequ
leaves out-of-memory survival to Spark, which reschedules a task that
ran out; the port drives its own scan on one device, so:

- :func:`classify_memory_pressure` — the ONE place an allocation
  failure is recognised and mapped onto :class:`MemoryPressureError`.
  PyTorch's own out-of-memory error (``torch.OutOfMemoryError``, a
  ``RuntimeError`` whose class name is not ``RuntimeError``) is matched
  by CLASS; a kernel launch error of this package
  (``sketches/scatter_max.py::_raise_on``, "... (cudaError N)") by its
  CUDA error code, memory pressure only for ``cudaErrorMemoryAllocation``;
  a host ``MemoryError`` is host pressure; and the JAX package's message
  markers still apply to other ``RuntimeError``\\ s and to the fault
  harness's simulated error. Any other CUDA or kernel error is not
  memory pressure: :func:`is_device_fault` names it, and the run fails.
- :class:`MemoryPressureError` — its own family, apart from the
  transient and deterministic errors of ``engine/resilience.py``: the
  same allocation at the same size fails again (not transient), but a
  smaller one usually succeeds (not a corrupt batch either). The scan
  answers it with :class:`AdaptiveBatchBackoff`; only an allocation that
  still fails at ``config.min_batch_rows`` is quarantined.
- :class:`AdaptiveBatchBackoff` — the effective batch size: halved down
  to ``min_rows`` on each OOM, doubled back after ``heal_after``
  consecutive clean batches (0 disables healing).
- :class:`SimulatedResourceExhausted` and :func:`simulated_device_oom` —
  the fault harness's stand-in (``testing/faults.py``), whose message is
  classified like a live one, with no allocation at all.

The JAX package's telemetry counters and events beside these records
wait for the port's telemetry.
"""

from __future__ import annotations

import re
from typing import Any, Optional

import torch


class MemoryPressureError(Exception):
    """A device or host allocation failure, classified. ``origin`` is
    ``"device"`` or ``"host"``."""

    def __init__(self, message: str, origin: str = "device"):
        super().__init__(message)
        self.origin = origin


class BackoffExhausted(MemoryPressureError):
    """The allocation still failed at ``min_rows``: nothing is left to
    shrink, and the scan quarantines the rest of the batch."""


class SimulatedResourceExhausted(Exception):
    """Test stand-in for a device out-of-memory error: the JAX runtime's
    message shape, no real allocation."""


def simulated_device_oom(rows: int = 0, where: str = "dispatch"):
    """An exception shaped like a device OOM (classified by message)."""
    return SimulatedResourceExhausted(
        "RESOURCE_EXHAUSTED: Out of memory while trying to allocate "
        f"{max(int(rows), 1) * 8} bytes (injected at {where})"
    )


# message markers of a runtime allocation failure, matched only for the
# runtime exception types below (the JAX package's list)
_OOM_MARKERS = (
    "RESOURCE_EXHAUSTED",
    "Out of memory",
    "out of memory",
    "Resource exhausted",
    "Failed to allocate",
)
_RUNTIME_TYPE_NAMES = ("XlaRuntimeError", "RuntimeError")
# cudaErrorMemoryAllocation, the one CUDA error that is memory pressure
CUDA_ERROR_MEMORY_ALLOCATION = 2
# what _raise_on appends to a kernel's launch error
_KERNEL_ERROR = re.compile(r"kernel launch failed: .*\(cudaError (\d+)\)$", re.S)


def _cuda_error_code(exc: BaseException) -> Optional[int]:
    """The CUDA error code of one of this package's kernel launch
    errors, else None."""
    if not isinstance(exc, RuntimeError):
        return None
    match = _KERNEL_ERROR.search(str(exc))
    return int(match.group(1)) if match else None


def is_device_fault(exc: BaseException) -> bool:
    """Whether ``exc`` is a CUDA or kernel error that is NOT memory
    pressure (an illegal address, too many resources for a launch, ...):
    such a run fails; nothing retries, quarantines or answers it on the
    host."""
    if classify_memory_pressure(exc) is not None:
        return False
    if _cuda_error_code(exc) is not None:
        return True
    accelerator_error = getattr(torch, "AcceleratorError", None)
    if accelerator_error is not None and isinstance(exc, accelerator_error):
        return True
    return isinstance(exc, RuntimeError) and str(exc).startswith("CUDA error")


def classify_memory_pressure(exc: BaseException) -> Optional[MemoryPressureError]:
    """``exc`` as a :class:`MemoryPressureError`, or None when it is not
    an allocation failure. The single classification point of the
    package."""
    if isinstance(exc, MemoryPressureError):
        return exc
    if isinstance(exc, MemoryError):
        pressure = MemoryPressureError(f"host allocation failed: {exc}", origin="host")
        pressure.__cause__ = exc
        return pressure
    if isinstance(exc, torch.OutOfMemoryError):
        pressure = MemoryPressureError(str(exc), origin="device")
        pressure.__cause__ = exc
        return pressure
    code = _cuda_error_code(exc)
    if code is not None:
        if code != CUDA_ERROR_MEMORY_ALLOCATION:
            return None
        pressure = MemoryPressureError(str(exc), origin="device")
        pressure.__cause__ = exc
        return pressure
    if isinstance(exc, SimulatedResourceExhausted) or type(exc).__name__ in _RUNTIME_TYPE_NAMES:
        message = str(exc)
        if any(marker in message for marker in _OOM_MARKERS):
            pressure = MemoryPressureError(message, origin="device")
            pressure.__cause__ = exc
            return pressure
    return None


def record_spill_downgrade(events, stage: str, columns, path: str) -> None:
    """Record one memory-pressure downgrade of a spill plan (collector
    -> deferred re-read -> host group-by) as a ``scan_memory_pressure``
    event, when the caller keeps events."""
    if events is not None:
        events.append({
            "event": "scan_memory_pressure", "action": "spill-downgrade",
            "stage": stage, "columns": list(columns), "path": path,
        })


class AdaptiveBatchBackoff:
    """The effective batch size of one scan.

    Starts at ``full`` (the scan's nominal batch size, which stays the
    checkpoint's identity: backoff is internal to a batch's update).
    ``shrink`` halves it down to ``min_rows``; ``note_clean`` doubles it
    back after ``heal_after`` consecutive clean batches (0 or less
    disables healing). ``align`` keeps sizes a multiple of it.
    ``backoffs`` and ``heals`` count the steps taken."""

    __slots__ = ("full", "min_rows", "heal_after", "align", "effective", "_clean",
                 "backoffs", "heals")

    def __init__(self, full_rows: int, min_rows: int, heal_after: int = 0, align: int = 1):
        self.full = max(1, int(full_rows))
        self.align = max(1, int(align))
        self.min_rows = min(self.full, max(self.align, int(min_rows)))
        self.heal_after = int(heal_after)
        self.effective = self.full
        self._clean = 0
        self.backoffs = 0
        self.heals = 0

    @property
    def active(self) -> bool:
        return self.effective < self.full

    def _aligned(self, rows: int) -> int:
        return max(self.align, (rows // self.align) * self.align)

    def shrink(self) -> bool:
        """Halve the effective size after an OOM; False when it is
        already at the floor (the caller quarantines)."""
        if self.effective <= self.min_rows:
            return False
        self.effective = max(self.min_rows, self._aligned(self.effective // 2))
        self._clean = 0
        self.backoffs += 1
        return True

    def note_clean(self) -> bool:
        """One batch finished without an OOM; True when that healed
        (doubled) the size."""
        if self.effective >= self.full or self.heal_after <= 0:
            return False
        self._clean += 1
        if self._clean < self.heal_after:
            return False
        self._clean = 0
        self.effective = min(self.full, self._aligned(self.effective * 2))
        self.heals += 1
        return True


def make_backoff(batch_size: int, align: int = 1) -> Optional[AdaptiveBatchBackoff]:
    """The configured backoff of one scan, or None when
    ``config.memory_backoff`` is off (an update's OOM then fails the
    scan)."""
    from deequ_tpu_torch import config

    opts = config.options()
    if not opts.memory_backoff:
        return None
    return AdaptiveBatchBackoff(
        batch_size, opts.min_batch_rows, heal_after=opts.memory_heal_after_batches, align=align
    )


def oom_probe_of(dataset: Any):
    """The dataset's fault-injection probe (``testing/faults.py``
    attaches one; real datasets have none). The engine calls
    ``probe(stage, index, rows)`` inside its guarded stages, so an
    injected OOM takes the path of a live one."""
    return getattr(dataset, "oom_probe", None)
