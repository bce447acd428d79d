"""Engine configuration for the PyTorch port.

Only the options that change where or how a run computes are carried
over from the JAX package's ``config.py``:

- ``accumulation_dtype`` — dtype of scalar *float* state accumulators
  ("float64" default). Per-element work runs in the column's native
  dtype and only the per-batch scalar results are cast into it; counts
  are always exact int64, and integral columns always widen per
  element to float64.
- ``batch_size`` — rows per fused-scan step. ``None`` means the engine
  default, ``min(rows, 2**21)``.
- ``device`` — where the engine runs. ``None`` means ``"cuda"``: a run
  with no GPU raises instead of continuing on the CPU. Pass ``"cpu"``
  (here or to ``AnalysisEngine``) to run on the host.

Set options with :func:`set_option` or the :func:`configure` context
manager.
"""

from __future__ import annotations

import contextlib
import functools
import threading
from dataclasses import dataclass, replace
from typing import Iterator, Optional

import torch


@dataclass
class Options:
    # dtype for scalar state accumulators ("float64" | "float32")
    accumulation_dtype: str = "float64"
    # rows per fused-scan batch (None = engine default)
    batch_size: Optional[int] = None
    # engine device ("cuda", "cuda:N" or "cpu"); None = "cuda"
    device: Optional[str] = None

    def accumulation_float(self) -> torch.dtype:
        if self.accumulation_dtype == "float64":
            return torch.float64
        if self.accumulation_dtype == "float32":
            return torch.float32
        raise ValueError(
            "accumulation_dtype must be 'float64' or 'float32', got "
            f"{self.accumulation_dtype!r}"
        )


_lock = threading.Lock()
_options = Options()


def options() -> Options:
    return _options


def set_option(**kwargs) -> None:
    global _options
    with _lock:
        _options = replace(_options, **kwargs)


@contextlib.contextmanager
def configure(**kwargs) -> Iterator[Options]:
    """Temporarily override options within a block."""
    global _options
    with _lock:
        prev = _options
        _options = replace(_options, **kwargs)
    try:
        yield _options
    finally:
        with _lock:
            _options = prev


def resolve_device(device=None) -> torch.device:
    """The device a run uses: the explicit argument, else
    ``options().device``, else ``"cuda"``. A CUDA device without a
    usable GPU raises — a run never falls back to the CPU unless the
    caller asked for it."""
    if device is None:
        device = _options.device
    resolved = torch.device("cuda" if device is None else device)
    if resolved.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "deequ_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the host"
        )
    if resolved.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {resolved}")
    return resolved


def sm_count(device: torch.device) -> int:
    """The streaming multiprocessors of a CUDA device, read from the
    CUDA runtime once per device: the kernels' launch paths size their grids
    by it on every call."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    return _sm_count(index)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count
