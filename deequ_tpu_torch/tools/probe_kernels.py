"""The scatter probe's three register scatter-max kernels and their
plain versions.

Counterparts of the Pallas kernels of the JAX package's probe tool
(``tools/scatter_probe.py``), each over ONE column of B rows into M
int32 registers:

- P1 :func:`scatter_two_stream` — idx and rho as two int32 streams
  (``make_pallas_two_stream``);
- P2 :func:`scatter_packed` — one stream of packed ``idx << 6 | rho``
  words (``make_pallas_packed``);
- P3 :func:`scatter_gmin` — packed words into warm registers, skipping
  every element whose rank is at or below ``min(regs)``
  (``make_pallas_gmin``).

Each returns ``max(regs, scatter)``, as the Pallas wrappers do. The
kernels are hand-written for Hopper (``csrc/scatter_probe.cu``) and
built at first use. As with ``sketches/scatter_max.py``:

- ``_check_args`` raises on anything the kernel does not take, before
  any launch;
- a CUDA tensor goes to the kernel, and a launch that fails raises;
- a CPU tensor goes to the plain version beside the kernel;
- ``launches`` counts each kernel's launches, by id.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional

import torch

from deequ_tpu_torch.sketches.scatter_max import (
    MAX_REGISTERS,
    RHO_LIMIT,
    THREADS,
    _splits,
)
from deequ_tpu_torch.utils import cuda_build

SOURCE = cuda_build.CSRC_DIR / "scatter_probe.cu"
RHO_BITS = 6  # packed words are idx << 6 | rho

launches: Dict[str, int] = {"P1": 0, "P2": 0, "P3": 0}


# -- plain versions ---------------------------------------------------------


def pack(idx: torch.Tensor, rho: torch.Tensor) -> torch.Tensor:
    """Packed words ``idx << 6 | rho`` (int32), as the Pallas wrappers
    pack them."""
    return (idx << RHO_BITS) | rho


def unpack(packed: torch.Tensor):
    """(idx, rho) of packed words."""
    return packed >> RHO_BITS, packed & (RHO_LIMIT - 1)


def two_stream_plain(idx: torch.Tensor, rho: torch.Tensor, m: int) -> torch.Tensor:
    """P1's plain version: one ``scatter_reduce_("amax")`` into a zeroed
    (m,) file, on whatever device the inputs are."""
    out = torch.zeros(m, dtype=torch.int32, device=idx.device)
    return out.scatter_reduce_(0, idx.to(torch.int64), rho, "amax")


def packed_plain(packed: torch.Tensor, m: int) -> torch.Tensor:
    """P2's plain version: unpack, then P1's."""
    idx, rho = unpack(packed)
    return two_stream_plain(idx, rho, m)


def gmin_plain(regs_in: torch.Tensor, packed: torch.Tensor) -> torch.Tensor:
    """P3's plain version: ``max(regs_in, P2's plain version)``."""
    return torch.maximum(regs_in, packed_plain(packed, regs_in.shape[0]))


# -- the kernels ------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = cuda_build.load_library(SOURCE)
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    signatures = {
        # idx, rho, out, rows, m, skip, splits, threads, stream
        "probe_two_stream_launch": [ptr, ptr, ptr, i64, i32, i32, i32, i32, ptr],
        # packed, out, rows, m, skip, vec, splits, threads, stream
        "probe_packed_launch": [ptr, ptr, i64, i32, i32, i32, i32, i32, ptr],
        # regs_in, packed, out, rows, m, vec, splits, threads, stream
        "probe_gmin_launch": [ptr, ptr, ptr, i64, i32, i32, i32, i32, ptr],
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.probe_cuda_error_string.argtypes = [ctypes.c_int]
    lib.probe_cuda_error_string.restype = ctypes.c_char_p
    return lib


def build() -> None:
    """Build and load the kernels' library now (it is otherwise built
    at the first launch)."""
    _library()


def _raise_on(err: int, kernel: str) -> None:
    if err != 0:
        raise RuntimeError(
            f"{kernel} kernel launch failed: "
            f"{_library().probe_cuda_error_string(err).decode()} (cudaError {err})"
        )


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _aligned16(t: torch.Tensor) -> int:
    return int(t.data_ptr() % 16 == 0)


def _launch_two_stream(idx, rho, m: int, skip_cold: bool) -> torch.Tensor:
    out = torch.zeros(m, dtype=torch.int32, device=idx.device)
    rows = idx.shape[0]
    if rows == 0:
        return out
    with torch.cuda.device(idx.device):
        err = _library().probe_two_stream_launch(
            idx.data_ptr(), rho.data_ptr(), out.data_ptr(), rows, m,
            int(skip_cold), _splits(1, rows, idx.device), THREADS, _stream(idx),
        )
    _raise_on(err, "P1 two_stream")
    launches["P1"] += 1
    return out


def _launch_packed(packed, m: int, skip_cold: bool, vec: bool) -> torch.Tensor:
    out = torch.zeros(m, dtype=torch.int32, device=packed.device)
    rows = packed.shape[0]
    if rows == 0:
        return out
    with torch.cuda.device(packed.device):
        err = _library().probe_packed_launch(
            packed.data_ptr(), out.data_ptr(), rows, m, int(skip_cold),
            int(vec) & _aligned16(packed), _splits(1, rows, packed.device),
            THREADS, _stream(packed),
        )
    _raise_on(err, "P2 packed")
    launches["P2"] += 1
    return out


def _launch_gmin(regs_in, packed, vec: bool) -> torch.Tensor:
    out = regs_in.clone()
    rows, m = packed.shape[0], regs_in.shape[0]
    if rows == 0:
        return out
    with torch.cuda.device(packed.device):
        err = _library().probe_gmin_launch(
            regs_in.data_ptr(), packed.data_ptr(), out.data_ptr(), rows, m,
            int(vec) & _aligned16(packed), _splits(1, rows, packed.device),
            THREADS, _stream(packed),
        )
    _raise_on(err, "P3 gmin")
    launches["P3"] += 1
    return out


# -- argument checks --------------------------------------------------------


def _check_vector(name: str, t: torch.Tensor, dtype=torch.int32) -> None:
    if t.dtype != dtype:
        raise TypeError(f"probe kernels: {name} must be {dtype}, got {t.dtype}")
    if t.dim() != 1:
        raise ValueError(
            f"probe kernels: {name} must be 1-D, got shape {tuple(t.shape)}"
        )
    if not t.is_contiguous():
        raise ValueError(f"probe kernels: {name} must be contiguous")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"probe kernels: unsupported device {t.device}")


def _check_range(name: str, t: torch.Tensor, lo: int, hi: int) -> None:
    if t.numel():
        found = torch.stack([t.min(), t.max()]).tolist()
        if found[0] < lo or found[1] >= hi:
            raise ValueError(
                f"probe kernels: {name} must lie in [{lo}, {hi}), found "
                f"[{found[0]}, {found[1]}]"
            )


def _check_args(
    regs: torch.Tensor,
    idx: Optional[torch.Tensor] = None,
    rho: Optional[torch.Tensor] = None,
    packed: Optional[torch.Tensor] = None,
) -> None:
    """Raise on anything the kernels do not take, before any launch:
    int32, 1-D, contiguous, one device, regs of at most MAX_REGISTERS,
    idx in [0, M) and rho in [0, 64), unpacked or packed."""
    streams = {"idx": idx, "rho": rho, "packed": packed}
    given = {k: v for k, v in streams.items() if v is not None}
    _check_vector("regs", regs)
    for name, t in given.items():
        _check_vector(name, t)
        if t.device != regs.device:
            raise ValueError(
                f"probe kernels: {name} on {t.device} but regs on {regs.device}"
            )
    m = regs.shape[0]
    if not 1 <= m <= MAX_REGISTERS:
        raise ValueError(
            f"probe kernels: regs must hold 1 to {MAX_REGISTERS} registers, got {m}"
        )
    if idx is not None and idx.shape != rho.shape:
        raise ValueError(
            f"probe kernels: idx {tuple(idx.shape)} and rho {tuple(rho.shape)} "
            "differ in shape"
        )
    if packed is not None:
        _check_range("packed words", packed, 0, m << RHO_BITS)
    else:
        _check_range("idx", idx, 0, m)
        _check_range("rho", rho, 0, RHO_LIMIT)


# -- the wrappers -----------------------------------------------------------


def scatter_two_stream(
    regs: torch.Tensor, idx: torch.Tensor, rho: torch.Tensor, skip_cold: bool = True
) -> torch.Tensor:
    """P1: ``max(regs, scatter(idx, rho))`` from two int32 streams."""
    _check_args(regs, idx=idx, rho=rho)
    m = regs.shape[0]
    if regs.device.type == "cuda":
        return torch.maximum(regs, _launch_two_stream(idx, rho, m, skip_cold))
    return torch.maximum(regs, two_stream_plain(idx, rho, m))


def scatter_packed(
    regs: torch.Tensor, packed: torch.Tensor, skip_cold: bool = True, vec: bool = True
) -> torch.Tensor:
    """P2: ``max(regs, scatter(unpack(packed)))``; ``vec`` reads the
    words as int4 vectors where the stream is 16-byte aligned."""
    _check_args(regs, packed=packed)
    m = regs.shape[0]
    if regs.device.type == "cuda":
        return torch.maximum(regs, _launch_packed(packed, m, skip_cold, vec))
    return torch.maximum(regs, packed_plain(packed, m))


def scatter_gmin(
    regs: torch.Tensor, packed: torch.Tensor, vec: bool = True
) -> torch.Tensor:
    """P3: ``max(regs, scatter(unpack(packed)))`` with the warm-register
    gate: elements with rank <= min(regs) skip the register update."""
    _check_args(regs, packed=packed)
    if regs.device.type == "cuda":
        return _launch_gmin(regs, packed, vec)
    return gmin_plain(regs, packed)
