"""Per-column scatter-max of HLL ranks into register files.

``scatter_max(idx, rho, m)`` computes, for (C, B) int32 ``idx`` and
``rho``, the (C, m) int32 registers ``reg[c, k] = max(rho[c, i] for
idx[c, i] == k)`` over a zeroed file. It replaces the JAX package's
Pallas kernel (``deequ_tpu/sketches/pallas_scatter.py::_make_call``)
and the XLA scatter beside it; all three are bit-identical, since max
is commutative and masked rows arrive as the no-op (0, 0).

- A CUDA tensor goes to the hand-written Hopper kernel
  (``csrc/scatter_max.cu``), built at first use. A launch that fails
  raises; there is no fallback.
- A CPU tensor goes to :func:`scatter_max_plain`, the plain PyTorch
  version, which the tests and ``chip_smoke.py`` hold the kernel
  against.

``launches`` counts kernel launches, so a run can show that it went
through the kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from deequ_tpu_torch.utils import cuda_build

SOURCE = cuda_build.CSRC_DIR / "scatter_max.cu"

# ranks are packed below 6 bits by the JAX package's kernel; HLL ranks
# are <= 33
RHO_LIMIT = 64
# one int32 register file per block lives in shared memory
MAX_REGISTERS = 1 << 14
THREADS = 512
BLOCKS_PER_SM = 2
# a block should scan at least as many rows as it has registers to
# zero and fold
MIN_ROWS_PER_BLOCK = MAX_REGISTERS

launches = 0


def scatter_max_plain(idx: torch.Tensor, rho: torch.Tensor, m: int) -> torch.Tensor:
    """The plain PyTorch version: one flat ``scatter_reduce_("amax")``
    into a zeroed (C*m,) file, on whatever device the inputs are."""
    cols = idx.shape[0]
    col_base = torch.arange(cols, dtype=torch.int64, device=idx.device)[:, None] * m
    flat = (col_base + idx.to(torch.int64)).reshape(-1)
    out = torch.zeros(cols * m, dtype=torch.int32, device=idx.device)
    return out.scatter_reduce_(0, flat, rho.reshape(-1), "amax").reshape(cols, m)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = cuda_build.load_library(SOURCE)
    lib.hll_scatter_max_launch.argtypes = [
        ctypes.c_void_p,  # idx
        ctypes.c_void_p,  # rho
        ctypes.c_void_p,  # out
        ctypes.c_int,  # cols
        ctypes.c_longlong,  # rows
        ctypes.c_int,  # m
        ctypes.c_int,  # splits
        ctypes.c_int,  # threads
        ctypes.c_void_p,  # stream
    ]
    lib.hll_scatter_max_launch.restype = ctypes.c_int
    lib.hll_cuda_error_string.argtypes = [ctypes.c_int]
    lib.hll_cuda_error_string.restype = ctypes.c_char_p
    return lib


def build() -> None:
    """Build and load the kernel's library now (it is otherwise built
    at the first launch)."""
    _library()


def _check_args(idx: torch.Tensor, rho: torch.Tensor, m: int) -> None:
    """Raise on anything the kernel does not take, before any launch."""
    for name, t in (("idx", idx), ("rho", rho)):
        if t.dtype != torch.int32:
            raise TypeError(f"scatter_max: {name} must be int32, got {t.dtype}")
        if t.dim() != 2:
            raise ValueError(
                f"scatter_max: {name} must be (C, B), got shape {tuple(t.shape)}"
            )
        if not t.is_contiguous():
            raise ValueError(f"scatter_max: {name} must be contiguous")
        if t.device.type not in ("cpu", "cuda"):
            raise ValueError(f"scatter_max: unsupported device {t.device}")
    if idx.shape != rho.shape:
        raise ValueError(
            f"scatter_max: idx {tuple(idx.shape)} and rho {tuple(rho.shape)} "
            "differ in shape"
        )
    if idx.device != rho.device:
        raise ValueError(
            f"scatter_max: idx on {idx.device} but rho on {rho.device}"
        )
    if not 1 <= m <= MAX_REGISTERS:
        raise ValueError(f"scatter_max: m must be in [1, {MAX_REGISTERS}], got {m}")
    if idx.numel():
        bounds = torch.stack(
            [idx.min(), idx.max(), rho.min(), rho.max()]
        ).tolist()
        if bounds[0] < 0 or bounds[1] >= m:
            raise ValueError(
                f"scatter_max: idx must lie in [0, {m}), found "
                f"[{bounds[0]}, {bounds[1]}]"
            )
        if bounds[2] < 0 or bounds[3] >= RHO_LIMIT:
            raise ValueError(
                f"scatter_max: rho must lie in [0, {RHO_LIMIT}), found "
                f"[{bounds[2]}, {bounds[3]}]"
            )


def _splits(cols: int, rows: int, device: torch.device) -> int:
    """Blocks per column: enough for BLOCKS_PER_SM blocks on every SM,
    but none that would scan fewer than MIN_ROWS_PER_BLOCK rows."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    want = -(-BLOCKS_PER_SM * sms // cols)
    return max(1, min(want, -(-rows // MIN_ROWS_PER_BLOCK)))


def _launch(idx: torch.Tensor, rho: torch.Tensor, m: int) -> torch.Tensor:
    global launches
    cols, rows = idx.shape
    out = torch.zeros((cols, m), dtype=torch.int32, device=idx.device)
    if cols == 0 or rows == 0:
        return out
    lib = _library()
    with torch.cuda.device(idx.device):
        err = lib.hll_scatter_max_launch(
            idx.data_ptr(),
            rho.data_ptr(),
            out.data_ptr(),
            cols,
            rows,
            m,
            _splits(cols, rows, idx.device),
            THREADS,
            torch.cuda.current_stream(idx.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            "scatter_max kernel launch failed: "
            f"{lib.hll_cuda_error_string(err).decode()} (cudaError {err})"
        )
    launches += 1
    return out


def scatter_max(idx: torch.Tensor, rho: torch.Tensor, m: int) -> torch.Tensor:
    """(C, B) int32 idx in [0, m) and rho in [0, 64) -> (C, m) int32
    registers: the Hopper kernel for CUDA tensors, the plain version for
    CPU tensors."""
    _check_args(idx, rho, m)
    if idx.device.type == "cuda":
        return _launch(idx, rho, m)
    return scatter_max_plain(idx, rho, m)
