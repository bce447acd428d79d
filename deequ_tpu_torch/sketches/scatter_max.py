"""Per-column scatter-max of HLL ranks into register files: the two
entry points of K1.

Both replace the JAX package's Pallas kernel
(``deequ_tpu/sketches/pallas_scatter.py::_make_call``) and the XLA
scatter beside it; all are bit-identical, since max is commutative and
masked rows arrive as no-ops.

- ``scatter_max(idx, rho, m)`` computes, for (C, B) int32 ``idx`` and
  ``rho``, the (C, m) int32 registers ``reg[c, k] = max(rho[c, i] for
  idx[c, i] == k)`` over a zeroed file. It checks the ranges of idx and
  rho on the host. ``scatter_max_derived`` is the same entry for ranks
  made by ``hll_hash.index_and_rank``, whose ranges hold by
  construction: it reads nothing back to the host. The dictionary
  presence and LUT-gather paths of ``sketches/hll.py`` use it.
- ``hll_update(values, mask, row_mask, registers)`` is the fused
  update of numeric columns: raw (C, B) values in, ``max(registers,
  the batch's registers)`` out, as (C, M) int8. One kernel hashes,
  ranks and scatters; the wrapper reads nothing back to the host.

For each entry:

- a CUDA tensor goes to the hand-written Hopper kernel
  (``csrc/scatter_max.cu``), built at first use. A launch that fails
  raises; there is no fallback;
- a CPU tensor goes to the plain PyTorch version beside it
  (:func:`scatter_max_plain`, :func:`hll_update_plain`), which the
  tests and ``chip_smoke.py`` hold the kernel against.

``launches`` counts the (idx, rho) kernel's launches and
``fused_launches`` the fused kernel's, so a run can show which entry it
went through.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from deequ_tpu_torch import config
from deequ_tpu_torch.sketches import hll_hash
from deequ_tpu_torch.utils import cuda_build

SOURCE = cuda_build.CSRC_DIR / "scatter_max.cu"

# ranks are packed below 6 bits by the JAX package's kernel; HLL ranks
# are <= 33
RHO_LIMIT = 64
# one int32 register file per block lives in shared memory
MAX_REGISTERS = 1 << 14
THREADS = 512  # (idx, rho) kernel; the fused one fixes its own in the source
BLOCKS_PER_SM = 2
# a block should scan at least as many rows as it has registers to
# zero and fold
MIN_ROWS_PER_BLOCK = MAX_REGISTERS

# the fused entry reads these value dtypes as they are (the launch's
# dtype code), and widens the others to int64 first, as the JAX package
# hashes them
FUSED_DTYPES = {torch.int64: 0, torch.int32: 1, torch.float64: 2, torch.float32: 3}
WIDENED_DTYPES = (torch.bool, torch.uint8, torch.int8, torch.int16)

launches = 0
fused_launches = 0


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
    lib.hll_update_launch.argtypes = [
        ctypes.c_void_p,  # values
        ctypes.c_int,  # dtype code
        ctypes.c_void_p,  # mask
        ctypes.c_void_p,  # row_mask (null: none)
        ctypes.c_void_p,  # registers_in
        ctypes.c_void_p,  # out
        ctypes.c_int,  # cols
        ctypes.c_longlong,  # rows
        ctypes.c_int,  # p
        ctypes.c_int,  # vec
        ctypes.c_int,  # splits
        ctypes.c_void_p,  # stream
    ]
    lib.hll_update_launch.restype = ctypes.c_int
    lib.hll_update_blocks_per_sm.argtypes = []
    lib.hll_update_blocks_per_sm.restype = ctypes.c_int
    lib.hll_cuda_error_string.argtypes = [ctypes.c_int]
    lib.hll_cuda_error_string.restype = ctypes.c_char_p
    return lib


def build() -> None:
    """Build and load the kernel's library now (it is otherwise built
    at the first launch)."""
    _library()


def _check_args(idx: torch.Tensor, rho: torch.Tensor, m: int) -> None:
    """Raise on anything the kernel does not take, before any launch:
    the layout, then the idx/rho ranges (read back to the host)."""
    _check_layout(idx, rho, m)
    _check_ranges(idx, rho, m)


def _check_layout(idx: torch.Tensor, rho: torch.Tensor, m: int) -> None:
    """dtype, shape, contiguity, device and m: nothing that reads the
    device."""
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


def _check_ranges(idx: torch.Tensor, rho: torch.Tensor, m: int) -> None:
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
    sms = config.sm_count(device)
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
    _raise_on(err, "scatter_max")
    launches += 1
    return out


def _raise_on(err: int, kernel: str) -> None:
    if err != 0:
        raise RuntimeError(
            f"{kernel} kernel launch failed: "
            f"{_library().hll_cuda_error_string(err).decode()} (cudaError {err})"
        )


def scatter_max(idx: torch.Tensor, rho: torch.Tensor, m: int) -> torch.Tensor:
    """(C, B) int32 idx in [0, m) and rho in [0, 64) -> (C, m) int32
    registers: the Hopper kernel for CUDA tensors, the plain version for
    CPU tensors."""
    _check_args(idx, rho, m)
    if idx.device.type == "cuda":
        return _launch(idx, rho, m)
    return scatter_max_plain(idx, rho, m)


def scatter_max_derived(idx: torch.Tensor, rho: torch.Tensor, m: int) -> torch.Tensor:
    """:func:`scatter_max` for idx and rho made by
    ``hll_hash.index_and_rank`` (idx in [0, M), rho in [0, 33] by
    construction): the layout is checked, the ranges are not, so the
    call reads nothing back to the host."""
    _check_layout(idx, rho, m)
    if idx.device.type == "cuda":
        return _launch(idx, rho, m)
    return scatter_max_plain(idx, rho, m)


# -- the fused entry ----------------------------------------------------------


def hll_update_plain(
    values: torch.Tensor,
    mask: torch.Tensor,
    row_mask: Optional[torch.Tensor],
    registers: torch.Tensor,
) -> torch.Tensor:
    """The fused update's plain version: hash, rank, scatter-max into a
    zeroed file, then the max with the carried registers, on whatever
    device the inputs are."""
    valid = mask if row_mask is None else mask & row_mask[None, :]
    h1, h2 = hll_hash.hash_pair_numeric(values)
    idx, rho = hll_hash.index_and_rank(h1, h2, valid)
    batch = scatter_max_plain(idx, rho, registers.shape[1]).to(registers.dtype)
    return torch.maximum(registers, batch)


def _check_update_args(
    values: torch.Tensor,
    mask: torch.Tensor,
    row_mask: Optional[torch.Tensor],
    registers: torch.Tensor,
) -> None:
    """Raise on anything the fused kernel does not take, before any
    launch. Reads nothing back from the device."""
    named = [("values", values), ("mask", mask), ("registers", registers)]
    if row_mask is not None:
        named.append(("row_mask", row_mask))
    for name, t in named:
        if t.device.type not in ("cpu", "cuda"):
            raise ValueError(f"hll_update: unsupported device {t.device}")
        if t.device != values.device:
            raise ValueError(f"hll_update: values on {values.device} but {name} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"hll_update: {name} must be contiguous")
    if values.dtype not in FUSED_DTYPES and values.dtype not in WIDENED_DTYPES:
        raise TypeError(f"hll_update: unsupported value dtype {values.dtype}")
    if values.dim() != 2 or values.shape[0] < 1:
        raise ValueError(
            f"hll_update: values must be (C, B) with C >= 1, got shape {tuple(values.shape)}"
        )
    cols, rows = values.shape
    if mask.dtype != torch.bool:
        raise TypeError(f"hll_update: mask must be bool, got {mask.dtype}")
    if mask.shape != values.shape:
        raise ValueError(
            f"hll_update: mask {tuple(mask.shape)} and values {tuple(values.shape)} "
            "differ in shape"
        )
    if row_mask is not None:
        if row_mask.dtype != torch.bool:
            raise TypeError(f"hll_update: row_mask must be bool, got {row_mask.dtype}")
        if row_mask.shape != (rows,):
            raise ValueError(
                f"hll_update: row_mask must be ({rows},), got {tuple(row_mask.shape)}"
            )
    if registers.dtype != hll_hash.REGISTER_DTYPE:
        raise TypeError(f"hll_update: registers must be int8, got {registers.dtype}")
    if registers.shape != (cols, hll_hash.M):
        raise ValueError(
            f"hll_update: registers must be ({cols}, {hll_hash.M}), got "
            f"{tuple(registers.shape)}"
        )


def _fused_splits(cols: int, rows: int, device: torch.device) -> int:
    """Blocks per column: the kernel's blocks per SM on every SM, in one
    wave, but none that would scan fewer than MIN_ROWS_PER_BLOCK rows
    (each block seeds and folds a whole register file)."""
    sms = config.sm_count(device)
    want = _library().hll_update_blocks_per_sm() * sms // cols
    return max(1, min(want, -(-rows // MIN_ROWS_PER_BLOCK)))


def _launch_update(
    values: torch.Tensor,
    mask: torch.Tensor,
    row_mask: Optional[torch.Tensor],
    registers: torch.Tensor,
    splits: Optional[int] = None,
) -> torch.Tensor:
    global fused_launches
    cols, rows = values.shape
    out = registers.clone()  # the kernel folds into a copy of the carry
    if rows == 0:
        return out
    width = 16 // values.element_size()  # values per 16-byte load
    vec = (
        rows % width == 0
        and values.data_ptr() % 16 == 0
        and mask.data_ptr() % width == 0
        and (row_mask is None or row_mask.data_ptr() % width == 0)
    )
    if splits is None:
        splits = _fused_splits(cols, rows, values.device)
    with torch.cuda.device(values.device):
        err = _library().hll_update_launch(
            values.data_ptr(),
            FUSED_DTYPES[values.dtype],
            mask.data_ptr(),
            None if row_mask is None else row_mask.data_ptr(),
            registers.data_ptr(),
            out.data_ptr(),
            cols,
            rows,
            hll_hash.P,
            int(vec),
            splits,
            torch.cuda.current_stream(values.device).cuda_stream,
        )
    _raise_on(err, "hll_update")
    fused_launches += 1
    return out


def hll_update(
    values: torch.Tensor,
    mask: torch.Tensor,
    row_mask: Optional[torch.Tensor],
    registers: torch.Tensor,
) -> torch.Tensor:
    """(C, B) numeric values, (C, B) bool mask, an optional (B,) bool row
    mask ANDed into it, and the carried (C, M) int8 registers -> the
    (C, M) int8 registers ``max(registers, the batch's registers)``: the
    fused Hopper kernel for CUDA tensors, the plain version for CPU
    tensors. bool, uint8, int8 and int16 values are widened to int64
    first."""
    _check_update_args(values, mask, row_mask, registers)
    if values.dtype in WIDENED_DTYPES:
        values = values.to(torch.int64)
    if values.device.type == "cuda":
        return _launch_update(values, mask, row_mask, registers)
    return hll_update_plain(values, mask, row_mask, registers)
