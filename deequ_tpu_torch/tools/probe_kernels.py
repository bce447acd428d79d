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
built at first use. Each writes ``max(regs, scatter)`` in one cluster
launch: P1 and P2 spread one register file over a thread-block cluster
(:func:`plan` sizes the launch); P3 computes its gate once per cluster
and tests each row against the warm registers where they lie
(:func:`plan_gmin`).
As with ``sketches/scatter_max.py``:

- ``_check_args`` raises on anything the kernel does not take, before
  any launch;
- a CUDA tensor goes to the kernel, and a launch that fails raises;
- a CPU tensor goes to the plain version beside the kernel;
- ``launches`` counts each kernel's launches, by id.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from deequ_tpu_torch import config
from deequ_tpu_torch.config import on_device as _on
from deequ_tpu_torch.sketches.scatter_max import MAX_REGISTERS, RHO_LIMIT
from deequ_tpu_torch.utils import cuda_build

SOURCE = cuda_build.CSRC_DIR / "scatter_probe.cu"
RHO_BITS = 6  # packed words are idx << 6 | rho

# P1 and P2: blocks a cluster (16, the non-portable size, gave a few
# percent less device time than the portable 8 on an H100) and the
# dynamic shared memory a block asks for; copies of the kernel's
# kCluster and kBlockSmem (csrc/scatter_probe.cu says why the latter is
# more than half an SM's).
CLUSTER = 16
BLOCK_SMEM = 120 * 1024
# a cluster should scan at least as many rows as it has registers
MIN_ROWS_PER_CLUSTER = MAX_REGISTERS

# P3: blocks a cluster and blocks an SM (copies of the kernel's
# kGminCluster and kGminBlocksPerSm); a cluster should scan at least as
# many rows as it reads registers for its gate
GMIN_CLUSTER = 8
GMIN_BLOCKS_PER_SM = 2

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


# -- the plan of a cluster launch (P1, P2) -----------------------------------


@dataclass(frozen=True)
class Plan:
    """How P1 or P2 covers ``rows`` rows and ``m`` registers.

    Block ``b`` of the grid reads rows ``rows_of(b)``: int4 loads over
    its first ``(end - begin) // 4 * 4`` rows where the streams are
    16-byte aligned, scalar loads over the rest. Block ``rank`` of a
    cluster owns the registers ``owned(rank)`` of the cluster's file.
    The kernel computes the same partition from these fields."""

    rows: int
    m: int
    clusters: int
    share: int  # rows a block reads, a multiple of 4
    span_log2: int  # registers a block owns, log2

    @property
    def blocks(self) -> int:
        return CLUSTER * self.clusters

    def owned(self, rank: int) -> Tuple[int, int]:
        lo = min(rank << self.span_log2, self.m)
        return lo, min((rank + 1) << self.span_log2, self.m)

    def rows_of(self, block: int) -> Tuple[int, int]:
        begin = min(block * self.share, self.rows)
        return begin, min(begin + self.share, self.rows)


@functools.lru_cache(maxsize=1024)
def plan(rows: int, m: int, sm_count: int) -> Plan:
    """The launch of P1 or P2 over ``rows`` rows into ``m`` registers on
    a card of ``sm_count`` SMs: one block an SM, in whole clusters, but
    no cluster that would scan fewer than MIN_ROWS_PER_CLUSTER rows;
    each block owns a power-of-two span of registers, so the owner of
    register k is ``k >> span_log2``."""
    if not 1 <= m <= MAX_REGISTERS:
        raise ValueError(f"plan: m must be in [1, {MAX_REGISTERS}], got {m}")
    clusters = max(1, min(sm_count // CLUSTER, -(-rows // MIN_ROWS_PER_CLUSTER)))
    share = -(-max(rows, 1) // (clusters * CLUSTER))
    share = -(-share // 4) * 4
    span_log2 = (-(-m // CLUSTER) - 1).bit_length()
    return Plan(rows, m, clusters, share, span_log2)


@dataclass(frozen=True)
class GminPlan:
    """How P3 covers ``rows`` rows and ``m`` registers: ``clusters``
    clusters of GMIN_CLUSTER blocks read the rows grid-strided, and
    block ``rank`` of each cluster min-reduces ``gate_slice(rank)`` of
    the warm registers for the cluster's gate. The kernel computes the
    same slices."""

    rows: int
    m: int
    clusters: int

    @property
    def blocks(self) -> int:
        return GMIN_CLUSTER * self.clusters

    def gate_slice(self, rank: int) -> Tuple[int, int]:
        return self.m * rank // GMIN_CLUSTER, self.m * (rank + 1) // GMIN_CLUSTER


@functools.lru_cache(maxsize=1024)
def plan_gmin(rows: int, m: int, sm_count: int, fit: Optional[int] = None) -> GminPlan:
    """The launch of P3 over ``rows`` rows into ``m`` registers on a
    card of ``sm_count`` SMs: GMIN_BLOCKS_PER_SM blocks an SM, in whole
    clusters, but no cluster that would scan fewer than
    MIN_ROWS_PER_CLUSTER rows, and no more clusters than ``fit`` (the
    clusters the card holds at once), so the launch is one wave."""
    if not 1 <= m <= MAX_REGISTERS:
        raise ValueError(f"plan_gmin: m must be in [1, {MAX_REGISTERS}], got {m}")
    clusters = min(GMIN_BLOCKS_PER_SM * sm_count // GMIN_CLUSTER,
                   -(-rows // MIN_ROWS_PER_CLUSTER))
    if fit is not None:
        clusters = min(clusters, fit)
    return GminPlan(rows, m, max(1, clusters))


# -- the kernels ------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = cuda_build.load_library(SOURCE)
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    # regs, out, rows, m, skip, vec, clusters, share, span_log2, stream
    cluster_args = [ptr, ptr, i64, i32, i32, i32, i32, i64, i32, ptr]
    signatures = {
        "probe_two_stream_launch": [ptr, ptr] + cluster_args,  # idx, rho, ...
        "probe_packed_launch": [ptr] + cluster_args,  # packed, ...
        "probe_max_active_clusters": [i32, i32],  # two, skip
        # regs_in, packed, out, rows, m, vec, clusters, stream
        "probe_gmin_launch": [ptr, ptr, ptr, i64, i32, i32, i32, ptr],
        "probe_gmin_max_active_clusters": [],
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


@functools.lru_cache(maxsize=None)
def max_active_clusters(index: int, two: bool, skip: bool) -> int:
    """Clusters of P1 (``two``) or P2 the device holds at once, from the
    occupancy query; raises if not even one fits. Call with the device
    current."""
    n = _library().probe_max_active_clusters(int(two), int(skip))
    if n < 0:
        _raise_on(-n, "occupancy query of the probe")
    if n == 0:
        raise RuntimeError(
            f"a cluster of {CLUSTER} probe blocks with {BLOCK_SMEM} bytes of shared "
            "memory each does not fit on this card"
        )
    return n


@functools.lru_cache(maxsize=1024)
def plan_on(index: int, two: bool, skip: bool, rows: int, m: int) -> Plan:
    """:func:`plan` on one device: over its SMs, or over the SMs that
    the clusters it can hold at once take, if that is fewer."""
    sms = config.sm_count(torch.device("cuda", index))
    fit = max_active_clusters(index, two, skip) * CLUSTER
    return plan(rows, m, min(sms, fit))


@functools.lru_cache(maxsize=1024)
def plan_gmin_on(index: int, rows: int, m: int) -> GminPlan:
    """:func:`plan_gmin` on one device, capped at the clusters of P3
    it holds at once (the occupancy query); raises if not even one
    fits. Call with the device current."""
    n = _library().probe_gmin_max_active_clusters()
    if n < 0:
        _raise_on(-n, "occupancy query of P3")
    if n == 0:
        raise RuntimeError(f"a cluster of {GMIN_CLUSTER} P3 blocks does not fit on this card")
    return plan_gmin(rows, m, config.sm_count(torch.device("cuda", index)), n)


def _launch_cluster(
    kernel: str, regs: torch.Tensor, streams: Tuple[torch.Tensor, ...], skip: bool, vec: bool
) -> torch.Tensor:
    """One launch of P1 (two streams) or P2 (one), counted under
    ``kernel``: ``max(regs, scatter)``, folded into a copy of ``regs``.
    Reads nothing back from the device."""
    rows, m = streams[0].shape[0], regs.shape[0]
    if rows == 0:
        return regs.clone()
    two = len(streams) == 2
    device = regs.device
    with _on(device):
        p = plan_on(device.index, two, skip, rows, m)
        out = regs.clone()
        lib = _library()
        fn = lib.probe_two_stream_launch if two else lib.probe_packed_launch
        err = fn(
            *(t.data_ptr() for t in streams), regs.data_ptr(), out.data_ptr(), rows, m,
            int(skip), int(vec), p.clusters, p.share, p.span_log2, _stream(regs),
        )
    _raise_on(err, f"{kernel} {'two_stream' if two else 'packed'}")
    launches[kernel] += 1
    return out


def _launch_two_stream(regs, idx, rho, skip_cold: bool) -> torch.Tensor:
    """P1's launch: int4 loads where idx and rho are both 16-byte
    aligned, scalar loads where either is not."""
    vec = _aligned16(idx) & _aligned16(rho)
    return _launch_cluster("P1", regs, (idx, rho), skip_cold, vec)


def _launch_packed(regs, packed, skip_cold: bool, vec: bool) -> torch.Tensor:
    vec = int(vec) & _aligned16(packed)
    return _launch_cluster("P2", regs, (packed,), skip_cold, vec)


def _launch_gmin(regs_in, packed, vec: bool) -> torch.Tensor:
    """P3's launch: ``max(regs_in, scatter)`` folded into a copy of
    ``regs_in`` that the launch makes; int4 loads where the words are
    16-byte aligned and ``vec`` is set. Reads nothing back from the
    device."""
    rows, m = packed.shape[0], regs_in.shape[0]
    if rows == 0:
        return regs_in.clone()
    device = packed.device
    with _on(device):
        p = plan_gmin_on(device.index, rows, m)
        out = torch.empty_like(regs_in)
        err = _library().probe_gmin_launch(
            regs_in.data_ptr(), packed.data_ptr(), out.data_ptr(), rows, m,
            int(vec) & _aligned16(packed), p.clusters, _stream(packed),
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
    if regs.device.type == "cuda":
        return _launch_two_stream(regs, idx, rho, skip_cold)
    return torch.maximum(regs, two_stream_plain(idx, rho, regs.shape[0]))


def scatter_packed(
    regs: torch.Tensor, packed: torch.Tensor, skip_cold: bool = True, vec: bool = True
) -> torch.Tensor:
    """P2: ``max(regs, scatter(unpack(packed)))``; ``vec`` reads the
    words as int4s where they are 16-byte aligned, and ``vec=False``
    reads them one at a time."""
    _check_args(regs, packed=packed)
    if regs.device.type == "cuda":
        return _launch_packed(regs, packed, skip_cold, vec)
    return torch.maximum(regs, packed_plain(packed, regs.shape[0]))


def scatter_gmin(
    regs: torch.Tensor, packed: torch.Tensor, vec: bool = True
) -> torch.Tensor:
    """P3: ``max(regs, scatter(unpack(packed)))`` with the warm-register
    gate: elements with rank <= min(regs) skip the register update."""
    _check_args(regs, packed=packed)
    if regs.device.type == "cuda":
        return _launch_gmin(regs, packed, vec)
    return gmin_plain(regs, packed)
