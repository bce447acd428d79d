"""HyperLogLog primitives for the fused scan.

Counterpart of ``deequ_tpu/sketches/hll.py``. Registers are an int8[M]
vector per column; one batch's update is hash -> (register index, rank)
-> scatter-max; the merge is an elementwise max.

- Numeric columns go through the fused register update
  (``scatter_max.hll_update``): one CUDA kernel hashes, ranks and
  scatters the raw values into the carried registers. Its plain version
  and the hash itself live in ``sketches/hll_hash.py``.
- Strings hash on the host, once per dictionary entry (blake2b-8); the
  presence and gather paths derive (index, rank) from those hashes and
  scatter them with the ``(idx, rho)`` kernel (``scatter_max
  .scatter_max_derived``).
"""

from __future__ import annotations

import hashlib
from typing import Tuple

import numpy as np
import torch

from deequ_tpu_torch.sketches import scatter_max
from deequ_tpu_torch.sketches.hll_hash import (  # noqa: F401 — re-exported
    M,
    REGISTER_DTYPE,
    fmix32,
    hash_pair_numeric,
    index_and_rank,
)


def dictionary_hash_pairs(dictionary: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Stable (u32, u32) hash per dictionary entry (host-side, once)."""
    n = max(len(dictionary), 1)
    h1 = np.zeros(n, dtype=np.uint32)
    h2 = np.zeros(n, dtype=np.uint32)
    for i, value in enumerate(dictionary):
        if value is None:
            continue
        digest = hashlib.blake2b(str(value).encode("utf-8"), digest_size=8).digest()
        words = np.frombuffer(digest, dtype=np.uint32)
        h1[i], h2[i] = words[0], words[1]
    return h1, h2


def registers_from_hash_pair(
    h1: torch.Tensor, h2: torch.Tensor, mask: torch.Tensor
) -> torch.Tensor:
    """One column's (B,) hash pairs -> int8[M] registers."""
    return registers_from_hash_pair_stacked(h1[None, :], h2[None, :], mask[None, :])[0]


def registers_from_hash_pair_stacked(
    h1: torch.Tensor, h2: torch.Tensor, mask: torch.Tensor
) -> torch.Tensor:
    """(C, B) hash pairs -> (C, M) int8 registers, one scatter-max for
    all C columns."""
    idx, rho = index_and_rank(h1, h2, mask)
    return scatter_max.scatter_max_derived(idx.contiguous(), rho.contiguous(), M).to(
        REGISTER_DTYPE
    )


# dictionaries up to this size take the presence path: scatter each
# dictionary entry once, masked by whether its code occurs in the batch
PRESENCE_DICT_CAP = 4096

# D-axis tile of the presence compare-reduce: bounds the (C, TILE, B)
# boolean intermediate
_PRESENCE_D_TILE = 256


def registers_from_code_presence(
    codes: torch.Tensor,  # (C, B) int codes, -1 = null
    mask: torch.Tensor,  # (C, B) validity
    lut1: torch.Tensor,  # (C, D) per-dictionary-entry hashes (int64)
    lut2: torch.Tensor,
) -> torch.Tensor:
    """Registers of dictionary-encoded columns from the dictionary
    entries present in the batch: a register is the max rank over the
    DISTINCT values present, so scattering each present entry once gives
    the same registers as scattering every row."""
    present = tiled_code_presence(codes, mask, lut1.shape[1])
    return registers_from_hash_pair_stacked(lut1, lut2, present)


def tiled_code_presence(codes: torch.Tensor, mask: torch.Tensor, D: int) -> torch.Tensor:
    """(C, D) bool: does dictionary slot d occur among the valid codes
    of column c? A compare-reduce over D tiles; null codes (-1) match no
    slot."""
    codes_i32 = codes.to(torch.int32)
    tile = min(D, _PRESENCE_D_TILE)
    parts = []
    for d0 in range(0, D, tile):
        d = torch.arange(d0, min(d0 + tile, D), dtype=torch.int32, device=codes.device)
        hits = (codes_i32[:, None, :] == d[None, :, None]) & mask[:, None, :]
        parts.append(hits.any(dim=2))
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)


def registers_from_codes(
    codes: torch.Tensor,  # (C, B) int codes, -1 = null
    mask: torch.Tensor,  # (C, B) validity
    lut1: torch.Tensor,  # (C, D) per-dictionary-entry hashes (int64)
    lut2: torch.Tensor,
) -> torch.Tensor:
    """(C, M) registers of dictionary-encoded columns: the presence path
    up to PRESENCE_DICT_CAP entries, else a per-row gather of the
    entries' hashes and the full scatter."""
    if lut1.shape[1] <= PRESENCE_DICT_CAP:
        return registers_from_code_presence(codes, mask, lut1, lut2)
    codes = torch.clamp(codes.to(torch.int64), 0, lut1.shape[1] - 1)
    h1 = torch.gather(lut1, 1, codes)
    h2 = torch.gather(lut2, 1, codes)
    return registers_from_hash_pair_stacked(h1, h2, mask)


_Q = 32  # h2 supplies 32 bits => register ranks 0..Q+1


def _sigma(x: float) -> float:
    """Ertl's sigma series (linear-counting correction term)."""
    if x == 1.0:
        return float("inf")
    y = 1.0
    z = x
    while True:
        x = x * x
        z_prev = z
        z = z + x * y
        y = y + y
        if z == z_prev:
            return z


def _tau(x: float) -> float:
    """Ertl's tau series (saturated-register correction term)."""
    if x == 0.0 or x == 1.0:
        return 0.0
    y = 1.0
    z = 1.0 - x
    while True:
        x = np.sqrt(x)
        z_prev = z
        y = 0.5 * y
        z = z - (1.0 - x) ** 2 * y
        if z == z_prev:
            return z / 3.0


def estimate(registers) -> float:
    """Ertl's improved raw estimator ("New cardinality estimation
    algorithms for HyperLogLog sketches", Ertl 2017, Alg. 6), on the
    host."""
    registers = np.asarray(registers)
    m = float(M)
    counts = np.bincount(registers.astype(np.int64), minlength=_Q + 2).astype(np.float64)
    z = m * _tau(1.0 - counts[_Q + 1] / m)
    for k in range(_Q, 0, -1):
        z = 0.5 * (z + counts[k])
    z = z + m * _sigma(counts[0] / m)
    alpha_inf = 1.0 / (2.0 * np.log(2.0))
    return float(alpha_inf * m * m / z)
