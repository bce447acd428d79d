"""HyperLogLog primitives for the fused scan.

Counterpart of ``deequ_tpu/sketches/hll.py``. Registers are an int8[M]
vector per column; one batch's update is hash -> (register index, rank)
-> scatter-max; the merge is an elementwise max.

- Numeric columns go through the fused register update
  (``scatter_max.hll_update``): one CUDA kernel hashes, ranks and
  scatters the raw values into the carried registers. Its plain version
  and the hash itself live in ``sketches/hll_hash.py``.
- Strings hash on the host, once per dictionary entry (blake2b-8). The
  engine's update of dictionary columns is one fused kernel too
  (``scatter_max.hll_update_codes``): codes, masks and the entries'
  hashes in, the carried registers out. Its plain version
  (``scatter_max.hll_update_codes_plain``) is the presence path up to
  PRESENCE_DICT_CAP entries and a per-row gather of the entries' hashes
  past it (``hll_hash.code_index_and_rank``).
"""

from __future__ import annotations

import hashlib
from typing import Tuple

import numpy as np
import torch

from deequ_tpu_torch.sketches import scatter_max
from deequ_tpu_torch.sketches.hll_hash import (  # noqa: F401 — re-exported
    M,
    PRESENCE_DICT_CAP,
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
