"""HyperLogLog primitives for the fused scan.

Counterpart of ``deequ_tpu/sketches/hll.py``. Registers are an int8[M]
vector per column; one batch's update is hash -> (register index, rank)
-> scatter-max; the merge is an elementwise max.

Every derivation here must place a value in the SAME register with the
SAME rank as the JAX package does, bit for bit: registers from the two
packages are max-merged (``deequ_tpu_torch/interop.py``), and a value
hashed differently on either side would be counted twice.

- Hashes are built from 32-bit words. PyTorch has no usable uint32
  arithmetic, so words travel as int64 holding values in [0, 2^32), and
  every multiply is split so no int64 product overflows.
- Integral and boolean columns hash the raw int64 payload as (hi, lo)
  words; floating columns hash a (float32, float32 residual) split of
  the float64 value, with -0.0 -> +0.0.
- NaN and infinities take fixed word values (those the JAX package
  produces on the CPU for canonical NaN), so the hash of a float column
  does not depend on how a device rounds NaN arithmetic.
- Strings hash on the host, once per dictionary entry (blake2b-8).

The register scatter-max is the hand-written kernel behind
``deequ_tpu_torch/sketches/scatter_max.py``.
"""

from __future__ import annotations

import hashlib
from typing import Tuple

import numpy as np
import torch

from deequ_tpu_torch.sketches.scatter_max import scatter_max

P = 14  # precision: m = 2^14 registers => ~0.8% relative error
M = 1 << P

_C1 = 0x85EBCA6B
_C2 = 0xC2B2AE35
_GOLDEN = 0x9E3779B9
_U32 = 0xFFFFFFFF

# float32 bit patterns the JAX package's float split yields on the CPU:
# canonical NaN in both words; the residual of +-inf is inf - inf
_NAN_BITS = 0x7FC00000
_INF_RESIDUAL_BITS = 0xFFC00000

REGISTER_DTYPE = torch.int8  # rho <= 33 fits i8; the scatter runs in i32


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2^32 for int64 ``h`` in [0, 2^32): the product is
    split at bit 16 so no intermediate leaves the int64 range."""
    hi = ((h >> 16) * c) & 0xFFFF
    return ((hi << 16) + (h & 0xFFFF) * c) & _U32


def fmix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3 32-bit finalizer over int64 words in [0, 2^32)."""
    h = h ^ (h >> 16)
    h = _mul32(h, _C1)
    h = h ^ (h >> 13)
    h = _mul32(h, _C2)
    return h ^ (h >> 16)


def _float_words(values: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    x = values.to(torch.float64)
    x = torch.where(x == 0.0, torch.zeros((), dtype=x.dtype, device=x.device), x)
    hi = x.to(torch.float32)
    lo = (x - hi.to(torch.float64)).to(torch.float32)
    lo = torch.where(lo == 0.0, torch.zeros((), dtype=lo.dtype, device=lo.device), lo)
    hi_bits = hi.view(torch.int32).to(torch.int64) & _U32
    lo_bits = lo.view(torch.int32).to(torch.int64) & _U32
    nan = torch.isnan(x)
    hi_bits = torch.where(nan, _NAN_BITS, hi_bits)
    lo_bits = torch.where(
        nan, _NAN_BITS, torch.where(torch.isinf(x), _INF_RESIDUAL_BITS, lo_bits)
    )
    return hi_bits, lo_bits


def hash_pair_numeric(values: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two independent 32-bit hashes per value (int64 tensors holding
    [0, 2^32)), dispatching on the column dtype: floating columns hash
    the float split, everything else (integers, bools) the raw int64."""
    if values.dtype.is_floating_point:
        hi_bits, lo_bits = _float_words(values)
    else:
        as_i64 = values.to(torch.int64)
        lo_bits = as_i64 & _U32
        hi_bits = (as_i64 >> 32) & _U32
    h1 = fmix32(lo_bits ^ fmix32(hi_bits ^ _GOLDEN))
    h2 = fmix32(hi_bits ^ fmix32(lo_bits ^ _C1))
    return h1, h2


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


def _index_and_rank(
    h1: torch.Tensor, h2: torch.Tensor, mask: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """THE (register index, rho rank) derivation: idx = top P bits of
    h1, rho = clz32(h2) + 1 (1..33). ``frexp`` of the float64 value
    (exact below 2^53) gives the bit length e of h2, and clz32 = 32 - e;
    h2 == 0 has e == 0 and so rho == 33. Masked rows map to (0, 0), a
    no-op against a zeroed register file."""
    idx = (h1 >> (32 - P)).to(torch.int32)
    _, e = torch.frexp(h2.to(torch.float64))
    rho = (33 - e).to(torch.int32)
    zero = torch.zeros((), dtype=torch.int32, device=idx.device)
    return torch.where(mask, idx, zero), torch.where(mask, rho, zero)


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
    idx, rho = _index_and_rank(h1, h2, mask)
    return scatter_max(idx.contiguous(), rho.contiguous(), M).to(REGISTER_DTYPE)


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


def numeric_registers(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(C, B) values -> (C, M) registers through the full scatter. The
    JAX package may take a sorted-dedup path for mid-cardinality
    columns instead; its registers are bit-identical by contract."""
    h1, h2 = hash_pair_numeric(values)
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
