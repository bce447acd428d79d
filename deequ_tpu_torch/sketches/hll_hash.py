"""The HLL hash of numeric values, and the (register index, rank)
derivation, as plain PyTorch.

Counterpart of ``hash_pair_numeric``, ``fmix32`` and ``_index_and_rank``
in ``deequ_tpu/sketches/hll.py``. Every derivation here must place a
value in the SAME register with the SAME rank as the JAX package does,
bit for bit: registers from the two packages are max-merged
(``deequ_tpu_torch/interop.py``), and a value hashed differently on
either side would be counted twice.

- Hashes are built from 32-bit words. PyTorch has no usable uint32
  arithmetic, so words travel as int64 holding values in [0, 2^32), and
  every multiply is split so no int64 product overflows.
- Integral and boolean columns hash the raw int64 payload as (hi, lo)
  words; floating columns hash a (float32, float32 residual) split of
  the float64 value, with -0.0 -> +0.0.
- NaN and infinities take fixed word values (those the JAX package
  produces on the CPU for canonical NaN), so the hash of a float column
  does not depend on how a device rounds NaN arithmetic.
- Subnormals follow the JAX package on the CPU too, where XLA reads
  subnormal inputs as zero and flushes subnormal results to zero: a
  value subnormal in its own dtype hashes as +0.0, and a float32 word
  that would be subnormal becomes a zero (the hi word keeps the sign of
  the value; a zero residual is +0.0). Tininess is judged as x86 judges
  it, after rounding to 24 bits with an unbounded exponent: below
  ``_FTZ_LIMIT``.

Dictionary-encoded columns rank their dictionary entries instead
(:func:`code_index_and_rank`): each entry present among a batch's valid
codes once, or, past ``PRESENCE_DICT_CAP`` entries, every row's entry.

The fused register updates (``sketches/scatter_max.py::hll_update`` and
``hll_update_codes``) compute the same functions inside their CUDA
kernels (``csrc/scatter_max.cu``, in native uint32); these functions
are their plain versions and the hash of the callers that scatter
precomputed ranks. This module imports no other module of the package,
so both ``sketches/hll.py`` and ``sketches/scatter_max.py`` can use it.
"""

from __future__ import annotations

from typing import Tuple

import torch

P = 14  # precision: m = 2^14 registers => ~0.8% relative error
M = 1 << P
REGISTER_DTYPE = torch.int8  # rho <= 33 fits i8; scatters run in i32

_C1 = 0x85EBCA6B
_C2 = 0xC2B2AE35
_GOLDEN = 0x9E3779B9
_U32 = 0xFFFFFFFF

# float32 bit patterns the JAX package's float split yields on the CPU:
# canonical NaN in both words; the residual of +-inf is inf - inf
_NAN_BITS = 0x7FC00000
_INF_RESIDUAL_BITS = 0xFFC00000
# float64 magnitudes below this round to a float32 that x86 calls tiny
# (FLT_MIN minus half its lower ulp, 2^-126 - 2^-151): those words flush
# to zero
_FTZ_LIMIT = 2.0**-126 - 2.0**-151


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
    # zeros and inputs subnormal in their own dtype -> +0.0
    daz = values.abs() < torch.finfo(values.dtype).tiny
    x = torch.where((x == 0.0) | daz, torch.zeros((), dtype=x.dtype, device=x.device), x)
    zero32 = torch.zeros((), dtype=torch.float32, device=x.device)
    hi = x.to(torch.float32)
    hi = torch.where(x.abs() < _FTZ_LIMIT, torch.copysign(zero32, hi), hi)
    rest = x - hi.to(torch.float64)
    lo = rest.to(torch.float32)
    lo = torch.where((lo == 0.0) | (rest.abs() < _FTZ_LIMIT), zero32, lo)
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


def index_and_rank(
    h1: torch.Tensor, h2: torch.Tensor, mask: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """THE (register index, rho rank) derivation: idx = top P bits of
    h1, rho = clz32(h2) + 1 (1..33). ``frexp`` of the float64 value
    (exact below 2^53) gives the bit length e of h2, and clz32 = 32 - e;
    h2 == 0 has e == 0 and so rho == 33. Masked rows map to (0, 0), a
    no-op against a zeroed register file. So idx lies in [0, M) and rho
    in [0, 33] by construction."""
    idx = (h1 >> (32 - P)).to(torch.int32)
    _, e = torch.frexp(h2.to(torch.float64))
    rho = (33 - e).to(torch.int32)
    zero = torch.zeros((), dtype=torch.int32, device=idx.device)
    return torch.where(mask, idx, zero), torch.where(mask, rho, zero)


# dictionaries up to this size take the presence path: rank each
# dictionary entry once, masked by whether its code occurs in the batch
PRESENCE_DICT_CAP = 4096

# D-axis tile of the presence compare-reduce: bounds the (C, TILE, B)
# boolean intermediate
_PRESENCE_D_TILE = 256


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


def code_index_and_rank(
    codes: torch.Tensor,  # (C, B) int codes, -1 = null
    mask: torch.Tensor,  # (C, B) validity
    lut1: torch.Tensor,  # (C, D) per-dictionary-entry hashes (int64)
    lut2: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(idx, rho) of dictionary-encoded columns, for a scatter-max: up to
    PRESENCE_DICT_CAP entries, one pair per dictionary entry, masked by
    whether the entry occurs among the valid codes (a register is the
    max rank over the DISTINCT values present); past it, one pair per
    row from the gathered hashes, codes clamped into [0, D)."""
    D = lut1.shape[1]
    if D <= PRESENCE_DICT_CAP:
        return index_and_rank(lut1, lut2, tiled_code_presence(codes, mask, D))
    codes = torch.clamp(codes.to(torch.int64), 0, D - 1)
    return index_and_rank(torch.gather(lut1, 1, codes), torch.gather(lut2, 1, codes), mask)
