"""Device-side high-cardinality grouping: sort + segment counting.

Counterpart of the single-device half of ``deequ_tpu/analyzers/spill.py``.
A frequency plan whose key space is too large for a dense count vector
(``analyzers/grouping.py``) groups on the device: every row's key goes
into one flat key lane (two past 2^62 joint keys), the lane is sorted,
and groups are the runs of equal keys.

**Key lanes are int64 holding ``u64 ^ (1 << 63)``.** The JAX package
sorts u64 keys; PyTorch has no usable uint64 sort. Flipping the sign bit
maps ascending u64 order onto ascending int64 order, so the port's sort
puts the groups in the JAX package's order (which decides top-k ties and
the order of the fetched groups). Consequences:

- an integer key's lane is its own int64 value (the JAX package's u64
  key is ``value ^ (1 << 63)``);
- float keys are their canonical bits, read on the device with
  ``view(torch.int32/int64)``: float32 NaN as ``0x7FC00000``, float64
  NaN as ``0x7FF8000000000000``, the sign-bit-only word (-0.0) as 0;
- joint keys are the dense path's mixed-radix joint codes;
- the u64 all-ones sentinel of rows that do not contribute (filtered,
  null) becomes ``INT64_MAX`` and still sorts last. An ``int64.max``
  key shares its value; the exact count of sentinel rows is carried as a
  scalar and subtracted from the trailing segment, so that key stays
  exact (the JAX package's correction);
- decoding XORs back (``_u64_of``).

Count-shaped metrics (groups, groups of one, rows, entropy) are scalars
computed on the device; the per-group arrays stay there and are fetched
only when something needs the keys (MutualInformation, Histogram's
top-k, persistence, merges).

Two forms, as in the JAX package. The one-pass **collector**
(``single_collector_spec``, ``joint_collector_spec``) is a ``ScanOps``
that writes each batch's keys into a device buffer that rides the
shared fused scan; after the scan, every plan's sort and segment count
is dispatched before one packed fetch. The **deferred** form
(``device_spill_frequencies``, ``device_spill_joint_frequencies``)
re-reads the columns for one plan; it is the ``one_pass_spill=False``
path and a collector's fallback. Both feed the same key vector to the
same finalize, so their metrics are identical.

The buffer holds exactly the rows the scan feeds
(``AnalysisEngine.scan_row_capacity``): the JAX package pads it to a
power of two only so that XLA compiles one sort for many sizes. The
counts are the same; only the on-device entropy's summation order
differs from the JAX package's.

Left for later: the sharded and multi-host spill (a mesh's all_to_all
shuffle) and the memory-pressure downgrades.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deequ_tpu_torch import config
from deequ_tpu_torch.analyzers.grouping import FrequenciesAndNumRows
from deequ_tpu_torch.data.table import ROW_MASK, ColumnRequest, Dataset, Kind
from deequ_tpu_torch.engine.pack import packed_device_get

# an INTEGRAL column whose (max - min) spans less than this stays on
# the dense fused-scan path: its dictionary is bounded by the range
DENSE_DOMAIN_RANGE = 4096

_FLIP = -(1 << 63)  # XOR of a u64 key's bits with 1 << 63, as an int64
_SENTINEL = (1 << 63) - 1  # the u64 all-ones sentinel, flipped
_F32_NAN = 0x7FC00000
_F64_NAN = 0x7FF8000000000000
_I32_SIGN = -(1 << 31)  # float32 -0.0's bits as an int32


def _u64_of(lanes: np.ndarray) -> np.ndarray:
    """The JAX package's u64 keys of host int64 lanes."""
    return lanes.view(np.uint64) ^ np.uint64(1 << 63)


def _key_kind(values_dtype: np.dtype) -> str:
    if values_dtype.kind != "f":
        return "int"
    return "f64" if values_dtype.itemsize == 8 else "f32"


def _single_lane(values: torch.Tensor, key_kind: str) -> torch.Tensor:
    """A single column's int64 key lane (module docstring)."""
    if key_kind == "f32":
        x = values.to(torch.float32)
        bits = x.view(torch.int32)
        bits = torch.where(torch.isnan(x), _F32_NAN, bits)
        bits = torch.where(bits == _I32_SIGN, 0, bits)
        return (bits.to(torch.int64) & 0xFFFFFFFF) ^ _FLIP
    if key_kind == "f64":
        x = values.to(torch.float64)
        bits = x.view(torch.int64)
        bits = torch.where(torch.isnan(x), _F64_NAN, bits)
        return torch.where(bits == _FLIP, 0, bits) ^ _FLIP
    return values.to(torch.int64)


def _keep_or_sentinel(contributes, lane, out=None):
    """``lane`` where a row contributes, else the sentinel; written into
    ``out`` when given (a collector's buffer slice: no extra copy)."""
    if out is None:
        return torch.where(contributes, lane, _SENTINEL)
    return torch.where(contributes, lane, lane.new_full((), _SENTINEL), out=out)


def _finish_keys(lane, mask, rows, include_nulls: bool, out=None):
    """The sentinel and null bookkeeping every single-column key builder
    shares: rows that do not contribute take the sentinel (written into
    ``out`` when given); returns (keys, #sentinel rows, #null rows kept)."""
    contributes = rows & mask
    keys = _keep_or_sentinel(contributes, lane, out)
    n_sentinel = contributes.numel() - contributes.sum(dtype=torch.int64)
    if include_nulls:
        n_null = (rows & ~mask).sum(dtype=torch.int64)
    else:
        n_null = torch.zeros((), dtype=torch.int64, device=rows.device)
    return keys, n_sentinel, n_null


def _joint_lane(codes, sizes) -> torch.Tensor:
    """Mixed-radix joint code of per-column dictionary codes (code + 1
    digits, null as digit 0), flipped into a key lane."""
    key = torch.zeros(codes[0].shape, dtype=torch.int64, device=codes[0].device)
    for c, s in zip(codes, sizes):
        key = key * int(s) + (c.to(torch.int64) + 1)
    return key ^ _FLIP


def _joint_keys(codes, masks, rows, lane_sizes, outs):
    """Joint key lanes of one batch (one lane, or two split at the lane
    boundary): rows where every grouping column is null, or that are
    filtered out, take the sentinel on every lane. Returns #sentinel."""
    any_non_null = masks[0]
    for m in masks[1:]:
        any_non_null = any_non_null | m
    contributes = rows & any_non_null
    start = 0
    keys = []
    for sizes, out in zip(lane_sizes, outs):
        lane = _joint_lane(codes[start:start + len(sizes)], sizes)
        keys.append(_keep_or_sentinel(contributes, lane, out))
        start += len(sizes)
    return keys, contributes.numel() - contributes.sum(dtype=torch.int64)


def host_f64_u64_keys(values: np.ndarray, mask: np.ndarray, rows: np.ndarray,
                      include_nulls: bool):
    """The JAX package's u64 keys of a float64 column, with the sentinel
    bookkeeping, computed on the host: the tests hold the device lanes
    to it (through ``_u64_of``)."""
    from deequ_tpu_torch.data.table import f64_canonical_u64_bits

    bits = f64_canonical_u64_bits(values)
    contributes = rows & mask
    null = rows & ~mask if include_nulls else np.zeros_like(rows)
    keys = np.where(contributes, bits, np.uint64(0xFFFFFFFFFFFFFFFF))
    return keys.ravel(), int(np.sum(~contributes)), int(np.sum(null))


# --------------------------------------------------------------------------
# finalize: sort, segment count, scalars
# --------------------------------------------------------------------------


def _sort_lanes(lanes: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
    """Sort key lanes lexicographically, the first lane most significant.
    ``torch.sort`` takes one key, so two lanes sort least significant
    first, each sort stable, each later sort permuting the earlier
    order (an LSD radix over the lanes)."""
    if len(lanes) == 1:
        return (torch.sort(lanes[0]).values,)
    perm = None
    for lane in reversed(lanes):
        key = lane if perm is None else lane[perm]
        order = torch.sort(key, stable=True).indices
        perm = order if perm is None else perm[order]
    return tuple(lane[perm] for lane in lanes)


def _segment_starts(boundary: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
    """(n + 1,) int32 start row of each segment, n past the last one: a
    scatter with one writer a segment (the row that starts it). A row
    that starts none writes its own slot past n + 1, so no two rows
    ever write one address (a shared trash slot took 4 ms of contended
    stores over 100M rows on an H100)."""
    n = boundary.shape[0]
    device = boundary.device
    trash = torch.arange(n + 1, 2 * n + 1, dtype=torch.int64, device=device)
    starts = torch.empty(2 * n + 1, dtype=torch.int32, device=device)
    starts[: n + 1].fill_(n)
    pos = torch.arange(n, dtype=torch.int32, device=device)
    starts.scatter_(0, torch.where(boundary, seg, trash), pos)
    return starts[: n + 1]


def _segment_count_lanes(lanes, correction):
    """Sort flat key lanes lexicographically, count the segments (a
    boundary wherever any lane changes), and subtract ``correction``
    sentinel-valued entries from the trailing segment. Outputs have
    length n + 1; segments occupy [0, num_segments) and ``gmask`` marks
    those with a positive corrected count (every other slot counts 0). Counts are int32 (the gates
    keep a plan below 2^31 rows).

    The counts are differences of segment starts (``_segment_starts``):
    on sorted keys, a ``scatter_add_`` of ones puts every row of a
    segment on one counter, and thousands of rows a key contend."""
    sorted_lanes = _sort_lanes(lanes)
    n = sorted_lanes[0].shape[0]
    device = sorted_lanes[0].device
    changed = torch.zeros(n - 1, dtype=torch.bool, device=device)
    for k in sorted_lanes:
        changed |= k[1:] != k[:-1]
    boundary = torch.cat([torch.ones(1, dtype=torch.bool, device=device), changed])
    seg = torch.cumsum(boundary, 0) - 1  # int64
    num_segments = seg[-1] + 1
    starts = _segment_starts(boundary, seg)
    counts = torch.cat([starts[1:], starts.new_full((1,), n)]) - starts
    # sentinel-valued entries all sort to the end and share the last
    # segment; the caller knows exactly how many do not belong
    has_sentinel = torch.ones((), dtype=torch.bool, device=device)
    for k in sorted_lanes:
        has_sentinel = has_sentinel & (k[-1] == _SENTINEL)
    fix = torch.where(has_sentinel, correction, 0).to(torch.int32)
    counts.index_add_(0, seg[-1:], -fix.reshape(1))
    # each segment's key: the sorted lane at its start row (slots past
    # the last segment read a clamped row and are never in range)
    at = starts.clamp(max=n - 1).to(torch.int64)
    group_lanes = tuple(k[at] for k in sorted_lanes)
    # slots past the last segment start at n and count 0, so a positive
    # count alone marks a live group
    gmask = counts > 0
    return num_segments, counts, group_lanes, gmask


def _entropy_term(counts, gmask, total):
    """-sum(p log p) over the masked groups, in float64 on the device."""
    c = torch.where(gmask, counts, 0).to(torch.float64)
    p = c / torch.clamp(total, min=1).to(torch.float64)
    return -torch.where(c > 0, p * torch.log(p), 0.0).sum()


def _spill_scalars(num_segments, counts, gmask, total) -> Dict[str, torch.Tensor]:
    """The on-device scalar summary every finalize shares."""
    return {
        "num_segments": num_segments.to(torch.int64),
        "num_groups": gmask.sum(dtype=torch.int64),
        "total": total,
        "unique": ((counts == 1) & gmask).sum(dtype=torch.int64),
        "entropy": _entropy_term(counts, gmask, total),
    }


def _finalize_fn(keys, n_sentinel):
    """One key lane + sentinel count -> (scalars, group keys, counts)."""
    num_segments, counts, group_lanes, gmask = _segment_count_lanes((keys,), n_sentinel)
    total = keys.shape[0] - n_sentinel
    return _spill_scalars(num_segments, counts, gmask, total), group_lanes[0], counts


def _finalize2_fn(hi, lo, n_sentinel):
    """The two-lane finalize (joint keys past one lane)."""
    num_segments, counts, group_lanes, gmask = _segment_count_lanes((hi, lo), n_sentinel)
    total = hi.shape[0] - n_sentinel
    scalars = _spill_scalars(num_segments, counts, gmask, total)
    return scalars, group_lanes[0], group_lanes[1], counts


def _topk_fn(counts, group_keys, num_segments: int, k: int):
    """The k largest in-range counts and their keys. ``lax.top_k``
    puts the lower index first among equal counts, and segments are in
    key order, so ties resolve in ascending key order; a stable sort of
    the negated counts does the same (``torch.topk`` promises no order
    among ties)."""
    in_range = torch.arange(counts.shape[0], device=counts.device) < num_segments
    masked = torch.where(in_range, counts, -1)
    order = torch.sort(-masked, stable=True).indices[:k]
    return masked[order], group_keys[order]


def _pack_top_pairs(pairs, k: int, null_rows: int):
    """Shared top-k tail: merge in the null bin (a host scalar) and
    pack (keys, counts) arrays."""
    if null_rows > 0:
        pairs = list(pairs) + [(None, np.int64(null_rows))]
        pairs.sort(key=lambda kv: -kv[1])
        pairs = pairs[:k]
    if not pairs:
        return np.zeros(0, dtype=object), np.zeros(0, dtype=np.int64)
    keys_out = np.empty(len(pairs), dtype=object)
    keys_out[:] = [p[0] for p in pairs]
    return keys_out, np.asarray([p[1] for p in pairs], dtype=np.int64)


class SpillOverflow(Exception):
    """A spill plan's keys do not fit its lanes; the planner takes the
    host group-by instead (exactness over speed). The sharded spill of
    the JAX package also raises it for a hash bucket past capacity."""


def _count_fetch(engine) -> None:
    if engine is not None:
        engine.device_fetches += 1


# --------------------------------------------------------------------------
# device states
# --------------------------------------------------------------------------


class DeviceFrequencies(FrequenciesAndNumRows):
    """FrequenciesAndNumRows whose groups live ON DEVICE.

    Count metrics read the fetched scalars; ``keys``/``counts`` fetch
    (one packed transfer, counted on ``engine``) and decode lazily. The
    null group, if any, is a host scalar appended on access."""

    def __init__(
        self,
        columns: Tuple[str, ...],
        values_dtype: np.dtype,
        scalars: Dict[str, object],
        group_keys,
        counts,
        null_rows: int,
        include_nulls: bool,
        joint=None,  # (dictionaries, sizes): multi-column joint codes
        engine=None,
    ):
        self.columns = tuple(columns)
        self._values_dtype = np.dtype(values_dtype)
        self._joint = joint
        self._engine = engine
        # the base class's lazy joint decode (armed after the fetch)
        self._keys = None
        self._lazy = None
        self._num_segments = int(scalars["num_segments"])
        self._value_groups = int(scalars["num_groups"])
        self._unique = int(scalars["unique"])
        self._entropy = float(scalars["entropy"])
        self._null_rows = int(null_rows) if include_nulls else 0
        self.num_rows = int(scalars["total"]) + self._null_rows
        self._dev = (group_keys, counts)
        self._keys_host: Optional[np.ndarray] = None  # int64 lanes
        self._counts_host: Optional[np.ndarray] = None

    @property
    def _has_null_group(self) -> bool:
        return self._null_rows > 0

    @property
    def num_groups(self) -> int:
        return self._value_groups + (1 if self._has_null_group else 0)

    def _fetch(self) -> None:
        if self._counts_host is None:
            s = self._num_segments
            gk, c = self._dev
            _count_fetch(self._engine)
            raw_keys, raw_counts = packed_device_get((gk[:s], c[:s]))
            raw_keys, raw_counts = raw_keys.numpy(), raw_counts.numpy()
            live = raw_counts > 0  # drops a zeroed sentinel segment
            self._keys_host = raw_keys[live]
            self._counts_host = raw_counts[live].astype(np.int64)
        if self._joint is not None and self._lazy is None:
            dictionaries, sizes = self._joint
            self._lazy = (
                _u64_of(self._keys_host).astype(np.int64),
                list(dictionaries),
                list(sizes),
            )

    def _decode_keys(self, lanes: np.ndarray) -> np.ndarray:
        """(K,) int64 lanes -> (K,) object values in the column's OWN
        dtype: a float32 column's keys decode through np.float32, as
        the dense dictionary path's do, so Histogram labels and
        persisted keys agree."""
        raw = _u64_of(lanes)
        if self._values_dtype == np.float32:
            vals = raw.astype(np.uint32).view(np.float32)
        elif self._values_dtype == np.float64:
            vals = raw.view(np.float64)
        else:
            vals = lanes
        return vals.astype(object)

    @property
    def counts(self) -> np.ndarray:
        self._fetch()
        if self._has_null_group:
            return np.concatenate([self._counts_host, [np.int64(self._null_rows)]])
        return self._counts_host

    @property
    def keys(self) -> np.ndarray:
        self._fetch()
        if self._joint is not None:
            return FrequenciesAndNumRows.keys.fget(self)
        out = np.empty((self.num_groups, 1), dtype=object)
        out[: len(self._keys_host), 0] = self._decode_keys(self._keys_host)
        if self._has_null_group:
            out[-1, 0] = None
        return out

    def non_null_group_mask(self) -> np.ndarray:
        if self._joint is not None:
            self._fetch()
            return FrequenciesAndNumRows.non_null_group_mask(self)
        mask = np.ones(self.num_groups, dtype=bool)
        if self._has_null_group:
            mask[-1] = False
        return mask

    # -- fast paths (no device->host group transfer) -------------------

    def count_unique_groups(self) -> int:
        return self._unique + (1 if self._null_rows == 1 else 0)

    def entropy_nats(self) -> float:
        from deequ_tpu_torch.analyzers.base import EmptyStateException

        if self._joint is not None:
            # joint plans can hold partly-null groups, which entropy
            # excludes; the device scalar summed every group, so fold
            # on the host over the fetched distribution
            return FrequenciesAndNumRows.entropy_nats(self)
        if self.num_rows - self._null_rows == 0:
            raise EmptyStateException("Entropy over empty distribution.")
        return self._entropy

    def top_groups(self, k: int) -> Tuple[np.ndarray, np.ndarray]:
        if self._joint is not None:
            return FrequenciesAndNumRows.top_groups(self, k)
        gk, c = self._dev
        kk = min(k, self._num_segments)
        pairs = []
        if kk > 0:
            _count_fetch(self._engine)
            tc, tkeys = packed_device_get(_topk_fn(c, gk, self._num_segments, kk))
            tc, tkeys = tc.numpy(), tkeys.numpy()
            live = tc > 0  # a zeroed sentinel segment never bins
            decoded = self._decode_keys(tkeys[live])
            pairs = list(zip(decoded, tc[live].astype(np.int64)))
        return _pack_top_pairs(pairs, k, self._null_rows if self._has_null_group else 0)


class TwoLaneDeviceFrequencies(DeviceFrequencies):
    """DeviceFrequencies for joint keys on TWO lanes (joint space past
    2^62): group identity is the (hi, lo) pair; decoding walks each
    lane's own mixed radix over its own column slice."""

    def __init__(self, columns, scalars, group_hi, group_lo, counts,
                 dictionaries, sizes, split: int, engine=None):
        super().__init__(
            columns, np.dtype(np.int64), scalars, (group_hi, group_lo), counts,
            0, False, joint=(list(dictionaries), list(sizes)), engine=engine,
        )
        self._split = split
        self._keys_host2: Optional[np.ndarray] = None

    def _fetch(self) -> None:
        if self._counts_host is None:
            s = self._num_segments
            (gh, gl), c = self._dev
            _count_fetch(self._engine)
            hi, lo, raw_counts = (
                x.numpy() for x in packed_device_get((gh[:s], gl[:s], c[:s]))
            )
            live = raw_counts > 0
            self._keys_host = hi[live]
            self._keys_host2 = lo[live]
            self._counts_host = raw_counts[live].astype(np.int64)

    def _lane_codes(self):
        return (
            _u64_of(self._keys_host).astype(np.int64),
            _u64_of(self._keys_host2).astype(np.int64),
        )

    @property
    def keys(self) -> np.ndarray:
        self._fetch()
        if self._keys is None:
            from deequ_tpu_torch.analyzers.grouping import _decode_joint_codes

            dictionaries, sizes = self._joint
            split = self._split
            hi, lo = self._lane_codes()
            left = _decode_joint_codes(split, hi, dictionaries[:split], sizes[:split])
            right = _decode_joint_codes(
                len(self.columns) - split, lo, dictionaries[split:], sizes[split:]
            )
            self._keys = np.hstack([left, right])
        return self._keys

    def non_null_group_mask(self) -> np.ndarray:
        self._fetch()
        mask = np.ones(len(self._keys_host), dtype=bool)
        split = self._split
        for lane, lane_sizes in zip(
            self._lane_codes(), (self._joint[1][:split], self._joint[1][split:])
        ):
            remaining = lane.copy()
            for j in range(len(lane_sizes) - 1, -1, -1):
                slot = remaining % lane_sizes[j]
                remaining = remaining // lane_sizes[j]
                mask &= slot > 0
        return mask


# --------------------------------------------------------------------------
# gates
# --------------------------------------------------------------------------


def _is_uint64(dataset: Dataset, column: str) -> bool:
    # a uint64 column's exact form is its int64 bits (its values are
    # float64); it cannot widen to the int64 key lane
    return dataset.hll_repr(column) == "bits"


def device_spill_eligible(dataset: Dataset, plan) -> bool:
    """True when a frequency plan should run the device sort path: one
    INTEGRAL/FRACTIONAL grouping column whose sort fits the device
    budget. Strings, booleans and timestamps keep the dense/host paths
    (their keys decode through dictionaries); uint64 cannot widen to the
    key lane; a bounded-domain integer column (range under
    DENSE_DOMAIN_RANGE) rides the dense fused scan instead. The gates
    read the same on every device."""
    opts = config.options()
    if not opts.device_spill_grouping or not opts.device_cache_bytes:
        return False
    if dataset.num_rows >= 2**31:
        return False  # int32 segment counts
    if len(plan.columns) != 1:
        return False
    column = plan.columns[0]
    kind = dataset.schema.kind_of(column)
    if kind not in (Kind.INTEGRAL, Kind.FRACTIONAL) or _is_uint64(dataset, column):
        return False
    if kind == Kind.INTEGRAL:
        rng = dataset.integral_range(column)
        if rng is not None and (rng[1] - rng[0]) < DENSE_DOMAIN_RANGE:
            return False
    # headroom gate: the JAX package's 64 bytes a row of sort transients
    return dataset.num_rows * 64 <= opts.device_cache_bytes


def joint_spill_config_ok(dataset: Dataset, plan) -> bool:
    """The size-independent gates of the joint spill, checked BEFORE
    probing full per-column cardinalities."""
    opts = config.options()
    if not opts.device_spill_grouping or not opts.device_cache_bytes:
        return False
    if plan.include_nulls:
        # the joint keys drop all-null rows; Histogram's null bin keeps
        # the dense/host paths
        return False
    if dataset.num_rows >= 2**31:
        return False
    return dataset.num_rows * 64 <= opts.device_cache_bytes


def split_joint_lanes(sizes) -> Optional[int]:
    """First-fit split index: columns [0:i] on lane 1, [i:] on lane 2,
    each lane's radix product < 2^62. None when even two lanes cannot
    hold the joint space."""
    cap = 2**62
    prod = 1
    i = 0
    for s in sizes:
        if prod * s >= cap:
            break
        prod *= s
        i += 1
    if i == 0:
        return None
    prod2 = 1
    for s in sizes[i:]:
        prod2 *= s
        if prod2 >= cap:
            return None
    return i


def joint_spill_eligible(dataset: Dataset, plan, sizes) -> bool:
    """Multi-column variant: config gates pass AND the joint mixed-radix
    key space fits one or two lanes."""
    if not joint_spill_config_ok(dataset, plan):
        return False
    return split_joint_lanes(tuple(sizes)) is not None


def joint_fits_one_lane(sizes) -> bool:
    """True when the joint space fits ONE lane (< 2^62)."""
    return split_joint_lanes(tuple(sizes)) == len(tuple(sizes))


# --------------------------------------------------------------------------
# key builders of a plan
# --------------------------------------------------------------------------


def _plan_predicate(dataset: Dataset, plan):
    if plan.where is None:
        return None
    from deequ_tpu_torch.sql.predicate import compile_predicate

    return compile_predicate(plan.where, dataset)


def _rows(batch, pred):
    rows = batch[ROW_MASK]
    return rows if pred is None else rows & pred.complies(batch)


def _single_key_builder(dataset: Dataset, plan):
    """(requests, values dtype, batch_keys) of a one-column plan, where
    ``batch_keys(batch, outs)`` returns ([keys], #sentinel, #null) and
    writes the keys into ``outs[0]`` when it is given."""
    column = plan.columns[0]
    values_dtype = dataset.request_dtype(ColumnRequest(column, "values"))
    key_kind = _key_kind(values_dtype)
    include_nulls = bool(plan.include_nulls)
    pred = _plan_predicate(dataset, plan)
    requests = [ColumnRequest(column, "values"), ColumnRequest(column, "mask")]
    if pred is not None:
        requests += list(pred.requests)

    def batch_keys(batch, outs=(None,)):
        lane = _single_lane(batch[f"{column}::values"], key_kind)
        keys, s, null = _finish_keys(
            lane, batch[f"{column}::mask"], _rows(batch, pred), include_nulls, out=outs[0]
        )
        return [keys], s, null

    return requests, values_dtype, batch_keys


def _joint_key_builder(dataset: Dataset, plan, sizes):
    """(requests, split, batch_keys) of a multi-column plan."""
    columns = list(plan.columns)
    split = split_joint_lanes(tuple(sizes))
    if split is None:  # the gates refuse such a plan; double-check
        raise SpillOverflow("joint key space exceeds two 64-bit lanes")
    lane_sizes = [list(sizes[:split])]
    if split < len(columns):
        lane_sizes.append(list(sizes[split:]))
    pred = _plan_predicate(dataset, plan)
    requests = [ColumnRequest(c, "codes") for c in columns] + [
        ColumnRequest(c, "mask") for c in columns
    ]
    if pred is not None:
        requests += list(pred.requests)

    def batch_keys(batch, outs=None):
        outs = outs or [None] * len(lane_sizes)
        keys, s = _joint_keys(
            [batch[f"{c}::codes"] for c in columns],
            [batch[f"{c}::mask"] for c in columns],
            _rows(batch, pred), lane_sizes, outs,
        )
        return keys, s, torch.zeros((), dtype=torch.int64, device=s.device)

    return requests, split, batch_keys


def _finalize_state(plan, values_dtype, lanes, n_sentinel, joint, split, engine):
    """Dispatch the finalize of a plan's key lanes; returns (pending
    device scalars, build) where ``build(fetched)`` makes the state."""
    if len(lanes) == 2:
        scalars, g_hi, g_lo, counts = _finalize2_fn(lanes[0], lanes[1], n_sentinel)

        def build2(fetched):
            scalars_h, _n_null = fetched
            return TwoLaneDeviceFrequencies(
                plan.columns, scalars_h, g_hi, g_lo, counts,
                joint[0], joint[1], split, engine=engine,
            )

        return scalars, build2
    scalars, group_keys, counts = _finalize_fn(lanes[0], n_sentinel)

    def build(fetched):
        scalars_h, n_null = fetched
        return DeviceFrequencies(
            plan.columns, values_dtype, scalars_h, group_keys, counts,
            int(n_null), bool(plan.include_nulls), joint=joint, engine=engine,
        )

    return scalars, build


# --------------------------------------------------------------------------
# the deferred form: one re-read of the columns a plan
# --------------------------------------------------------------------------


def _deferred(dataset, engine, requests, batch_keys, n_lanes):
    """Read the plan's columns once (a data pass), build every batch's
    keys, and return (lanes, #sentinel, #null) over all rows: the same
    vector a collector's buffer holds (one sentinel when empty)."""
    engine.data_passes += 1
    device = engine.device
    batch_size = engine._resolve_batch_size(dataset.num_rows)
    parts: List[List[torch.Tensor]] = [[] for _ in range(n_lanes)]
    n_sentinel = torch.zeros((), dtype=torch.int64, device=device)
    n_null = torch.zeros((), dtype=torch.int64, device=device)
    for batch in dataset.device_batches(requests, batch_size, device):
        keys, s, null = batch_keys(batch)
        for part, k in zip(parts, keys):
            part.append(k)
        n_sentinel = n_sentinel + s
        n_null = n_null + null
    if not parts[0]:
        lanes = [torch.full((1,), _SENTINEL, dtype=torch.int64, device=device)
                 for _ in range(n_lanes)]
        return lanes, n_sentinel + 1, n_null
    return [torch.cat(p) for p in parts], n_sentinel, n_null


def _run_deferred(pending, build, n_null, engine):
    """Fetch a deferred finalize's scalars (one counted transfer) and
    build its state."""
    _count_fetch(engine)
    scalars, nn = packed_device_get((pending, n_null))
    return build((scalars, nn))


def device_spill_frequencies(dataset: Dataset, plan, engine) -> DeviceFrequencies:
    """One high-cardinality single-column frequency pass on the device."""
    requests, values_dtype, batch_keys = _single_key_builder(dataset, plan)
    lanes, n_sentinel, n_null = _deferred(dataset, engine, requests, batch_keys, 1)
    pending, build = _finalize_state(plan, values_dtype, lanes, n_sentinel, None, 1, engine)
    return _run_deferred(pending, build, n_null, engine)


def device_spill_joint_frequencies(dataset: Dataset, plan, engine, dictionaries,
                                   sizes) -> DeviceFrequencies:
    """Multi-column high-cardinality frequencies on the device: the dense
    path's mixed-radix joint codes on one lane (two past 2^62)."""
    requests, split, batch_keys = _joint_key_builder(dataset, plan, sizes)
    n_lanes = 1 if split == len(plan.columns) else 2
    lanes, n_sentinel, n_null = _deferred(dataset, engine, requests, batch_keys, n_lanes)
    joint = (list(dictionaries), list(sizes))
    pending, build = _finalize_state(
        plan, np.dtype(np.int64), lanes, n_sentinel, joint, split, engine
    )
    return _run_deferred(pending, build, n_null, engine)


# --------------------------------------------------------------------------
# the one-pass form: collectors riding the shared fused scan
# --------------------------------------------------------------------------


class CollectorSpec:
    """One spill plan's ride on the shared fused scan.

    ``requests`` + ``ops`` slot into ``engine.run_scan`` next to the
    other ops; the ops' state is the device key buffer
    (``ScanOps.device_result`` keeps it out of the scan's fetch). After
    the scan, ``dispatch(final_state)`` launches this plan's sort and
    segment count and returns ``(pending, build)``: the caller dispatches
    EVERY plan first, fetches all pendings in one packed transfer, and
    calls ``build(fetched)`` to make the state. The planner attaches
    ``overflow_fallback`` (the host group-by) and ``scan_fallback`` (the
    deferred re-read, for when the shared scan fails) plus
    ``on_success``."""

    def __init__(self, plan, requests, ops, path, dispatch):
        self.plan = plan
        self.requests = list(requests)
        self.ops = ops
        self.path = path  # event label ("device-sort"[-joint])
        self._dispatch = dispatch
        self.on_success = lambda: None
        self.overflow_fallback = None
        self.scan_fallback = None

    def dispatch(self, state):
        return self._dispatch(state)


def _collector_ops(batch_keys, capacity: int, n_lanes: int, device):
    """The collector ``ScanOps``: state ``(buffers, offset, n_sentinel,
    n_null)``, each buffer a sentinel-filled (capacity,) int64 key lane
    on the device. Each batch writes its keys in place at the offset (a
    host int: every batch appends exactly its rows), so the buffers
    end full; unwritten slots, if any, stay sentinel and join the
    correction at dispatch."""
    from deequ_tpu_torch.analyzers.base import ScanOps

    def init():
        zero = torch.zeros((), dtype=torch.int64, device=device)
        return (
            [torch.full((capacity,), _SENTINEL, dtype=torch.int64, device=device)
             for _ in range(n_lanes)],
            0, zero, zero,
        )

    def update(state, batch):
        buffers, offset, ns, nn = state
        n = batch[ROW_MASK].shape[0]
        _keys, s, null = batch_keys(batch, [buf[offset:offset + n] for buf in buffers])
        return buffers, offset + n, ns + s, nn + null

    def merge(a, b):
        raise NotImplementedError(
            "collector states accumulate through ONE shared scan; "
            "they never merge across scans"
        )

    return ScanOps(init, update, merge, device_result=True)


def single_collector_spec(dataset: Dataset, plan, engine) -> CollectorSpec:
    """The one-pass twin of device_spill_frequencies."""
    requests, values_dtype, batch_keys = _single_key_builder(dataset, plan)
    capacity = engine.scan_row_capacity(dataset)
    ops = _collector_ops(batch_keys, capacity, 1, engine.device)

    def dispatch(state):
        buffers, offset, ns, nn = state
        pending, build = _finalize_state(
            plan, values_dtype, buffers, ns + (capacity - offset), None, 1, engine
        )
        return (pending, nn), build

    return CollectorSpec(plan, requests, ops, "device-sort", dispatch)


def joint_collector_spec(dataset: Dataset, plan, engine, dictionaries,
                         sizes) -> CollectorSpec:
    """The one-pass twin of device_spill_joint_frequencies."""
    requests, split, batch_keys = _joint_key_builder(dataset, plan, sizes)
    n_lanes = 1 if split == len(plan.columns) else 2
    capacity = engine.scan_row_capacity(dataset)
    ops = _collector_ops(batch_keys, capacity, n_lanes, engine.device)
    joint = (list(dictionaries), list(sizes))

    def dispatch(state):
        buffers, offset, ns, nn = state
        pending, build = _finalize_state(
            plan, np.dtype(np.int64), buffers, ns + (capacity - offset), joint, split, engine
        )
        return (pending, nn), build

    return CollectorSpec(plan, requests, ops, "device-sort-joint", dispatch)
