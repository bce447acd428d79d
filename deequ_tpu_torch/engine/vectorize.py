"""Vectorizing scan planner: stack same-kind columns into (C, B) ops.

Counterpart of ``deequ_tpu/engine/vectorize.py``. Analyzers of the same
family over columns of the same device dtype and the same ``where``
filter share one stacked op:

- ``stats``        — Mean/Sum/Minimum/Maximum/StandardDeviation (values)
                     and MinLength/MaxLength (lengths): one (C, B)
                     masked reduction per needed statistic, with the
                     Welford/Chan merge vectorized over columns;
- ``completeness`` — Completeness: one (C, B) mask count;
- ``hll``          — ApproxCountDistinct: ONE register update for all
                     C columns (numeric: the fused hash-rank-scatter
                     kernel over the stacked values; dictionary-encoded
                     strings: the fused codes kernel over the stacked
                     codes);
- ``kll``          — KLLSketch/ApproxQuantile/ApproxQuantiles sharing
                     (params, where): ONE batched (C, B) sort and strided
                     sample a step, folded on the host (``ScanOps
                     .host_fold``);
- ``datatype``     — DataType of string columns: one (C, B) gather
                     through the stacked bucket tables and one
                     scatter-add into (C, 8) counts.

Groups form exactly as the JAX package forms them: a family key with
two or more analyzers becomes a group, a key with one stays a single.
Group states hold (C,)-shaped leaves; after the scan each member's
ordinary state (``analyzers/states.py``) is sliced back out, so metric
finalization, carried-over states and merges are those of the single
path. A ``where`` filter is computed once per batch and shared by every
group with the same filter (``_shared_rows``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deequ_tpu_torch.analyzers import states as S
from deequ_tpu_torch.analyzers.base import DELTA_PRIME, ScanOps, pad_pow2
from deequ_tpu_torch.analyzers.basic import (
    _acc_float,
    _compile_where,
    _mcount,
    _mmax,
    _mmin,
    _msum,
    _row_mask,
    _welford_batch,
)
from deequ_tpu_torch.analyzers.datatype import datatype_counts, dictionary_buckets
from deequ_tpu_torch.sql import predicate as sql_predicate
from deequ_tpu_torch.analyzers.kll import (
    kll_float32,
    kll_fold,
    kll_init,
    kll_sample,
    kll_sort,
)
from deequ_tpu_torch.data.table import ColumnRequest, Dataset, Kind
from deequ_tpu_torch.sketches import hll, scatter_max
from deequ_tpu_torch.sketches.kll import KLLSketchState


@dataclass
class ScanUnit:
    """One engine slot: a single analyzer's ops or a vectorized group.
    ``extract(state, member_index)`` slices a member's ordinary state out
    of a group state (None for singles)."""

    members: List[Any]  # analyzers, in column order
    ops: ScanOps
    requests: List[ColumnRequest]
    extract: Optional[Callable[[Any, int], Any]] = None

    def device_requests(self, dataset: Dataset) -> List[ColumnRequest]:
        return self.requests


def _index_members(members: Sequence[Any]) -> Tuple[List[str], List[int]]:
    """Dedup member columns preserving order; returns (columns,
    member->column-index map)."""
    columns: List[str] = []
    col_index: Dict[str, int] = {}
    for a in members:
        if a.column not in col_index:
            col_index[a.column] = len(columns)
            columns.append(a.column)
    return columns, [col_index[a.column] for a in members]


def _delta_cap_of(dataset: Dataset, columns: List[str]) -> Optional[int]:
    """The width of a group's delta lookup tables when EVERY member
    column ships one-pass dictionary deltas (a parquet source's
    ``dict_delta_capacity``), else None: the group then keeps its tables
    in consts. Asking commits the columns to delta mode, so the plan and
    the stream cannot disagree."""
    cap_fn = getattr(dataset, "dict_delta_capacity", None)
    if cap_fn is None:
        return None
    caps = [cap_fn(c) for c in columns]
    if not caps or any(cap is None for cap in caps):
        return None
    return int(max(caps))


def _delta_overflow(column: str, needed: int, cap: int) -> RuntimeError:
    return RuntimeError(
        f"dictionary for column {column!r} grew to {needed} values, "
        f"past dict_delta_capacity={cap}: raise "
        "DEEQU_TPU_DICT_DELTA_CAPACITY or set dict_deltas=False to "
        "fall back to the pre-pass consts path"
    )


def _delta_items(dataset: Dataset, columns: List[str], col_index: Dict[str, int],
                 deltas, cap: int):
    """(row, start, values) of each delta (or, under DELTA_PRIME, each
    whole dictionary) for the group's columns; raises past ``cap``."""
    if deltas is DELTA_PRIME:
        items = [(c, 0, dataset.dictionary(c)) for c in columns]
    else:
        items = [(c, d["start"], d["values"]) for c, d in deltas.items() if c in col_index]
    out = []
    for c, start, values in items:
        if start + len(values) > cap:
            raise _delta_overflow(c, start + len(values), cap)
        out.append((col_index[c], start, values))
    return out


def _set_lut_rows(lut: torch.Tensor, row: int, start: int, values: np.ndarray, fill) -> None:
    """Write ``values`` into ``lut[row, start:]`` in place, on the
    current stream (a full ship, ``start == 0``, first resets the row
    to ``fill``). The values cross from a fresh host array that nothing
    writes to afterwards."""
    if start == 0:
        lut[row].fill_(fill)
    if len(values):
        lut[row, start:start + len(values)].copy_(torch.from_numpy(np.ascontiguousarray(values)))


def _stack_luts(luts: List[np.ndarray], fill=0) -> np.ndarray:
    """Stack per-column LUTs into one (C, L) const, padding every LUT to
    the group max and then to a power of two, as the JAX package does."""
    width = max(len(lut) for lut in luts)
    return np.stack(
        [
            pad_pow2(np.pad(lut, (0, width - len(lut)), constant_values=fill), fill)
            for lut in luts
        ]
    )


# Every unit of a fused step receives the SAME batch dict, so the first
# unit that needs a stacked (C, B) block stores it back into the dict
# under a reserved key and later units reuse it.
_SHARED_PREFIX = "__shared__:"


def _shared_stack(batch, columns, suffix) -> torch.Tensor:
    """Memoized ``torch.stack([batch[f"{c}::{suffix}"] ...])``: one stack
    per (column tuple, repr) per fused step, shared across units. A float
    stack is flushed in place as it is made (``flush_subnormals``): the
    stats ops read it so, and the HLL hash flushes its input anyway, so
    the step holds one copy of the block."""
    key = _SHARED_PREFIX + suffix + ":" + "\x1f".join(columns)
    out = batch.get(key)
    if out is None:
        out = sql_predicate.flush_subnormals(
            torch.stack([batch[f"{c}::{suffix}"] for c in columns]), inplace=True)
        batch[key] = out
    return out


def _shared_rows(batch, where_fn, where: Optional[str]) -> torch.Tensor:
    """Memoized ``_row_mask``: one row-validity vector per (batch,
    where-expression) — every group with the same filter reuses it."""
    key = _SHARED_PREFIX + "rows:" + repr(where)
    out = batch.get(key)
    if out is None:
        out = _row_mask(batch, where_fn)
        batch[key] = out
    return out


# --------------------------------------------------------------------------
# stats family
# --------------------------------------------------------------------------

_STATS_NEED = {
    "Mean": ("sum",),
    "Sum": ("sum",),
    "Minimum": ("min",),
    "Maximum": ("max",),
    "MinLength": ("min",),
    "MaxLength": ("max",),
    "StandardDeviation": ("sum", "welford"),
}


def _build_stats_group(
    dataset: Dataset, members: List[Any], repr_name: str, where: Optional[str]
) -> ScanUnit:
    """members: stats analyzers sharing (repr, value dtype, where)."""
    where_fn, where_reqs = _compile_where(where, dataset)
    columns, member_cols = _index_members(members)
    needs = set()
    for a in members:
        needs.update(_STATS_NEED[type(a).__name__])
    requests = [
        r
        for c in columns
        for r in (ColumnRequest(c, repr_name), ColumnRequest(c, "mask"))
    ] + where_reqs
    C = len(columns)
    acc = _acc_float()

    def init():
        state = {"n": torch.zeros(C, dtype=torch.int64)}
        if "sum" in needs:
            state["sum"] = torch.zeros(C, dtype=acc)
        if "min" in needs:  # NaN = nan_largest_min identity (states.py)
            state["min"] = torch.full((C,), float("nan"), dtype=torch.float64)
        if "max" in needs:
            state["max"] = torch.full((C,), float("-inf"), dtype=torch.float64)
        if "welford" in needs:
            z = torch.zeros(C, dtype=torch.float64)
            state["w"] = S.StandardDeviationState(z, z.clone(), z.clone())
        return state

    def update(state, batch):
        x = _shared_stack(batch, columns, repr_name)
        masks = _shared_stack(batch, columns, "mask")
        masks = masks & _shared_rows(batch, where_fn, where)[None, :]
        new = dict(state)
        n_b = _mcount(masks, dim=1)
        new["n"] = state["n"] + n_b
        sum_b = None
        if "sum" in needs:
            sum_b = _msum(x, masks, dim=1)
            new["sum"] = state["sum"] + sum_b
        if "min" in needs:
            new["min"] = S.nan_largest_min(state["min"], _mmin(x, masks, dim=1))
        if "max" in needs:
            new["max"] = torch.maximum(state["max"], _mmax(x, masks, dim=1))
        if "welford" in needs:
            new["w"] = S.StandardDeviationState.merge(
                state["w"], _welford_batch(x, masks, sum_b, n_b, dim=1)
            )
        return new

    def merge(a, b):
        out = {"n": a["n"] + b["n"]}
        if "sum" in needs:
            out["sum"] = a["sum"] + b["sum"]
        if "min" in needs:
            out["min"] = S.nan_largest_min(a["min"], b["min"])
        if "max" in needs:
            out["max"] = torch.maximum(a["max"], b["max"])
        if "welford" in needs:
            out["w"] = S.StandardDeviationState.merge(a["w"], b["w"])
        return out

    def extract(state, member_idx: int):
        i = member_cols[member_idx]
        name = type(members[member_idx]).__name__
        n = state["n"][i]
        if name == "Mean":
            return S.MeanState(state["sum"][i], n)
        if name == "Sum":
            return S.SumState(state["sum"][i], n)
        if name in ("Minimum", "MinLength"):
            return S.MinState(state["min"][i], n)
        if name in ("Maximum", "MaxLength"):
            return S.MaxState(state["max"][i], n)
        w = state["w"]
        return S.StandardDeviationState(w.n[i], w.avg[i], w.m2[i])

    return ScanUnit(members, ScanOps(init, update, merge), requests, extract)


# --------------------------------------------------------------------------
# completeness family
# --------------------------------------------------------------------------


def _build_completeness_group(
    dataset: Dataset, members: List[Any], where: Optional[str]
) -> ScanUnit:
    where_fn, where_reqs = _compile_where(where, dataset)
    columns, member_cols = _index_members(members)
    requests = [ColumnRequest(c, "mask") for c in columns] + where_reqs
    C = len(columns)

    def init():
        return {
            "matches": torch.zeros(C, dtype=torch.int64),
            "rows": torch.zeros((), dtype=torch.int64),
        }

    def update(state, batch):
        rows = _shared_rows(batch, where_fn, where)
        valid = _shared_stack(batch, columns, "mask") & rows[None, :]
        return {
            "matches": state["matches"] + _mcount(valid, dim=1),
            "rows": state["rows"] + _mcount(rows),
        }

    def merge(a, b):
        return {
            "matches": a["matches"] + b["matches"],
            "rows": a["rows"] + b["rows"],
        }

    def extract(state, member_idx: int):
        return S.NumMatchesAndCount(
            state["matches"][member_cols[member_idx]], state["rows"]
        )

    return ScanUnit(members, ScanOps(init, update, merge), requests, extract)


# --------------------------------------------------------------------------
# hll family
# --------------------------------------------------------------------------


def _build_hll_group(
    dataset: Dataset,
    members: List[Any],
    value_repr: str,  # "values" | "bits" (uint64) | "codes" (string)
    where: Optional[str],
) -> ScanUnit:
    where_fn, where_reqs = _compile_where(where, dataset)
    columns, member_cols = _index_members(members)
    requests = [
        r
        for c in columns
        for r in (ColumnRequest(c, value_repr), ColumnRequest(c, "mask"))
    ] + where_reqs
    C = len(columns)

    consts = None
    # one-pass dictionary deltas: when every member column ships them,
    # the hash tables live in the STATE at a fixed (C, cap) width and
    # host_delta writes each delta's hashes in as it arrives, so no
    # dictionary is read at plan time
    delta_cap = _delta_cap_of(dataset, columns) if value_repr == "codes" else None
    if value_repr == "codes" and delta_cap is None:
        luts1, luts2 = [], []
        for c in columns:
            h1, h2 = hll.dictionary_hash_pairs(dataset.dictionary(c))
            luts1.append(h1)
            luts2.append(h2)
        consts = {
            "h1": torch.from_numpy(_stack_luts(luts1).astype(np.int64)),
            "h2": torch.from_numpy(_stack_luts(luts2).astype(np.int64)),
        }

    def init():
        registers = torch.zeros((C, hll.M), dtype=torch.int8)
        if delta_cap is not None:
            return {
                "registers": registers,
                "h1": torch.zeros((C, delta_cap), dtype=torch.int64),
                "h2": torch.zeros((C, delta_cap), dtype=torch.int64),
            }
        return S.ApproxCountDistinctState(registers)

    def update(state, batch, consts_in=None):
        registers = state["registers"] if delta_cap is not None else state.registers
        masks = _shared_stack(batch, columns, "mask")
        rows = _shared_rows(batch, where_fn, where)
        # one fused kernel each: rank, scatter and the max with the carry
        values = _shared_stack(batch, columns, value_repr)
        if value_repr != "codes":
            return S.ApproxCountDistinctState(
                scatter_max.hll_update(values, masks, rows, registers)
            )
        luts = state if delta_cap is not None else consts_in
        new = scatter_max.hll_update_codes(values, masks, rows, luts["h1"], luts["h2"], registers)
        if delta_cap is not None:
            return {"registers": new, "h1": state["h1"], "h2": state["h2"]}
        return S.ApproxCountDistinctState(new)

    def extract(state, member_idx: int):
        registers = state["registers"] if delta_cap is not None else state.registers
        return S.ApproxCountDistinctState(registers[member_cols[member_idx]])

    merge = S.ApproxCountDistinctState.merge
    host_delta = None
    if delta_cap is not None:
        col_index = {c: i for i, c in enumerate(columns)}

        def merge(a, b):
            # the registers are the monoid; every shard follows the same
            # dictionary, so the maximum keeps the (equal) tables
            return {k: torch.maximum(a[k], b[k]) for k in ("registers", "h1", "h2")}

        def host_delta(state, deltas):
            for row, start, values in _delta_items(dataset, columns, col_index, deltas, delta_cap):
                h1, h2 = hll.dictionary_hash_pairs(np.asarray(values, dtype=object))
                n = len(values)
                _set_lut_rows(state["h1"], row, start, h1[:n].astype(np.int64), 0)
                _set_lut_rows(state["h2"], row, start, h2[:n].astype(np.int64), 0)
            return state

    return ScanUnit(
        members,
        ScanOps(init, update, merge, consts=consts, host_delta=host_delta),
        requests,
        extract,
    )


# --------------------------------------------------------------------------
# kll family (host-folded quantile sketches)
# --------------------------------------------------------------------------


def _kll_sorted_stack(batch, columns, where_fn, where=None):
    """THE one construction of a KLL group's masked float32 sort
    (``analyzers/kll.py::kll_sort``), memoized in the shared batch dict
    by columns and filter: every unit of a step that needs the sort of
    the same columns reuses it."""
    key = _SHARED_PREFIX + "kllsort:" + repr(where) + ":" + "\x1f".join(columns)
    hit = batch.get(key)
    if hit is None:
        masks = _shared_stack(batch, columns, "mask") & _shared_rows(batch, where_fn, where)[None, :]
        x = torch.stack([kll_float32(batch[f"{c}::values"]) for c in columns])
        hit = kll_sort(x, masks)
        batch[key] = hit
    return hit


def _build_kll_group(dataset: Dataset, members: List[Any], where: Optional[str]) -> ScanUnit:
    """KLLSketch/ApproxQuantile/ApproxQuantiles sharing (params, where):
    ONE batched (C, B) sort and strided sample per step instead of C
    sorts; the host folds each column's samples into its sketch.
    Analyzers over the SAME column share one sketch."""
    params = members[0].params
    columns, member_cols = _index_members(members)
    where_fn, where_reqs = _compile_where(where, dataset)
    requests = [
        r
        for c in columns
        for r in (ColumnRequest(c, "values"), ColumnRequest(c, "mask"))
    ] + where_reqs
    C = len(columns)
    k = params.sketch_size

    def update(_state, batch):
        return kll_sample(_kll_sorted_stack(batch, columns, where_fn, where), k)

    def host_init():
        return [KLLSketchState(params) for _ in range(C)]

    def host_fold(accs, out):
        return [kll_fold(acc, out, i) for i, acc in enumerate(accs)]

    def merge(a, b):
        return [KLLSketchState.merge(x, y) for x, y in zip(a, b)]

    def extract(accs, member_idx: int):
        return accs[member_cols[member_idx]]

    return ScanUnit(
        members,
        ScanOps(
            lambda: kll_init(C, k), update, merge,
            host_init=host_init, host_fold=host_fold,
        ),
        requests,
        extract,
    )


# --------------------------------------------------------------------------
# datatype family (string columns only)
# --------------------------------------------------------------------------


def _build_datatype_group(dataset: Dataset, members: List[Any], where: Optional[str]) -> ScanUnit:
    """DataType over C dictionary-encoded columns: the bucket tables
    stack into one (C, D) const (padded with STRING, as the JAX package
    pads them); the counts of a step are one gather and one scatter-add
    (``analyzers/datatype.py::datatype_counts``)."""
    columns, member_cols = _index_members(members)
    where_fn, where_reqs = _compile_where(where, dataset)
    requests = [
        r
        for c in columns
        for r in (ColumnRequest(c, "codes"), ColumnRequest(c, "mask"))
    ] + where_reqs
    C = len(columns)
    STRING = S.DataTypeHistogram.STRING
    consts = None
    # one-pass dictionary deltas: the bucket table lives in the state,
    # classified delta by delta (see _build_hll_group)
    delta_cap = _delta_cap_of(dataset, columns)
    if delta_cap is None:
        luts = [dictionary_buckets(dataset.dictionary(c)) for c in columns]
        consts = {"lut": torch.from_numpy(_stack_luts(luts, STRING))}

    def init():
        state = {"counts": torch.zeros((C, 6), dtype=torch.int64)}
        if delta_cap is not None:
            # slots past the shipped dictionary read STRING, as the consts
            # form's padding does; no valid code reaches them
            state["lut"] = torch.full((C, delta_cap), STRING, dtype=torch.int64)
        return state

    def update(state, batch, consts_in=None):
        rows = _shared_rows(batch, where_fn, where)
        valid = _shared_stack(batch, columns, "mask") & rows[None, :]
        codes = _shared_stack(batch, columns, "codes")
        table = state["lut"] if delta_cap is not None else consts_in["lut"]
        new = dict(state)
        new["counts"] = state["counts"] + datatype_counts(codes, valid, rows, table)
        return new

    def merge(a, b):
        out = {"counts": a["counts"] + b["counts"]}
        if delta_cap is not None:
            out["lut"] = torch.maximum(a["lut"], b["lut"])
        return out

    def extract(state, member_idx: int):
        return S.DataTypeHistogram(state["counts"][member_cols[member_idx]])

    host_delta = None
    if delta_cap is not None:
        col_index = {c: i for i, c in enumerate(columns)}

        def host_delta(state, deltas):
            for row, start, values in _delta_items(dataset, columns, col_index, deltas, delta_cap):
                buckets = dictionary_buckets(np.asarray(values, dtype=object))[:len(values)]
                _set_lut_rows(state["lut"], row, start, buckets, STRING)
            return state

    return ScanUnit(members, ScanOps(init, update, merge, consts=consts, host_delta=host_delta),
                    requests, extract)


# --------------------------------------------------------------------------
# planner
# --------------------------------------------------------------------------


def plan_scan_units(
    dataset: Dataset, analyzers: Sequence[Any]
) -> Tuple[List[ScanUnit], Dict[Any, BaseException]]:
    """Partition analyzers into vectorized groups + singles.

    Returns (units, plan_failures). Grouping keys include the device
    dtype of the stacked repr and the ``where`` expression; anything
    else, or a group whose build fails, falls back to each analyzer's
    own ``make_ops`` — whose failure becomes that analyzer's failure
    metric.
    """
    from deequ_tpu_torch.analyzers.basic import (
        Completeness,
        Maximum,
        MaxLength,
        Mean,
        Minimum,
        MinLength,
        StandardDeviation,
        Sum,
    )
    from deequ_tpu_torch.analyzers.datatype import DataType
    from deequ_tpu_torch.analyzers.hll import ApproxCountDistinct
    from deequ_tpu_torch.analyzers.kll import ApproxQuantile, ApproxQuantiles, KLLSketch

    groups: Dict[tuple, List[Any]] = {}
    singles: List[Any] = []
    failures: Dict[Any, BaseException] = {}

    def group_key(a) -> Optional[tuple]:
        t = type(a)
        try:
            if t in (Mean, Sum, Minimum, Maximum, StandardDeviation):
                dt = dataset.request_dtype(ColumnRequest(a.column, "values"))
                return ("stats", "values", str(dt), a.where)
            if t in (MinLength, MaxLength):
                return ("stats", "lengths", "int32", a.where)
            if t is Completeness:
                return ("completeness", a.where)
            if t is ApproxCountDistinct:
                # The JAX package pools a float32 (or narrow-range integer)
                # HLL column that a same-filter KLL group covers into that
                # group's sort (for its sorted-dedup registers). The
                # port does not: such a column stays on K1's fused entry,
                # whose registers equal the JAX package's either way.
                rep = dataset.hll_repr(a.column)
                dt = dataset.request_dtype(ColumnRequest(a.column, rep))
                return ("hll", rep, str(dt), a.where)
            if t is DataType and dataset.schema.kind_of(a.column) == Kind.STRING:
                dt = dataset.request_dtype(ColumnRequest(a.column, "codes"))
                return ("datatype", str(dt), a.where)
            if t in (KLLSketch, ApproxQuantile, ApproxQuantiles):
                # values cast to float32 inside the step, so mixed input
                # dtypes stack; sketches are keyed by params + where
                return ("kll", a.params.sketch_size, a.params.shrinking_factor, a.where)
        except Exception:  # noqa: BLE001 — fall back to the single path
            return None
        return None

    for a in analyzers:
        key = group_key(a)
        if key is None:
            singles.append(a)
        else:
            groups.setdefault(key, []).append(a)

    units: List[ScanUnit] = []
    for key, members in groups.items():
        if len(members) == 1:
            singles.extend(members)
            continue
        try:
            if key[0] == "stats":
                units.append(_build_stats_group(dataset, members, key[1], key[3]))
            elif key[0] == "completeness":
                units.append(_build_completeness_group(dataset, members, key[1]))
            elif key[0] == "hll":
                units.append(_build_hll_group(dataset, members, key[1], key[3]))
            elif key[0] == "kll":
                units.append(_build_kll_group(dataset, members, key[3]))
            else:
                units.append(_build_datatype_group(dataset, members, key[2]))
        except Exception:  # noqa: BLE001 — vectorization is an
            # optimization; degrade to the per-analyzer path
            singles.extend(members)

    for a in singles:
        try:
            units.append(
                ScanUnit([a], a.make_ops(dataset), a.device_requests(dataset), None)
            )
        except Exception as exc:  # noqa: BLE001
            failures[a] = exc
    if units:
        from deequ_tpu_torch.telemetry import get_telemetry

        tm = get_telemetry()
        tm.counter("engine.vectorize.units").inc(len(units))
        tm.counter("engine.vectorize.stacked_members").inc(
            sum(len(u.members) for u in units if len(u.members) > 1))
    return units, failures
