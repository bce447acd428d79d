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
                     codes).

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
from deequ_tpu_torch.analyzers.base import ScanOps, pad_pow2
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
from deequ_tpu_torch.data.table import ColumnRequest, Dataset
from deequ_tpu_torch.sketches import hll, scatter_max


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
    per (column tuple, repr) per fused step, shared across units."""
    key = _SHARED_PREFIX + suffix + ":" + "\x1f".join(columns)
    out = batch.get(key)
    if out is None:
        out = torch.stack([batch[f"{c}::{suffix}"] for c in columns])
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
    if value_repr == "codes":
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
        return S.ApproxCountDistinctState(torch.zeros((C, hll.M), dtype=torch.int8))

    def update(state, batch, consts_in=None):
        masks = _shared_stack(batch, columns, "mask")
        rows = _shared_rows(batch, where_fn, where)
        # one fused kernel each: rank, scatter and the max with the carry
        values = _shared_stack(batch, columns, value_repr)
        if value_repr == "codes":
            return S.ApproxCountDistinctState(
                scatter_max.hll_update_codes(
                    values, masks, rows, consts_in["h1"], consts_in["h2"], state.registers
                )
            )
        return S.ApproxCountDistinctState(
            scatter_max.hll_update(values, masks, rows, state.registers)
        )

    def extract(state, member_idx: int):
        return S.ApproxCountDistinctState(state.registers[member_cols[member_idx]])

    return ScanUnit(
        members,
        ScanOps(init, update, S.ApproxCountDistinctState.merge, consts=consts),
        requests,
        extract,
    )


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
    from deequ_tpu_torch.analyzers.hll import ApproxCountDistinct

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
                rep = dataset.hll_repr(a.column)
                dt = dataset.request_dtype(ColumnRequest(a.column, rep))
                return ("hll", rep, str(dt), a.where)
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
            else:
                units.append(_build_hll_group(dataset, members, key[1], key[3]))
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
    return units, failures
