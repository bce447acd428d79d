"""Row-level verification results: each row's pass or fail a constraint.

Counterpart of ``deequ_tpu/verification/rowlevel.py`` (the reference's
``rowLevelResultsAsDataFrame``): a row-level-capable constraint also
gives one boolean outcome a row. The families:

- **mask and predicate**: Completeness, Compliance (and every Check
  method that compiles to it: ``is_contained_in``, ``is_non_negative``,
  ``satisfies``, ...), PatternMatch (and ``contains_email``, ...);
- **grouping**: Uniqueness and UniqueValueRatio; a row passes when its
  key occurs once (multi-column keys too);
- **asserted value**: MinLength and MaxLength (each row's string
  length) and Minimum and Maximum (each row's value) apply the
  constraint's OWN assertion to each row, so ``has_min_length("s",
  lambda v: v >= 3)`` marks exactly the short rows. Null rows pass
  (Completeness is the analyzer that flags them).

A row that a ``where`` filter excludes passes under the default
``filtered_row_outcome="true"``, and is null under ``"null"`` (the
column is then a nullable boolean).

Everything runs on torch tensors on the engine's device, a chunk of
rows at a time, with no Python a row: predicates through
``sql/predicate.py``, an assertion once a DISTINCT value of the column
(each chunk's distinct values found on the device) and gathered back,
groups through ``torch.unique`` within a partition of the rows by a
hash of their key.
The host holds each column the constraints read, as the JAX package's
oracle does; the device holds one chunk or one partition, so the
device memory of an export does not grow with the table.
An unplannable predicate or ``where``, or an assertion that raises,
drops only its own column (the aggregate result already reported it).
Memory pressure and a device fault are not such failures: they raise.
"""

from __future__ import annotations

import re
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deequ_tpu_torch import config
from deequ_tpu_torch.analyzers.base import Analyzer
from deequ_tpu_torch.analyzers.basic import (
    Completeness,
    Compliance,
    Maximum,
    MaxLength,
    Minimum,
    MinLength,
    PatternMatch,
)
from deequ_tpu_torch.analyzers.grouping import Uniqueness, UniqueValueRatio
from deequ_tpu_torch.constraints.constraint import AnalysisBasedConstraint, ConstraintDecorator
from deequ_tpu_torch.data.table import (
    ROW_MASK,
    ColumnRequest,
    Dataset,
    Kind,
    dictionary_utf8_lengths,
)
from deequ_tpu_torch.engine.memory import classify_memory_pressure, is_device_fault
from deequ_tpu_torch.sql.predicate import compile_predicate

#: rows a chunk when neither the caller nor ``config.batch_size`` sets
#: it: the scan's default batch
DEFAULT_CHUNK_ROWS = 1 << 21
#: a key partition larger than this many chunks (a skewed key) is
#: grouped on the host instead
_HOST_PARTITION_CHUNKS = 2

# the splitmix64 finalizer's multipliers as signed int64
_MIX1 = 0xBF58476D1CE4E5B9 - (1 << 64)
_MIX2 = 0x94D049BB133111EB - (1 << 64)


def _to_device(host: np.ndarray, device) -> torch.Tensor:
    if not (host.flags.writeable and host.flags.c_contiguous):
        host = np.array(host, copy=True)
    return torch.from_numpy(host).to(device)


class _OracleCache:
    """One export's host columns: each column representation the
    row-level constraints read is materialized once, and a ``where``
    shared by several constraints evaluated once. The device sees a
    chunk of ``chunk_rows`` rows at a time. It lives for one
    ``row_level_results`` call or one egress finalize."""

    def __init__(self, data: Dataset, device=None, chunk_rows: Optional[int] = None):
        self._data = data
        self.device = config.resolve_device(device)
        self.chunk_rows = max(
            int(chunk_rows or config.options().batch_size or DEFAULT_CHUNK_ROWS), 1)
        self._arrays: Dict[str, np.ndarray] = {}
        self._where: Dict[str, Optional[np.ndarray]] = {}

    def host(self, req: ColumnRequest) -> np.ndarray:
        out = self._arrays.get(req.key)
        if out is None:
            if req.repr == "lengths":
                # a string's length through its dictionary entry's
                # (slot 0: the null code's)
                table = np.concatenate(
                    [[0], dictionary_utf8_lengths(self._data.dictionary(req.column))]
                ).astype(np.int32)
                out = table[self.host(ColumnRequest(req.column, "codes")).astype(np.int64) + 1]
            else:
                out = np.asarray(self._data.materialize(req))
            self._arrays[req.key] = out
        return out

    def batches(self, requests: Sequence[ColumnRequest]
                ) -> Iterator[Tuple[int, int, Dict[str, torch.Tensor]]]:
        """``(lo, hi, batch)`` over the table in chunks: each request and
        its column's mask for rows ``lo:hi`` on the device, and the row
        mask."""
        reqs = list(requests)
        keys = {r.key for r in reqs}
        for r in list(reqs):
            mask = ColumnRequest(r.column, "mask")
            if mask.key not in keys:
                keys.add(mask.key)
                reqs.append(mask)
        n = self._data.num_rows
        for lo in range(0, n, self.chunk_rows):
            hi = min(lo + self.chunk_rows, n)
            batch = {r.key: _to_device(self.host(r)[lo:hi], self.device) for r in reqs}
            batch[ROW_MASK] = torch.ones(hi - lo, dtype=torch.bool, device=self.device)
            yield lo, hi, batch

    def rowwise(self, fn, requests: Sequence[ColumnRequest]) -> np.ndarray:
        """``fn(batch)``, a boolean a row, over the table chunk by chunk."""
        out = np.empty(self._data.num_rows, dtype=bool)
        for lo, hi, batch in self.batches(requests):
            out[lo:hi] = fn(batch).cpu().numpy()
        return out


def _where_pass(where: Optional[str], data: Dataset,
                cache: _OracleCache) -> Optional[np.ndarray]:
    """True for the rows a ``where`` filter EXCLUDES (they pass by
    default); None without a filter."""
    if where is None:
        return None
    if where in cache._where:
        return cache._where[where]
    pred = compile_predicate(where, data)
    out = cache.rowwise(lambda batch: ~pred.complies(batch), pred.requests)
    cache._where[where] = out
    return out


def _asserted_per_value(parts, num_rows: int, assertion) -> Optional[np.ndarray]:
    """``assertion(value)`` for every row, evaluated once a DISTINCT
    value of the column and gathered back. ``parts`` holds each chunk's
    ``(lo, hi, valid, uniques, inverse)`` on the host: its valid rows'
    distinct values and each valid row's index into them. Invalid (null)
    rows pass, and their placeholder values never reach the assertion (a
    partial one such as ``1/v > 0`` must not see values outside its
    domain). An assertion that raises drops the column (None), as the
    aggregate result already reported the same exception."""
    out = np.ones(num_rows, dtype=bool)
    if not parts:
        return out
    uniques = np.unique(np.concatenate([p[3] for p in parts]))
    try:
        lut = np.fromiter((bool(assertion(v)) for v in uniques.tolist()), dtype=bool,
                          count=len(uniques))
    except Exception:  # noqa: BLE001 — degrade, as the aggregate result does
        return None
    for lo, hi, valid, chunk_uniques, inverse in parts:
        out[lo:hi][valid] = lut[np.searchsorted(uniques, chunk_uniques)][inverse]
    return out


def _group_key(values: torch.Tensor) -> torch.Tensor:
    """An exact int64 grouping key of one column's values: floats by
    their bits with every NaN one value and -0.0 as +0.0 (as
    ``np.unique`` groups them), integers and booleans as they are."""
    if values.is_floating_point():
        x = values.to(torch.float64) + 0.0
        x = torch.where(torch.isnan(x), torch.full_like(x, float("nan")), x)
        return x.view(torch.int64)
    return values.to(torch.int64)


def _inverse(key: torch.Tensor) -> torch.Tensor:
    return torch.unique(key, return_inverse=True)[1]


def _mix(x: torch.Tensor) -> torch.Tensor:
    """splitmix64's finalizer in wrapping int64 arithmetic (its shifts
    are arithmetic: still a fixed function of the key)."""
    x = (x ^ (x >> 30)) * _MIX1
    x = (x ^ (x >> 27)) * _MIX2
    return x ^ (x >> 31)


def _group_ids(keys: List[Tuple[torch.Tensor, torch.Tensor]]) -> torch.Tensor:
    """One exact group id a row, folded column by column over
    ``(values, mask)`` pairs; validity joins the key, so null is a value
    of its own."""
    m = keys[0][0].shape[0]
    groups: Optional[torch.Tensor] = None
    for values, mask in keys:
        ids = _inverse(_group_key(values)) * 2 + mask.to(torch.int64)
        groups = ids if groups is None else groups * (2 * m) + ids
        groups = _inverse(groups)
    return groups


def _unique_outcome(analyzer: Analyzer, data: Dataset, cache: _OracleCache,
                    excluded: Optional[np.ndarray]) -> np.ndarray:
    """Uniqueness's pass a row: its key occurs once among the rows the
    filter keeps. The rows are partitioned by a hash of their key into
    parts of about one chunk, so every occurrence of a key lands in one
    part, and each part is grouped exactly on the device (a part that a
    skewed key makes larger than ``_HOST_PARTITION_CHUNKS`` chunks, on
    the host)."""
    reqs = [ColumnRequest(c, "codes" if data.schema.kind_of(c) == Kind.STRING
                          else data.hll_repr(c))
            for c in analyzer.grouping_columns()]
    pairs = [(cache.host(r), cache.host(ColumnRequest(r.column, "mask"))) for r in reqs]
    n = data.num_rows
    out = np.zeros(n, dtype=bool)
    if n == 0 or not pairs:
        return out
    parts = min(-(-n // cache.chunk_rows), (1 << 15) - 1)
    if parts == 1:
        order, bounds = None, np.array([0, n])
    else:
        bucket = np.empty(n, dtype=np.int16)
        for lo, hi, batch in cache.batches(reqs):
            h = torch.zeros(hi - lo, dtype=torch.int64, device=cache.device)
            for r in reqs:
                key = _group_key(batch[r.key]) * 2 + batch[f"{r.column}::mask"].to(torch.int64)
                h = _mix(h ^ key)
            bucket[lo:hi] = torch.remainder(h, parts).to(torch.int16).cpu().numpy()
        order = np.argsort(bucket, kind="stable")  # a radix sort of int16
        bounds = np.concatenate([[0], np.cumsum(np.bincount(bucket, minlength=parts))])
        del bucket
    for p in range(len(bounds) - 1):
        lo, hi = int(bounds[p]), int(bounds[p + 1])
        if hi == lo:
            continue
        idx = None if order is None else order[lo:hi]
        device = (cache.device if hi - lo <= _HOST_PARTITION_CHUNKS * cache.chunk_rows
                  else torch.device("cpu"))

        def part(host: np.ndarray) -> torch.Tensor:
            return _to_device(host if idx is None else host[idx], device)

        groups = _group_ids([(part(v), part(m)) for v, m in pairs])
        weight = (torch.ones_like(groups) if excluded is None
                  else (~part(excluded)).to(torch.int64))
        # occurrences within the FILTERED rows only: a key unique inside
        # the filter passes even when an excluded row shares it
        counts = torch.zeros(hi - lo, dtype=torch.int64, device=device)
        counts.scatter_add_(0, groups, weight)
        passes = (counts[groups] == 1).cpu().numpy()
        if idx is None:
            out[:] = passes
        else:
            out[idx] = passes
    return out


def _outcome_for(
    analyzer: Analyzer,
    data: Dataset,
    cache: _OracleCache,
    assertion=None,
    excluded: Optional[np.ndarray] = None,
) -> Optional[np.ndarray]:
    """One constraint's per-row pass booleans (a host array), or None
    for an analyzer that is not row-level capable (or whose assertion
    raised)."""

    def asserted(repr_name: str) -> Optional[np.ndarray]:
        data.check_row_level_repr(analyzer.column, repr_name)
        req = ColumnRequest(analyzer.column, repr_name)
        mask_key = f"{analyzer.column}::mask"
        parts = []
        for lo, hi, batch in cache.batches([req]):
            valid = batch[mask_key]
            if excluded is not None:
                # rows a where filter excludes are outside the assertion's
                # domain, as nulls are (their outcome is set by the caller)
                valid = valid & ~_to_device(excluded[lo:hi], cache.device)
            uniques, inverse = torch.unique(batch[req.key][valid], return_inverse=True)
            parts.append((lo, hi, valid.cpu().numpy(), uniques.cpu().numpy(),
                          inverse.cpu().numpy()))
        return _asserted_per_value(parts, data.num_rows, assertion)

    if isinstance(analyzer, (MinLength, MaxLength)):
        return None if assertion is None else asserted("lengths")
    if isinstance(analyzer, (Minimum, Maximum)):
        return None if assertion is None else asserted("values")
    if isinstance(analyzer, Completeness):
        return np.array(cache.host(ColumnRequest(analyzer.column, "mask")), dtype=bool)
    if isinstance(analyzer, Compliance):
        pred = compile_predicate(analyzer.predicate, data)
        return cache.rowwise(pred.complies, pred.requests)
    if isinstance(analyzer, PatternMatch):
        col = analyzer.column
        dictionary = data.dictionary(col)
        prog = re.compile(analyzer.pattern)
        lut = np.zeros(max(len(dictionary), 1) + 1, dtype=bool)
        for i, value in enumerate(dictionary):
            if value is not None and prog.search(str(value)):
                lut[i] = True
        lut_d = torch.from_numpy(lut).to(cache.device)

        def matches(batch):
            codes = batch[f"{col}::codes"].to(torch.int64)
            idx = torch.where(codes < 0, len(lut) - 1, codes).clamp(0, len(lut) - 1)
            return lut_d[idx] & batch[f"{col}::mask"]

        return cache.rowwise(matches, [ColumnRequest(col, "codes")])
    if isinstance(analyzer, (Uniqueness, UniqueValueRatio)):
        for c in analyzer.grouping_columns():
            if data.schema.kind_of(c) != Kind.STRING:
                data.check_row_level_repr(c, "values")
        return _unique_outcome(analyzer, data, cache, excluded)
    return None


def _fails_the_run(exc: BaseException) -> bool:
    """Memory pressure and device faults fail an export; any other
    exception drops only its constraint's column."""
    return classify_memory_pressure(exc) is not None or is_device_fault(exc)


def _constraints(check_results):
    """(name, analysis-based constraint) of every constraint result."""
    for _check, result in check_results.items():
        for cr in result.constraint_results:
            constraint = cr.constraint
            inner = constraint.inner if isinstance(constraint, ConstraintDecorator) else constraint
            if isinstance(inner, AnalysisBasedConstraint):
                yield str(constraint), inner


def row_level_results(
    check_results,
    data: Dataset,
    filtered_row_outcome: str = "true",
    device=None,
    chunk_rows: Optional[int] = None,
) -> Dataset:
    """One boolean column a row-level-capable constraint, named by the
    constraint, over ``data`` (the dataset the suite ran on), computed
    on ``device`` (``config``'s device when None) ``chunk_rows`` rows at
    a time (``config.batch_size``, else the scan's default batch).

    ``filtered_row_outcome``: what a row that the constraint's ``where``
    excludes reports, ``"true"`` (it passes, the default) or ``"null"``
    (null, in a nullable boolean column)."""
    import pyarrow as pa

    if filtered_row_outcome not in ("true", "null"):
        raise ValueError(
            f"filtered_row_outcome must be 'true' or 'null', got {filtered_row_outcome!r}"
        )
    columns: Dict[str, pa.Array] = {}
    cache = _OracleCache(data, device, chunk_rows)
    for name, inner in _constraints(check_results):
        try:
            excluded = _where_pass(getattr(inner.analyzer, "where", None), data, cache)
            outcome = _outcome_for(inner.analyzer, data, cache, assertion=inner.assertion,
                                   excluded=excluded)
        except Exception as exc:  # noqa: BLE001 — an unplannable predicate
            # or filter drops this constraint's column only; its aggregate
            # result already reports the exception
            if _fails_the_run(exc):
                raise
            continue
        if outcome is None:
            continue
        if excluded is None:
            columns[name] = pa.array(outcome)
        elif filtered_row_outcome == "true":
            columns[name] = pa.array(outcome | excluded)
        else:  # "null": the excluded rows are null
            columns[name] = pa.array(outcome, mask=excluded)
    if not columns:
        return Dataset.from_arrow(
            pa.table({"__no_row_level_constraints__": pa.array([], pa.bool_())}))
    return Dataset.from_arrow(pa.table(columns))
