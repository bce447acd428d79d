"""Scan-shareable analyzers: Size, Completeness, Compliance, Sum, Mean,
Minimum, Maximum, MinLength, MaxLength, StandardDeviation, Correlation,
RatioOfSums.

Counterpart of ``deequ_tpu/analyzers/basic.py``. Each analyzer builds an
(init, update, merge) triple over fixed-shape states; the engine runs
every analyzer's update on the same batch, so N analyzers still cost one
pass over the data.

Dtype rules are the reference's: per-element work in the column's
native dtype with only the per-batch scalar cast into the accumulation
dtype, integral columns widened to float64 per element, and Spark's NaN
ordering in min/max. Null semantics: per-column validity masks play the
role of SQL's null-skipping aggregates. A ``where=`` filter compiles
through ``sql/predicate.py`` at planning time, so a malformed one
becomes that analyzer's failure metric; on the device it narrows the
row mask (``_row_mask``) or the column's mask (``_col_mask``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from deequ_tpu_torch.analyzers import states as S
from deequ_tpu_torch.analyzers.base import (
    EmptyStateException,
    IllegalAnalyzerParameterException,
    Precondition,
    ScanOps,
    ScanShareableAnalyzer,
    has_column,
    is_numeric,
    is_string,
)
from deequ_tpu_torch.data.table import ROW_MASK, ColumnRequest, Dataset
from deequ_tpu_torch.metrics.metric import DoubleMetric, Entity
from deequ_tpu_torch.sql.predicate import compile_predicate

_F64 = torch.float64

WhereFn = Optional[Callable[[dict], torch.Tensor]]


def _acc_float() -> torch.dtype:
    from deequ_tpu_torch import config

    return config.options().accumulation_float()


def _compile_where(
    where: Optional[str], dataset: Dataset
) -> Tuple[WhereFn, List[ColumnRequest]]:
    """Compile an optional where-filter; returns (complies_fn,
    requests). A malformed filter raises here, at planning time."""
    if where is None:
        return None, []
    pred = compile_predicate(where, dataset)
    return pred.complies, list(pred.requests)


def _scalar(x: torch.Tensor, value) -> torch.Tensor:
    """0-d tensor of ``x``'s dtype and device (a where-neutral)."""
    return torch.full((), value, dtype=x.dtype, device=x.device)


def _is_float(x: torch.Tensor) -> bool:
    return x.dtype.is_floating_point


def _msum(x: torch.Tensor, mask: torch.Tensor, dim=None) -> torch.Tensor:
    """Masked sum: elementwise in native dtype, scalar in accumulation
    dtype. Integral columns widen per element to float64."""
    acc = _acc_float()
    kw = {} if dim is None else {"dim": dim}
    if _is_float(x):
        return torch.where(mask, x, _scalar(x, 0)).sum(**kw).to(acc)
    return torch.where(mask, x, _scalar(x, 0)).to(_F64).sum(**kw).to(acc)


def _amin(x: torch.Tensor, dim=None) -> torch.Tensor:
    return x.amin() if dim is None else x.amin(dim=dim)


def _amax(x: torch.Tensor, dim=None) -> torch.Tensor:
    return x.amax() if dim is None else x.amax(dim=dim)


def _any(x: torch.Tensor, dim=None) -> torch.Tensor:
    return x.any() if dim is None else x.any(dim=dim)


def _mmin(x: torch.Tensor, mask: torch.Tensor, dim=None) -> torch.Tensor:
    """Masked min under Spark's ordering: NaN ranks above every value,
    so NaN loses to any real value and wins only when ALL masked values
    are NaN. Result always float64. No real contribution -> NaN, the
    nan_largest_min identity."""
    if _is_float(x):
        real = mask & ~torch.isnan(x)
        m = _amin(torch.where(real, x, _scalar(x, float("inf"))), dim).to(_F64)
        return torch.where(_any(real, dim), m, _scalar(m, float("nan")))
    neutral = _scalar(x, torch.iinfo(x.dtype).max)
    return _amin(torch.where(mask, x, neutral), dim).to(_F64)


def _mmax(x: torch.Tensor, mask: torch.Tensor, dim=None) -> torch.Tensor:
    if _is_float(x):
        neutral = _scalar(x, float("-inf"))
    else:
        neutral = _scalar(x, torch.iinfo(x.dtype).min)
    return _amax(torch.where(mask, x, neutral), dim).to(_F64)


def _mcount(mask: torch.Tensor, dim=None) -> torch.Tensor:
    kw = {} if dim is None else {"dim": dim}
    return mask.sum(dtype=torch.int64, **kw)


def _welford_batch(
    x: torch.Tensor, mask: torch.Tensor, sum_b: torch.Tensor, n_b, dim=None
) -> S.StandardDeviationState:
    """One batch's (n, mean, m2): the mean from the masked sum, the
    second moment elementwise in the column dtype around it."""
    xw = x if _is_float(x) else x.to(_F64)
    nb = n_b.to(_F64)
    mean_b = sum_b.to(_F64) / torch.clamp(nb, min=1.0)
    centre = mean_b.to(xw.dtype)
    if dim is not None:
        centre = centre.unsqueeze(dim)
    dx = torch.where(mask, xw - centre, _scalar(xw, 0))
    kw = {} if dim is None else {"dim": dim}
    m2_b = (dx * dx).sum(**kw).to(_F64)
    zero = torch.zeros_like(nb)
    return S.StandardDeviationState(
        nb, torch.where(nb > 0, mean_b, zero), torch.where(nb > 0, m2_b, zero)
    )


def _row_mask(batch, where_fn: WhereFn = None) -> torch.Tensor:
    mask = batch[ROW_MASK]
    if where_fn is not None:
        mask = mask & where_fn(batch)
    return mask


def _col_mask(batch, column: str, where_fn: WhereFn = None) -> torch.Tensor:
    mask = batch[f"{column}::mask"]
    if where_fn is not None:
        mask = mask & where_fn(batch)
    return mask


# --------------------------------------------------------------------------


@dataclass(frozen=True)
class Size(ScanShareableAnalyzer):
    """Row count (state NumMatches)."""

    where: Optional[str] = None

    @property
    def entity(self) -> Entity:
        return Entity.DATASET

    @property
    def instance(self) -> str:
        return "*"

    def device_requests(self, dataset: Dataset) -> List[ColumnRequest]:
        return _compile_where(self.where, dataset)[1]

    def make_ops(self, dataset: Dataset) -> ScanOps:
        where_fn, _ = _compile_where(self.where, dataset)

        def update(state: S.NumMatches, batch) -> S.NumMatches:
            return S.NumMatches(
                state.num_matches + _mcount(_row_mask(batch, where_fn))
            )

        return ScanOps(S.NumMatches.identity, update, S.NumMatches.merge)

    def compute_metric_from_state(self, state) -> DoubleMetric:
        if state is None:
            state = S.NumMatches.identity()
        return DoubleMetric.success(
            self.entity, "Size", self.instance, float(state.num_matches)
        )


@dataclass(frozen=True)
class Completeness(ScanShareableAnalyzer):
    """Fraction of non-null values (state NumMatchesAndCount)."""

    column: str
    where: Optional[str] = None

    @property
    def instance(self) -> str:
        return self.column

    def preconditions(self) -> List[Precondition]:
        return [has_column(self.column)]

    def device_requests(self, dataset: Dataset) -> List[ColumnRequest]:
        return [ColumnRequest(self.column, "mask")] + _compile_where(
            self.where, dataset
        )[1]

    def make_ops(self, dataset: Dataset) -> ScanOps:
        where_fn, _ = _compile_where(self.where, dataset)
        col = self.column

        def update(state: S.NumMatchesAndCount, batch) -> S.NumMatchesAndCount:
            rows = _row_mask(batch, where_fn)
            valid = _col_mask(batch, col) & rows
            return S.NumMatchesAndCount(
                state.num_matches + _mcount(valid),
                state.count + _mcount(rows),
            )

        return ScanOps(
            S.NumMatchesAndCount.identity, update, S.NumMatchesAndCount.merge
        )

    def compute_metric_from_state(self, state) -> DoubleMetric:
        if state is None or int(state.count) == 0:
            return self.to_failure_metric(
                EmptyStateException(
                    "Empty state for analyzer Completeness, all input values "
                    "were NULL or filtered."
                )
            )
        return DoubleMetric.success(
            self.entity,
            "Completeness",
            self.instance,
            float(state.num_matches) / float(state.count),
        )


@dataclass(frozen=True)
class Compliance(ScanShareableAnalyzer):
    """Fraction of rows satisfying a SQL predicate (state
    NumMatchesAndCount: compliant rows over rows passing the filter). The
    predicate compiles to PyTorch ops; string comparisons run on
    dictionary codes (``sql/predicate.py``)."""

    instance_name: str
    predicate: str
    where: Optional[str] = None

    @property
    def entity(self) -> Entity:
        return Entity.DATASET

    @property
    def instance(self) -> str:
        return self.instance_name

    def device_requests(self, dataset: Dataset) -> List[ColumnRequest]:
        pred = compile_predicate(self.predicate, dataset)
        return list(pred.requests) + _compile_where(self.where, dataset)[1]

    def make_ops(self, dataset: Dataset) -> ScanOps:
        pred = compile_predicate(self.predicate, dataset)
        where_fn, _ = _compile_where(self.where, dataset)

        def update(state: S.NumMatchesAndCount, batch) -> S.NumMatchesAndCount:
            rows = _row_mask(batch, where_fn)
            return S.NumMatchesAndCount(
                state.num_matches + _mcount(pred.complies(batch) & rows),
                state.count + _mcount(rows),
            )

        return ScanOps(
            S.NumMatchesAndCount.identity, update, S.NumMatchesAndCount.merge
        )

    def compute_metric_from_state(self, state) -> DoubleMetric:
        if state is None or int(state.count) == 0:
            return self.to_failure_metric(
                EmptyStateException("Empty state for analyzer Compliance.")
            )
        return DoubleMetric.success(
            self.entity,
            "Compliance",
            self.instance,
            float(state.num_matches) / float(state.count),
        )


class _NumericColumnAnalyzer(ScanShareableAnalyzer):
    """Shared plumbing for single-numeric-column analyzers."""

    column: str
    where: Optional[str]

    def preconditions(self) -> List[Precondition]:
        return [has_column(self.column), is_numeric(self.column)]

    @property
    def instance(self) -> str:
        return self.column

    def device_requests(self, dataset: Dataset) -> List[ColumnRequest]:
        return [
            ColumnRequest(self.column, "values"),
            ColumnRequest(self.column, "mask"),
        ] + _compile_where(self.where, dataset)[1]

    def _empty(self) -> DoubleMetric:
        return self.to_failure_metric(
            EmptyStateException(f"Empty state for analyzer {self.name}.")
        )


@dataclass(frozen=True)
class Sum(_NumericColumnAnalyzer):
    """Sum of a numeric column."""

    column: str
    where: Optional[str] = None

    def make_ops(self, dataset: Dataset) -> ScanOps:
        where_fn, _ = _compile_where(self.where, dataset)
        col = self.column

        def update(state: S.SumState, batch) -> S.SumState:
            mask = _col_mask(batch, col, where_fn)
            return S.SumState(
                state.sum_value + _msum(batch[f"{col}::values"], mask),
                state.count + _mcount(mask),
            )

        return ScanOps(S.SumState.identity, update, S.SumState.merge)

    def compute_metric_from_state(self, state) -> DoubleMetric:
        if state is None or int(state.count) == 0:
            return self._empty()
        return DoubleMetric.success(
            self.entity, "Sum", self.instance, float(state.sum_value)
        )


@dataclass(frozen=True)
class Mean(_NumericColumnAnalyzer):
    """Arithmetic mean (MeanState)."""

    column: str
    where: Optional[str] = None

    def make_ops(self, dataset: Dataset) -> ScanOps:
        where_fn, _ = _compile_where(self.where, dataset)
        col = self.column

        def update(state: S.MeanState, batch) -> S.MeanState:
            mask = _col_mask(batch, col, where_fn)
            return S.MeanState(
                state.total + _msum(batch[f"{col}::values"], mask),
                state.count + _mcount(mask),
            )

        return ScanOps(S.MeanState.identity, update, S.MeanState.merge)

    def compute_metric_from_state(self, state) -> DoubleMetric:
        if state is None or int(state.count) == 0:
            return self._empty()
        return DoubleMetric.success(
            self.entity,
            "Mean",
            self.instance,
            float(state.total) / float(state.count),
        )


@dataclass(frozen=True)
class Minimum(_NumericColumnAnalyzer):
    """Minimum of a numeric column."""

    column: str
    where: Optional[str] = None

    def make_ops(self, dataset: Dataset) -> ScanOps:
        where_fn, _ = _compile_where(self.where, dataset)
        col = self.column

        def update(state: S.MinState, batch) -> S.MinState:
            mask = _col_mask(batch, col, where_fn)
            return S.MinState(
                S.nan_largest_min(
                    state.min_value, _mmin(batch[f"{col}::values"], mask)
                ),
                state.count + _mcount(mask),
            )

        return ScanOps(S.MinState.identity, update, S.MinState.merge)

    def compute_metric_from_state(self, state) -> DoubleMetric:
        if state is None or int(state.count) == 0:
            return self._empty()
        # -0.0 normalizes to 0.0 (Spark's NormalizeFloatingNumbers)
        return DoubleMetric.success(
            self.entity, "Minimum", self.instance,
            float(state.min_value) + 0.0,
        )


@dataclass(frozen=True)
class Maximum(_NumericColumnAnalyzer):
    """Maximum of a numeric column."""

    column: str
    where: Optional[str] = None

    def make_ops(self, dataset: Dataset) -> ScanOps:
        where_fn, _ = _compile_where(self.where, dataset)
        col = self.column

        def update(state: S.MaxState, batch) -> S.MaxState:
            mask = _col_mask(batch, col, where_fn)
            return S.MaxState(
                torch.maximum(
                    state.max_value, _mmax(batch[f"{col}::values"], mask)
                ),
                state.count + _mcount(mask),
            )

        return ScanOps(S.MaxState.identity, update, S.MaxState.merge)

    def compute_metric_from_state(self, state) -> DoubleMetric:
        if state is None or int(state.count) == 0:
            return self._empty()
        return DoubleMetric.success(
            self.entity, "Maximum", self.instance,
            float(state.max_value) + 0.0,  # -0.0 -> 0.0, see Minimum
        )


class _LengthAnalyzer(ScanShareableAnalyzer):
    """Shared plumbing for MinLength/MaxLength over a string column's
    ``lengths`` repr (utf8 code points; null behavior Ignore)."""

    column: str
    where: Optional[str]

    def preconditions(self) -> List[Precondition]:
        return [has_column(self.column), is_string(self.column)]

    @property
    def instance(self) -> str:
        return self.column

    def device_requests(self, dataset: Dataset) -> List[ColumnRequest]:
        return [
            ColumnRequest(self.column, "lengths"),
            ColumnRequest(self.column, "mask"),
        ] + _compile_where(self.where, dataset)[1]

    def _empty(self) -> DoubleMetric:
        return self.to_failure_metric(
            EmptyStateException(f"Empty state for analyzer {self.name}.")
        )


@dataclass(frozen=True)
class MinLength(_LengthAnalyzer):
    """Minimum string length."""

    column: str
    where: Optional[str] = None

    def make_ops(self, dataset: Dataset) -> ScanOps:
        where_fn, _ = _compile_where(self.where, dataset)
        col = self.column

        def update(state: S.MinState, batch) -> S.MinState:
            mask = _col_mask(batch, col, where_fn)
            return S.MinState(
                # nan_largest_min, not torch.minimum: the carry identity
                # is NaN (states.MinState), which plain minimum would
                # propagate over every real length
                S.nan_largest_min(
                    state.min_value, _mmin(batch[f"{col}::lengths"], mask)
                ),
                state.count + _mcount(mask),
            )

        return ScanOps(S.MinState.identity, update, S.MinState.merge)

    def compute_metric_from_state(self, state) -> DoubleMetric:
        if state is None or int(state.count) == 0:
            return self._empty()
        return DoubleMetric.success(
            self.entity, "MinLength", self.instance, float(state.min_value)
        )


@dataclass(frozen=True)
class MaxLength(_LengthAnalyzer):
    """Maximum string length."""

    column: str
    where: Optional[str] = None

    def make_ops(self, dataset: Dataset) -> ScanOps:
        where_fn, _ = _compile_where(self.where, dataset)
        col = self.column

        def update(state: S.MaxState, batch) -> S.MaxState:
            mask = _col_mask(batch, col, where_fn)
            return S.MaxState(
                torch.maximum(
                    state.max_value, _mmax(batch[f"{col}::lengths"], mask)
                ),
                state.count + _mcount(mask),
            )

        return ScanOps(S.MaxState.identity, update, S.MaxState.merge)

    def compute_metric_from_state(self, state) -> DoubleMetric:
        if state is None or int(state.count) == 0:
            return self._empty()
        return DoubleMetric.success(
            self.entity, "MaxLength", self.instance, float(state.max_value)
        )


@dataclass(frozen=True)
class StandardDeviation(_NumericColumnAnalyzer):
    """Population standard deviation via a mergeable Welford state: the
    batch's (n, mean, m2) merged into the carry with the Chan combine."""

    column: str
    where: Optional[str] = None

    def make_ops(self, dataset: Dataset) -> ScanOps:
        where_fn, _ = _compile_where(self.where, dataset)
        col = self.column

        def update(
            state: S.StandardDeviationState, batch
        ) -> S.StandardDeviationState:
            mask = _col_mask(batch, col, where_fn)
            x = batch[f"{col}::values"]
            batch_state = _welford_batch(x, mask, _msum(x, mask), _mcount(mask))
            return S.StandardDeviationState.merge(state, batch_state)

        return ScanOps(
            S.StandardDeviationState.identity,
            update,
            S.StandardDeviationState.merge,
        )

    def compute_metric_from_state(self, state) -> DoubleMetric:
        if state is None or float(state.n) == 0:
            return self._empty()
        return DoubleMetric.success(
            self.entity,
            "StandardDeviation",
            self.instance,
            float(np.sqrt(float(state.m2) / float(state.n))),
        )


def _as_float(x: torch.Tensor) -> torch.Tensor:
    """Integral columns widen to float64 per element, whatever the
    accumulation knob."""
    return x if _is_float(x) else x.to(_F64)


@dataclass(frozen=True)
class Correlation(ScanShareableAnalyzer):
    """Pearson correlation of two numeric columns (CorrelationState with
    Spark Corr-style mergeable co-moments). Rows where either value is
    null are skipped."""

    first_column: str
    second_column: str
    where: Optional[str] = None

    @property
    def entity(self) -> Entity:
        return Entity.MULTICOLUMN

    @property
    def instance(self) -> str:
        return f"{self.first_column},{self.second_column}"

    def preconditions(self) -> List[Precondition]:
        return [
            has_column(self.first_column),
            is_numeric(self.first_column),
            has_column(self.second_column),
            is_numeric(self.second_column),
        ]

    def device_requests(self, dataset: Dataset) -> List[ColumnRequest]:
        return [
            ColumnRequest(self.first_column, "values"),
            ColumnRequest(self.first_column, "mask"),
            ColumnRequest(self.second_column, "values"),
            ColumnRequest(self.second_column, "mask"),
        ] + _compile_where(self.where, dataset)[1]

    def make_ops(self, dataset: Dataset) -> ScanOps:
        where_fn, _ = _compile_where(self.where, dataset)
        ca, cb = self.first_column, self.second_column

        def update(state: S.CorrelationState, batch) -> S.CorrelationState:
            mask = batch[f"{ca}::mask"] & batch[f"{cb}::mask"]
            mask = mask & _row_mask(batch, where_fn)
            x = _as_float(batch[f"{ca}::values"])
            y = _as_float(batch[f"{cb}::values"])
            # the co-moment state stays float64 like the Welford state
            nb = _mcount(mask).to(_F64)
            safe_nb = torch.clamp(nb, min=1.0)
            x_avg = _msum(x, mask).to(_F64) / safe_nb
            y_avg = _msum(y, mask).to(_F64) / safe_nb
            dx = torch.where(mask, x - x_avg.to(x.dtype), _scalar(x, 0))
            dy = torch.where(mask, y - y_avg.to(y.dtype), _scalar(y, 0))
            zero = torch.zeros_like(nb)
            batch_state = S.CorrelationState(
                nb,
                torch.where(nb > 0, x_avg, zero),
                torch.where(nb > 0, y_avg, zero),
                (dx * dy).sum().to(_F64),
                (dx * dx).sum().to(_F64),
                (dy * dy).sum().to(_F64),
            )
            return S.CorrelationState.merge(state, batch_state)

        return ScanOps(S.CorrelationState.identity, update, S.CorrelationState.merge)

    def compute_metric_from_state(self, state) -> DoubleMetric:
        if state is None or float(state.n) == 0:
            return self.to_failure_metric(
                EmptyStateException("Empty state for analyzer Correlation.")
            )
        # sqrt of the PRODUCT, like Spark's Corr (sqrt(x)*sqrt(y) is not
        # float-equivalent: exact linear dependence must yield exactly
        # 1.0); zero variance gives 0/0 = NaN as a SUCCESSFUL metric
        # value. The product overflows to inf when both co-moments exceed
        # ~1e154 and underflows below ~1e-162: then sqrt(x)*sqrt(y).
        x_mk, y_mk = float(state.x_mk), float(state.y_mk)
        product = x_mk * y_mk
        degenerate = (not np.isfinite(product)) or (
            product < float(np.finfo(np.float64).tiny)
            and x_mk != 0.0
            and y_mk != 0.0
        )
        if degenerate and np.isfinite(x_mk) and np.isfinite(y_mk):
            denom = float(np.sqrt(x_mk) * np.sqrt(y_mk))
        else:
            denom = float(np.sqrt(product))
        with np.errstate(invalid="ignore", divide="ignore"):
            value = (
                float(np.float64(float(state.ck)) / denom)
                if denom != 0.0
                else float("nan")
            )
        return DoubleMetric.success(self.entity, "Correlation", self.instance, value)


@dataclass(frozen=True)
class RatioOfSums(ScanShareableAnalyzer):
    """sum(numerator) / sum(denominator) over the rows passing the
    filter (state SumPairState)."""

    numerator: str
    denominator: str
    where: Optional[str] = None

    @property
    def entity(self) -> Entity:
        return Entity.MULTICOLUMN

    @property
    def instance(self) -> str:
        return f"{self.numerator},{self.denominator}"

    def preconditions(self) -> List[Precondition]:
        return [
            has_column(self.numerator),
            is_numeric(self.numerator),
            has_column(self.denominator),
            is_numeric(self.denominator),
        ]

    def device_requests(self, dataset: Dataset) -> List[ColumnRequest]:
        return [
            ColumnRequest(self.numerator, "values"),
            ColumnRequest(self.numerator, "mask"),
            ColumnRequest(self.denominator, "values"),
            ColumnRequest(self.denominator, "mask"),
        ] + _compile_where(self.where, dataset)[1]

    def make_ops(self, dataset: Dataset) -> ScanOps:
        where_fn, _ = _compile_where(self.where, dataset)
        ca, cb = self.numerator, self.denominator

        def update(state: S.SumPairState, batch) -> S.SumPairState:
            rows = _row_mask(batch, where_fn)
            ma = batch[f"{ca}::mask"] & rows
            mb = batch[f"{cb}::mask"] & rows
            return S.SumPairState(
                state.sum_a + _msum(batch[f"{ca}::values"], ma),
                state.sum_b + _msum(batch[f"{cb}::values"], mb),
                state.count + _mcount(rows),
            )

        return ScanOps(S.SumPairState.identity, update, S.SumPairState.merge)

    def compute_metric_from_state(self, state) -> DoubleMetric:
        if state is None or int(state.count) == 0:
            return self.to_failure_metric(
                EmptyStateException("Empty state for analyzer RatioOfSums.")
            )
        if float(state.sum_b) == 0.0:
            return self.to_failure_metric(
                IllegalAnalyzerParameterException(
                    "Denominator sum is zero in RatioOfSums."
                )
            )
        return DoubleMetric.success(
            self.entity,
            "RatioOfSums",
            self.instance,
            float(state.sum_a) / float(state.sum_b),
        )
