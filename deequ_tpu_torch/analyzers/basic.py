"""Scan-shareable analyzers: Size, Completeness, Sum, Mean, Minimum,
Maximum, StandardDeviation.

Counterpart of ``deequ_tpu/analyzers/basic.py``. Each analyzer builds an
(init, update, merge) triple over fixed-shape states; the engine runs
every analyzer's update on the same batch, so N analyzers still cost one
pass over the data.

Dtype rules are the reference's: per-element work in the column's
native dtype with only the per-batch scalar cast into the accumulation
dtype, integral columns widened to float64 per element, and Spark's NaN
ordering in min/max. Null semantics: per-column validity masks play the
role of SQL's null-skipping aggregates.

``where=`` filters need the SQL predicate compiler, which is not part of
this package yet: an analyzer with a filter yields a failure metric,
never a number computed without the filter.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from deequ_tpu_torch.analyzers import states as S
from deequ_tpu_torch.analyzers.base import (
    EmptyStateException,
    MetricCalculationException,
    Precondition,
    ScanOps,
    ScanShareableAnalyzer,
    has_column,
    is_numeric,
)
from deequ_tpu_torch.data.table import ROW_MASK, ColumnRequest, Dataset
from deequ_tpu_torch.metrics.metric import DoubleMetric, Entity

_F64 = torch.float64


class UnsupportedFilterException(MetricCalculationException):
    """A ``where=`` filter was given; the predicate compiler is not ported."""


def _acc_float() -> torch.dtype:
    from deequ_tpu_torch import config

    return config.options().accumulation_float()


def _compile_where(where: Optional[str], dataset: Dataset) -> None:
    """Reject a where-filter: without the predicate compiler the only
    honest answer is a failure metric."""
    if where is not None:
        raise UnsupportedFilterException(
            f"where-filters are not supported by deequ_tpu_torch yet "
            f"(got {where!r})"
        )


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


def _row_mask(batch) -> torch.Tensor:
    return batch[ROW_MASK]


def _col_mask(batch, column: str) -> torch.Tensor:
    return batch[f"{column}::mask"]


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
        return []

    def make_ops(self, dataset: Dataset) -> ScanOps:
        _compile_where(self.where, dataset)

        def update(state: S.NumMatches, batch) -> S.NumMatches:
            return S.NumMatches(state.num_matches + _mcount(_row_mask(batch)))

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
        return [ColumnRequest(self.column, "mask")]

    def make_ops(self, dataset: Dataset) -> ScanOps:
        _compile_where(self.where, dataset)
        col = self.column

        def update(state: S.NumMatchesAndCount, batch) -> S.NumMatchesAndCount:
            rows = _row_mask(batch)
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
        ]

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
        _compile_where(self.where, dataset)
        col = self.column

        def update(state: S.SumState, batch) -> S.SumState:
            mask = _col_mask(batch, col)
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
        _compile_where(self.where, dataset)
        col = self.column

        def update(state: S.MeanState, batch) -> S.MeanState:
            mask = _col_mask(batch, col)
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
        _compile_where(self.where, dataset)
        col = self.column

        def update(state: S.MinState, batch) -> S.MinState:
            mask = _col_mask(batch, col)
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
        _compile_where(self.where, dataset)
        col = self.column

        def update(state: S.MaxState, batch) -> S.MaxState:
            mask = _col_mask(batch, col)
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


@dataclass(frozen=True)
class StandardDeviation(_NumericColumnAnalyzer):
    """Population standard deviation via a mergeable Welford state: the
    batch's (n, mean, m2) merged into the carry with the Chan combine."""

    column: str
    where: Optional[str] = None

    def make_ops(self, dataset: Dataset) -> ScanOps:
        _compile_where(self.where, dataset)
        col = self.column

        def update(
            state: S.StandardDeviationState, batch
        ) -> S.StandardDeviationState:
            mask = _col_mask(batch, col)
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
