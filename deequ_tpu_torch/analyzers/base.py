"""Analyzer framework: states are commutative monoids, metrics are values.

Counterpart of ``deequ_tpu/analyzers/base.py``. Each scan-shareable
analyzer is a :class:`ScanOps` triple over NamedTuples (or dicts) of
tensors:

- ``init()``                — monoid identity (host tensors; the engine
                              moves it to its device)
- ``update(state, batch)``  — masked reductions over one batch of device
                              tensors; every analyzer's update runs on
                              the same batch, so N analyzers cost one
                              pass over the data
- ``merge(a, b)``           — the monoid merge, also used to fold
                              persisted or carried-over states

Finalization (state -> metric) runs on the host after the scan's single
fetch, and failures (missing column, empty state) become failure
*metrics*, never user-facing exceptions.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from deequ_tpu_torch.data.table import ColumnRequest, Dataset, Kind, Schema
from deequ_tpu_torch.metrics.metric import DoubleMetric, Entity, Metric
from deequ_tpu_torch.utils.trylike import Failure


# --------------------------------------------------------------------------
# Failure model
# --------------------------------------------------------------------------


class MetricCalculationException(Exception):
    """Base for per-analyzer failures embedded into failure metrics."""


class NoSuchColumnException(MetricCalculationException):
    pass


class WrongColumnTypeException(MetricCalculationException):
    pass


class NoColumnsSpecifiedException(MetricCalculationException):
    pass


class NumberOfSpecifiedColumnsException(MetricCalculationException):
    pass


class IllegalAnalyzerParameterException(MetricCalculationException):
    pass


class EmptyStateException(MetricCalculationException):
    pass


class MetricCalculationRuntimeException(MetricCalculationException):
    pass


def wrap_if_necessary(exc: BaseException) -> MetricCalculationException:
    if isinstance(exc, MetricCalculationException):
        return exc
    return MetricCalculationRuntimeException(repr(exc))


# --------------------------------------------------------------------------
# Preconditions
# --------------------------------------------------------------------------

Precondition = Callable[[Schema], None]


def has_column(column: str) -> Precondition:
    def check(schema: Schema) -> None:
        if not schema.has_column(column):
            raise NoSuchColumnException(
                f"Input data does not include column {column}!"
            )

    return check


def is_numeric(column: str) -> Precondition:
    def check(schema: Schema) -> None:
        if not schema.kind_of(column).is_numeric:
            raise WrongColumnTypeException(
                f"Expected type of column {column} to be numeric, but found "
                f"{schema.kind_of(column).value} instead!"
            )

    return check


def is_string(column: str) -> Precondition:
    def check(schema: Schema) -> None:
        if schema.kind_of(column) != Kind.STRING:
            raise WrongColumnTypeException(
                f"Expected type of column {column} to be String, but found "
                f"{schema.kind_of(column).value} instead!"
            )

    return check


def is_not_nested(column: str) -> Precondition:
    def check(schema: Schema) -> None:
        if schema.kind_of(column) == Kind.UNKNOWN:
            raise WrongColumnTypeException(
                f"Unsupported nested/unknown type in column {column}!"
            )

    return check


def at_least_one(columns: Sequence[str]) -> Precondition:
    def check(schema: Schema) -> None:
        if len(columns) == 0:
            raise NoColumnsSpecifiedException(
                "At least one column needs to be specified!"
            )

    return check


def exactly_n_columns(columns: Sequence[str], n: int) -> Precondition:
    def check(schema: Schema) -> None:
        if len(columns) != n:
            raise NumberOfSpecifiedColumnsException(
                f"Exactly {n} columns needed, got {len(columns)}"
            )

    return check


# --------------------------------------------------------------------------
# Scan ops
# --------------------------------------------------------------------------

StateTree = Any  # NamedTuple / dict / tuple of tensors


@dataclass
class ScanOps:
    """The (identity, update, merge) triple for one analyzer, built
    against a concrete dataset.

    ``consts`` — per-dataset lookup tables (the dictionary hash LUTs of
    HLL on strings). The engine moves them to its device once per scan;
    when set, ``update`` takes ``(state, batch, consts)``.

    ``host_init`` / ``host_fold`` — set together for a host-folded op
    (the KLL sketches): ``init``/``update`` then describe a per-batch
    OUTPUT slot, not a carry (``update`` ignores the state it is given),
    the engine keeps every batch's output on the device and fetches them
    with the states, and ``host_fold(acc, out)`` folds each batch's
    output, in batch order, into the accumulator ``host_init()`` made.
    The final state of such an op is that accumulator, and ``merge``
    merges two of them.

    ``device_result`` — the op's final state stays on the device and
    out of the scan's packed fetch (a spill collector's key buffer,
    ``analyzers/spill.py``); the scan returns it as it is."""

    init: Callable[[], StateTree]
    update: Callable[..., StateTree]
    merge: Callable[[StateTree, StateTree], StateTree]
    consts: Optional[Dict[str, Any]] = None
    host_init: Optional[Callable[[], Any]] = None
    host_fold: Optional[Callable[[Any, Any], Any]] = None
    device_result: bool = False

    def apply_update(self, state, batch, consts):
        if self.consts is None:
            return self.update(state, batch)
        return self.update(state, batch, consts)


def pad_pow2(arr: np.ndarray, fill=0) -> np.ndarray:
    """Pad a 1-D LUT to the next power-of-two length (the JAX package's
    LUT geometry, kept so both packages scatter the same slots)."""
    n = len(arr)
    m = 1 << max(0, (n - 1).bit_length())
    if m <= n:
        return arr
    return np.concatenate([arr, np.full(m - n, fill, dtype=arr.dtype)])


# --------------------------------------------------------------------------
# Analyzer base classes
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class Analyzer:
    """Base analyzer. Frozen dataclass => hashable, dedupable (the runner
    dedups analyzers and uses them as context-map keys)."""

    @property
    def name(self) -> str:
        return type(self).__name__

    @property
    def entity(self) -> Entity:
        return Entity.COLUMN

    @property
    def instance(self) -> str:
        raise NotImplementedError

    def preconditions(self) -> List[Precondition]:
        return []

    def compute_metric_from_state(self, state: Optional[StateTree]) -> Metric:
        """Host-side finalize; ``state=None`` means no rows contributed."""
        raise NotImplementedError

    def to_failure_metric(self, exc: BaseException) -> Metric:
        return DoubleMetric(
            self.entity, self.name, self.instance, Failure(wrap_if_necessary(exc))
        )

    def calculate(self, data: Dataset, engine=None) -> Metric:
        """Compute just this analyzer through the runner."""
        from deequ_tpu_torch.analyzers.runner import AnalysisRunner

        context = AnalysisRunner.do_analysis_run(data, [self], engine=engine)
        return context.metric(self)  # type: ignore[return-value]


@dataclass(frozen=True)
class ScanShareableAnalyzer(Analyzer):
    """An analyzer whose state updates fuse into the shared single pass."""

    def device_requests(self, dataset: Dataset) -> List[ColumnRequest]:
        raise NotImplementedError

    def make_ops(self, dataset: Dataset) -> ScanOps:
        raise NotImplementedError


@dataclass(frozen=True)
class GroupingAnalyzer(Analyzer):
    """An analyzer over value frequencies; the runner computes one
    frequency table per distinct (grouping columns, filter) and shares it
    (reference: GroupingAnalyzers.scala / FrequencyBasedAnalyzer)."""

    def grouping_columns(self) -> List[str]:
        raise NotImplementedError

    @property
    def filter_condition(self) -> Optional[str]:
        return None

    def preconditions(self) -> List[Precondition]:
        cols = self.grouping_columns()
        checks: List[Precondition] = [at_least_one(cols)]
        checks.extend(has_column(c) for c in cols)
        checks.extend(is_not_nested(c) for c in cols)
        return checks
