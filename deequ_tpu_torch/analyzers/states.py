"""Analyzer state types: NamedTuples of tensors forming commutative monoids.

Counterpart of ``deequ_tpu/analyzers/states.py``. Each state is a
NamedTuple of 0-d (or 1-d) tensors with a dataset-independent ``merge``,
so states persisted by one run — or by the JAX package, see
``deequ_tpu_torch/interop.py`` — combine without touching data. Identities
are host tensors; the engine moves them to its device before the scan,
and the scan's one packed fetch brings the final states back as host
tensors.

All merges are commutative and associative and work on any device, as
long as both operands live on the same one.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Type

import torch


def _facc(value: float = 0.0) -> torch.Tensor:
    """Scalar in the configured accumulation float dtype."""
    from deequ_tpu_torch import config

    return torch.tensor(value, dtype=config.options().accumulation_float())


def _iacc(value: int = 0) -> torch.Tensor:
    """Count scalar — always int64, whatever the float accumulation knob."""
    return torch.tensor(value, dtype=torch.int64)


def _f64(value: float) -> torch.Tensor:
    return torch.tensor(value, dtype=torch.float64)


def nan_largest_min(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Min under Spark's ordering, where NaN ranks ABOVE every value
    including +inf: NaN loses to any non-NaN operand; min(NaN, NaN) =
    NaN. ``torch.minimum`` propagates NaN, which would let one all-NaN
    batch poison a merged Minimum. The MAX side needs no counterpart —
    NaN-propagating ``torch.maximum`` IS Spark's max."""
    return torch.where(
        torch.isnan(a), b, torch.where(torch.isnan(b), a, torch.minimum(a, b))
    )


class NumMatches(NamedTuple):
    num_matches: torch.Tensor  # int64 scalar

    @staticmethod
    def identity() -> "NumMatches":
        return NumMatches(_iacc(0))

    @staticmethod
    def merge(a: "NumMatches", b: "NumMatches") -> "NumMatches":
        return NumMatches(a.num_matches + b.num_matches)


class NumMatchesAndCount(NamedTuple):
    num_matches: torch.Tensor
    count: torch.Tensor

    @staticmethod
    def identity() -> "NumMatchesAndCount":
        return NumMatchesAndCount(_iacc(0), _iacc(0))

    @staticmethod
    def merge(
        a: "NumMatchesAndCount", b: "NumMatchesAndCount"
    ) -> "NumMatchesAndCount":
        return NumMatchesAndCount(
            a.num_matches + b.num_matches, a.count + b.count
        )

    @property
    def metric_value(self):
        return self.num_matches / self.count


class SumState(NamedTuple):
    sum_value: torch.Tensor  # accumulation float
    count: torch.Tensor  # int64; tracks emptiness

    @staticmethod
    def identity() -> "SumState":
        return SumState(_facc(0.0), _iacc(0))

    @staticmethod
    def merge(a: "SumState", b: "SumState") -> "SumState":
        return SumState(a.sum_value + b.sum_value, a.count + b.count)


class MeanState(NamedTuple):
    total: torch.Tensor  # accumulation float
    count: torch.Tensor  # int64

    @staticmethod
    def identity() -> "MeanState":
        return MeanState(_facc(0.0), _iacc(0))

    @staticmethod
    def merge(a: "MeanState", b: "MeanState") -> "MeanState":
        return MeanState(a.total + b.total, a.count + b.count)


class MinState(NamedTuple):
    min_value: torch.Tensor  # float64
    count: torch.Tensor

    @staticmethod
    def identity() -> "MinState":
        # NaN, not +inf: under the Spark ordering NaN is
        # nan_largest_min's identity; count == 0 guards the empty case
        return MinState(_f64(float("nan")), _iacc(0))

    @staticmethod
    def merge(a: "MinState", b: "MinState") -> "MinState":
        return MinState(
            nan_largest_min(a.min_value, b.min_value), a.count + b.count
        )


class MaxState(NamedTuple):
    max_value: torch.Tensor  # float64
    count: torch.Tensor

    @staticmethod
    def identity() -> "MaxState":
        return MaxState(_f64(float("-inf")), _iacc(0))

    @staticmethod
    def merge(a: "MaxState", b: "MaxState") -> "MaxState":
        return MaxState(
            torch.maximum(a.max_value, b.max_value), a.count + b.count
        )


class StandardDeviationState(NamedTuple):
    """Welford-style mergeable variance accumulator (n, avg, m2), f64."""

    n: torch.Tensor
    avg: torch.Tensor
    m2: torch.Tensor

    @staticmethod
    def identity() -> "StandardDeviationState":
        return StandardDeviationState(_f64(0.0), _f64(0.0), _f64(0.0))

    @staticmethod
    def merge(
        a: "StandardDeviationState", b: "StandardDeviationState"
    ) -> "StandardDeviationState":
        n = a.n + b.n
        safe_n = torch.clamp(n, min=1.0)
        delta = b.avg - a.avg
        avg = torch.where(
            n > 0, a.avg + delta * b.n / safe_n, torch.zeros_like(n)
        )
        m2 = a.m2 + b.m2 + delta * delta * a.n * b.n / safe_n
        return StandardDeviationState(n, avg, m2)


class CorrelationState(NamedTuple):
    """Mergeable Pearson correlation accumulator (Spark Corr-style),
    float64 throughout."""

    n: torch.Tensor
    x_avg: torch.Tensor
    y_avg: torch.Tensor
    ck: torch.Tensor  # co-moment
    x_mk: torch.Tensor
    y_mk: torch.Tensor

    @staticmethod
    def identity() -> "CorrelationState":
        return CorrelationState(*(_f64(0.0) for _ in range(6)))

    @staticmethod
    def merge(a: "CorrelationState", b: "CorrelationState") -> "CorrelationState":
        n = a.n + b.n
        safe_n = torch.clamp(n, min=1.0)
        dx = b.x_avg - a.x_avg
        dy = b.y_avg - a.y_avg
        frac = a.n * b.n / safe_n
        zero = torch.zeros_like(n)
        x_avg = torch.where(n > 0, a.x_avg + dx * b.n / safe_n, zero)
        y_avg = torch.where(n > 0, a.y_avg + dy * b.n / safe_n, zero)
        ck = a.ck + b.ck + dx * dy * frac
        x_mk = a.x_mk + b.x_mk + dx * dx * frac
        y_mk = a.y_mk + b.y_mk + dy * dy * frac
        return CorrelationState(n, x_avg, y_avg, ck, x_mk, y_mk)


class SumPairState(NamedTuple):
    """For RatioOfSums: two sums plus a row count."""

    sum_a: torch.Tensor  # accumulation float
    sum_b: torch.Tensor
    count: torch.Tensor  # int64

    @staticmethod
    def identity() -> "SumPairState":
        return SumPairState(_facc(0.0), _facc(0.0), _iacc(0))

    @staticmethod
    def merge(a: "SumPairState", b: "SumPairState") -> "SumPairState":
        return SumPairState(a.sum_a + b.sum_a, a.sum_b + b.sum_b, a.count + b.count)


class DataTypeHistogram(NamedTuple):
    """Counts per inferred type bucket, one int64[6] vector:
    [null, fractional, integral, boolean, string, (reserved)].
    Merge = elementwise sum."""

    counts: torch.Tensor  # int64[6]

    NULL = 0
    FRACTIONAL = 1
    INTEGRAL = 2
    BOOLEAN = 3
    STRING = 4

    @staticmethod
    def identity() -> "DataTypeHistogram":
        return DataTypeHistogram(torch.zeros(6, dtype=torch.int64))

    @staticmethod
    def merge(a: "DataTypeHistogram", b: "DataTypeHistogram") -> "DataTypeHistogram":
        return DataTypeHistogram(a.counts + b.counts)


class ApproxCountDistinctState(NamedTuple):
    """HLL registers (int8[m]; rho <= 33); merge = elementwise max."""

    registers: torch.Tensor  # int8[m]

    @staticmethod
    def merge(
        a: "ApproxCountDistinctState", b: "ApproxCountDistinctState"
    ) -> "ApproxCountDistinctState":
        return ApproxCountDistinctState(
            torch.maximum(a.registers, b.registers)
        )


# (The KLL sketch state is host-side, ``sketches/kll.py::KLLSketchState``,
# because its compaction is data-dependent; ``interop.py`` carries it
# across through its own ``to_arrays``/``from_arrays``.)

# Persisted-state format versions (the JAX package's table): bump when a
# state's INTERPRETATION changes, so stale states are rejected instead of
# silently merged wrong. v2 of ApproxCountDistinctState: integral columns
# hash the raw int64 payload — v1 registers place the same values in
# different registers, so a v1+v2 max-merge would double-count.
STATE_FORMAT_VERSIONS: Dict[str, int] = {
    "ApproxCountDistinctState": 2,
}

STATE_TYPES: Dict[str, Type] = {
    cls.__name__: cls
    for cls in (
        NumMatches,
        NumMatchesAndCount,
        SumState,
        MeanState,
        MinState,
        MaxState,
        StandardDeviationState,
        CorrelationState,
        SumPairState,
        DataTypeHistogram,
        ApproxCountDistinctState,
    )
}
