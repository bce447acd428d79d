"""Metric model: named, entity-scoped results wrapping ``Try`` values.

Reference: ``src/main/scala/com/amazon/deequ/metrics/Metric.scala``
(SURVEY.md §2.1) — a metric is (entity, name, instance, Try[value]);
failures are values, never exceptions thrown at the user.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Generic, Sequence, TypeVar

from deequ_tpu_torch.utils.trylike import Failure, Success, Try

T = TypeVar("T")


class Entity(enum.Enum):
    """What a metric describes (reference: ``Entity`` in Metric.scala)."""

    DATASET = "Dataset"
    COLUMN = "Column"
    MULTICOLUMN = "Multicolumn"


@dataclass(frozen=True)
class Metric(Generic[T]):
    """A named, entity-scoped metric result.

    ``instance`` is the column name (or ``*`` for dataset-level metrics);
    ``value`` is a ``Try`` so failed computations travel as data.
    """

    entity: Entity
    name: str
    instance: str
    value: Try[T]

    def flatten(self) -> Sequence["DoubleMetric"]:
        """Expand into scalar double metrics (identity for DoubleMetric)."""
        raise NotImplementedError

    @property
    def is_success(self) -> bool:
        return self.value.is_success


@dataclass(frozen=True)
class DoubleMetric(Metric[float]):
    """A single scalar metric (the common case)."""

    def flatten(self) -> Sequence["DoubleMetric"]:
        return (self,)

    @staticmethod
    def success(
        entity: Entity, name: str, instance: str, value: float
    ) -> "DoubleMetric":
        return DoubleMetric(entity, name, instance, Success(float(value)))

    @staticmethod
    def failure(
        entity: Entity, name: str, instance: str, exception: BaseException
    ) -> "DoubleMetric":
        return DoubleMetric(entity, name, instance, Failure(exception))


@dataclass(frozen=True)
class KeyedDoubleMetric(Metric[dict]):
    """A map of named doubles under one metric (used by row-level stats)."""

    def flatten(self) -> Sequence[DoubleMetric]:
        if self.value.is_success:
            return tuple(
                DoubleMetric(
                    self.entity, f"{self.name}.{k}", self.instance, Success(v)
                )
                for k, v in sorted(self.value.get().items())
            )
        return (
            DoubleMetric(self.entity, self.name, self.instance, self.value),
        )
