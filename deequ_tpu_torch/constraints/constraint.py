"""Constraints: assertions over metrics, evaluated against an
AnalyzerContext.

Reference: ``src/main/scala/com/amazon/deequ/constraints/`` (SURVEY.md
§2.5): ``AnalysisBasedConstraint[S, M, V]`` pairs an analyzer with an
assertion ``V => Boolean`` plus an optional value picker; evaluation is a
pure metric lookup + assertion — no data access. ``NamedConstraint``
decorates with a display name.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from deequ_tpu_torch.analyzers.base import Analyzer
from deequ_tpu_torch.metrics.metric import Metric

MISSING_ANALYSIS_MSG = "Missing Analysis, can't run the constraint!"
ASSERTION_EXCEPTION_MSG = "Can't execute the assertion"


class ConstraintStatus(enum.Enum):
    SUCCESS = "Success"
    FAILURE = "Failure"


@dataclass
class ConstraintResult:
    constraint: "Constraint"
    status: ConstraintStatus
    message: Optional[str] = None
    metric: Optional[Metric] = None


class Constraint:
    """Base: evaluate against the analyzer context."""

    def evaluate(self, analysis_result) -> ConstraintResult:
        raise NotImplementedError


class ConstraintDecorator(Constraint):
    def __init__(self, inner: Constraint):
        self._inner = inner

    @property
    def inner(self) -> Constraint:
        if isinstance(self._inner, ConstraintDecorator):
            return self._inner.inner
        return self._inner

    def evaluate(self, analysis_result) -> ConstraintResult:
        result = self._inner.evaluate(analysis_result)
        result.constraint = self
        return result


class NamedConstraint(ConstraintDecorator):
    def __init__(self, inner: Constraint, name: str):
        super().__init__(inner)
        self._name = name

    def __repr__(self) -> str:
        return self._name

    def __str__(self) -> str:
        return self._name


class AnalysisBasedConstraint(Constraint):
    """analyzer + assertion (+ value picker) -> ConstraintResult.

    - missing metric in the context -> FAILURE(MissingAnalysis)
    - failed metric -> FAILURE carrying the metric's exception message
    - value-picker/assertion exception -> FAILURE with the message
    - assertion false -> FAILURE with actual value; true -> SUCCESS
    """

    def __init__(
        self,
        analyzer: Analyzer,
        assertion: Callable[[Any], bool],
        value_picker: Optional[Callable[[Any], Any]] = None,
        hint: Optional[str] = None,
    ):
        self.analyzer = analyzer
        self.assertion = assertion
        self.value_picker = value_picker
        self.hint = hint

    def evaluate(self, analyzer_context) -> ConstraintResult:
        metric = analyzer_context.metric(self.analyzer)
        if metric is None:
            return ConstraintResult(
                self, ConstraintStatus.FAILURE, MISSING_ANALYSIS_MSG, None
            )
        return self._pick_value_and_assert(metric)

    def _pick_value_and_assert(self, metric: Metric) -> ConstraintResult:
        if metric.value.is_failure:
            message = f"metric computation failed: {metric.value.exception}"
            if self.hint:
                message += f" {self.hint}"
            return ConstraintResult(
                self, ConstraintStatus.FAILURE, message, metric
            )
        try:
            raw = metric.value.get()
            value = self.value_picker(raw) if self.value_picker else raw
        except Exception as exc:  # noqa: BLE001
            return ConstraintResult(
                self,
                ConstraintStatus.FAILURE,
                f"{ASSERTION_EXCEPTION_MSG}: {exc}",
                metric,
            )
        try:
            ok = bool(self.assertion(value))
        except Exception as exc:  # noqa: BLE001
            return ConstraintResult(
                self,
                ConstraintStatus.FAILURE,
                f"{ASSERTION_EXCEPTION_MSG}: {exc}",
                metric,
            )
        if ok:
            return ConstraintResult(
                self, ConstraintStatus.SUCCESS, None, metric
            )
        message = (
            f"Value: {value} does not meet the constraint requirement!"
        )
        if self.hint:
            message += f" {self.hint}"
        return ConstraintResult(
            self, ConstraintStatus.FAILURE, message, metric
        )

    def __repr__(self) -> str:
        return (
            f"AnalysisBasedConstraint({self.analyzer!r})"
        )
