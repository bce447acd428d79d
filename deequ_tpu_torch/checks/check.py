"""The Check fluent DSL: declarative data-quality constraints.

Counterpart of ``deequ_tpu/checks/check.py``. Each fluent method appends
a ``Constraint``; ``required_analyzers()`` is how the runner learns what
to compute; checks are immutable (every method returns a new Check).
``where``-filterable methods return a
:class:`CheckWithLastConstraintFilterable`. This package carries the
size, completeness, approximate-distinct and numeric-statistics methods;
the JAX package's other methods are not ported yet.
"""

from __future__ import annotations

import enum
from typing import Any, Callable, List, Optional

from deequ_tpu_torch.analyzers.base import Analyzer
from deequ_tpu_torch.analyzers.basic import (
    Completeness,
    Maximum,
    Mean,
    Minimum,
    Size,
    StandardDeviation,
    Sum,
)
from deequ_tpu_torch.analyzers.hll import ApproxCountDistinct
from deequ_tpu_torch.constraints.constraint import (
    AnalysisBasedConstraint,
    Constraint,
    ConstraintResult,
    ConstraintStatus,
    NamedConstraint,
)

Assertion = Callable[[Any], bool]


def is_one(value: float) -> bool:
    return value == 1.0


class CheckLevel(enum.Enum):
    ERROR = "Error"
    WARNING = "Warning"


class CheckStatus(enum.Enum):
    SUCCESS = "Success"
    WARNING = "Warning"
    ERROR = "Error"


class CheckResult:
    def __init__(
        self,
        check: "Check",
        status: CheckStatus,
        constraint_results: List[ConstraintResult],
    ):
        self.check = check
        self.status = status
        self.constraint_results = constraint_results


class Check:
    """An immutable group of constraints at one severity level."""

    def __init__(
        self,
        level: CheckLevel,
        description: str,
        constraints: Optional[List[Constraint]] = None,
    ):
        self.level = level
        self.description = description
        self.constraints: List[Constraint] = list(constraints or [])

    # -- plumbing -------------------------------------------------------

    def add_constraint(self, constraint: Constraint) -> "Check":
        return Check(self.level, self.description, self.constraints + [constraint])

    def _add_filterable(
        self, creation_fn: Callable[[Optional[str]], Constraint]
    ) -> "CheckWithLastConstraintFilterable":
        return CheckWithLastConstraintFilterable(
            self.level, self.description, self.constraints, creation_fn
        )

    def required_analyzers(self) -> List[Analyzer]:
        out: List[Analyzer] = []
        for c in self.constraints:
            inner = c.inner if hasattr(c, "inner") else c
            analyzer = getattr(inner, "analyzer", None)
            if analyzer is not None:
                out.append(analyzer)
        return out

    def evaluate(self, context) -> CheckResult:
        results = [c.evaluate(context) for c in self.constraints]
        if all(r.status == ConstraintStatus.SUCCESS for r in results):
            status = CheckStatus.SUCCESS
        elif self.level == CheckLevel.ERROR:
            status = CheckStatus.ERROR
        else:
            status = CheckStatus.WARNING
        return CheckResult(self, status, results)

    def _analysis(
        self, make: Callable[[Optional[str]], Analyzer], assertion, hint
    ) -> "CheckWithLastConstraintFilterable":
        return self._add_filterable(
            lambda where: AnalysisBasedConstraint(make(where), assertion, hint=hint)
        )

    # -- size -----------------------------------------------------------

    def has_size(
        self, assertion: Assertion, hint: Optional[str] = None
    ) -> "CheckWithLastConstraintFilterable":
        return self._analysis(lambda where: Size(where=where), assertion, hint)

    # -- completeness ---------------------------------------------------

    def is_complete(
        self, column: str, hint: Optional[str] = None
    ) -> "CheckWithLastConstraintFilterable":
        return self._add_filterable(
            lambda where: NamedConstraint(
                AnalysisBasedConstraint(Completeness(column, where), is_one, hint=hint),
                f"CompletenessConstraint({column})",
            )
        )

    def has_completeness(
        self, column: str, assertion: Assertion, hint: Optional[str] = None
    ) -> "CheckWithLastConstraintFilterable":
        return self._analysis(
            lambda where: Completeness(column, where), assertion, hint
        )

    # -- sketches -------------------------------------------------------

    def has_approx_count_distinct(
        self, column: str, assertion: Assertion, hint: Optional[str] = None
    ) -> "CheckWithLastConstraintFilterable":
        return self._analysis(
            lambda where: ApproxCountDistinct(column, where), assertion, hint
        )

    # -- numeric stats --------------------------------------------------

    def has_min(
        self, column: str, assertion: Assertion, hint: Optional[str] = None
    ) -> "CheckWithLastConstraintFilterable":
        return self._analysis(lambda where: Minimum(column, where), assertion, hint)

    def has_max(
        self, column: str, assertion: Assertion, hint: Optional[str] = None
    ) -> "CheckWithLastConstraintFilterable":
        return self._analysis(lambda where: Maximum(column, where), assertion, hint)

    def has_mean(
        self, column: str, assertion: Assertion, hint: Optional[str] = None
    ) -> "CheckWithLastConstraintFilterable":
        return self._analysis(lambda where: Mean(column, where), assertion, hint)

    def has_sum(
        self, column: str, assertion: Assertion, hint: Optional[str] = None
    ) -> "CheckWithLastConstraintFilterable":
        return self._analysis(lambda where: Sum(column, where), assertion, hint)

    def has_standard_deviation(
        self, column: str, assertion: Assertion, hint: Optional[str] = None
    ) -> "CheckWithLastConstraintFilterable":
        return self._analysis(
            lambda where: StandardDeviation(column, where), assertion, hint
        )


class CheckWithLastConstraintFilterable(Check):
    """A Check whose most recent constraint accepts a ``.where`` filter."""

    def __init__(
        self,
        level: CheckLevel,
        description: str,
        constraints: List[Constraint],
        creation_fn: Callable[[Optional[str]], Constraint],
    ):
        super().__init__(level, description, constraints + [creation_fn(None)])
        self._base_constraints = list(constraints)
        self._creation_fn = creation_fn

    def where(self, filter_condition: str) -> Check:
        return Check(
            self.level,
            self.description,
            self._base_constraints + [self._creation_fn(filter_condition)],
        )
