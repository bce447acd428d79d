"""The Check fluent DSL: declarative data-quality constraints.

Counterpart of ``deequ_tpu/checks/check.py``. Each fluent method appends
a ``Constraint``; ``required_analyzers()`` is how the runner learns what
to compute; checks are immutable (every method returns a new Check).
``where``-filterable methods return a
:class:`CheckWithLastConstraintFilterable`. This package carries the
size, column-count, completeness, uniqueness and distinctness,
histogram, entropy and mutual-information, approximate-distinct,
quantile, numeric-statistics, length, correlation, predicate
(Compliance), pattern and data-type methods: every public method of the
JAX package's ``Check``.
"""

from __future__ import annotations

import enum
from typing import Any, Callable, List, Optional, Sequence, Union

from deequ_tpu_torch.analyzers.base import Analyzer
from deequ_tpu_torch.analyzers.basic import (
    ColumnCount,
    Completeness,
    Compliance,
    Correlation,
    Maximum,
    MaxLength,
    Mean,
    Minimum,
    MinLength,
    Size,
    PatternMatch,
    StandardDeviation,
    Sum,
)
from deequ_tpu_torch.analyzers.datatype import DataType
from deequ_tpu_torch.analyzers.grouping import (
    CountDistinct,
    Distinctness,
    Entropy,
    Histogram,
    MutualInformation,
    Uniqueness,
    UniqueValueRatio,
)
from deequ_tpu_torch.analyzers.hll import ApproxCountDistinct
from deequ_tpu_torch.analyzers.kll import ApproxQuantile, KLLSketch
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


# Patterns (reference: Check.scala's containsEmail/URL/SSN/CreditCardNumber)
PATTERN_EMAIL = r"^[a-zA-Z0-9.!#$%&'*+/=?^_`{|}~-]+@[a-zA-Z0-9-]+(?:\.[a-zA-Z0-9-]+)*$"
PATTERN_URL = r"^(https?|ftp)://[^\s/$.?#].[^\s]*$"
PATTERN_SSN = r"^(?!000|666|9\d{2})\d{3}-(?!00)\d{2}-(?!0000)\d{4}$"
PATTERN_CREDITCARD = (
    r"^(4\d{12}(?:\d{3})?|(?:5[1-5]\d{2}|222[1-9]|22[3-9]\d|2[3-6]\d{2}"
    r"|27[01]\d|2720)\d{12}|3[47]\d{13}|6(?:011|5\d{2})\d{12}"
    r"|3(?:0[0-5]|[68]\d)\d{11})$"
)


class ConstrainableDataTypes(enum.Enum):
    NULL = "Unknown"
    FRACTIONAL = "Fractional"
    INTEGRAL = "Integral"
    BOOLEAN = "Boolean"
    STRING = "String"
    NUMERIC = "Numeric"  # Fractional + Integral


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

    def has_column_count(
        self, assertion: Assertion, hint: Optional[str] = None
    ) -> "Check":
        return self.add_constraint(
            AnalysisBasedConstraint(ColumnCount(), assertion, hint=hint)
        )

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

    def _combined_completeness(
        self, columns: Sequence[str], joiner: str, prefix: str, assertion, hint
    ) -> "CheckWithLastConstraintFilterable":
        predicate = f" {joiner} ".join(f"{c} IS NOT NULL" for c in columns)
        name = f"{prefix} Completeness of {','.join(columns)}"
        return self._analysis(
            lambda where: Compliance(name, predicate, where), assertion, hint
        )

    def are_complete(
        self, columns: Sequence[str], hint: Optional[str] = None
    ) -> "CheckWithLastConstraintFilterable":
        return self._combined_completeness(columns, "AND", "Combined", is_one, hint)

    def have_completeness(
        self,
        columns: Sequence[str],
        assertion: Assertion,
        hint: Optional[str] = None,
    ) -> "CheckWithLastConstraintFilterable":
        return self._combined_completeness(columns, "AND", "Combined", assertion, hint)

    def are_any_complete(
        self, columns: Sequence[str], hint: Optional[str] = None
    ) -> "CheckWithLastConstraintFilterable":
        return self._combined_completeness(columns, "OR", "Any", is_one, hint)

    # -- uniqueness family ----------------------------------------------

    def is_unique(
        self, column: str, hint: Optional[str] = None
    ) -> "CheckWithLastConstraintFilterable":
        return self._add_filterable(
            lambda where: NamedConstraint(
                AnalysisBasedConstraint(Uniqueness(column, where), is_one, hint=hint),
                f"UniquenessConstraint({column})",
            )
        )

    def is_primary_key(
        self, column: str, *other_columns: str, hint: Optional[str] = None
    ) -> "CheckWithLastConstraintFilterable":
        columns = (column,) + other_columns
        return self._analysis(lambda where: Uniqueness(columns, where), is_one, hint)

    def has_uniqueness(
        self,
        columns: Union[str, Sequence[str]],
        assertion: Assertion,
        hint: Optional[str] = None,
    ) -> "CheckWithLastConstraintFilterable":
        return self._analysis(lambda where: Uniqueness(columns, where), assertion, hint)

    def has_distinctness(
        self,
        columns: Union[str, Sequence[str]],
        assertion: Assertion,
        hint: Optional[str] = None,
    ) -> "CheckWithLastConstraintFilterable":
        return self._analysis(lambda where: Distinctness(columns, where), assertion, hint)

    def has_unique_value_ratio(
        self,
        columns: Union[str, Sequence[str]],
        assertion: Assertion,
        hint: Optional[str] = None,
    ) -> "CheckWithLastConstraintFilterable":
        return self._analysis(
            lambda where: UniqueValueRatio(columns, where), assertion, hint
        )

    def has_number_of_distinct_values(
        self, column: str, assertion: Assertion, hint: Optional[str] = None
    ) -> "CheckWithLastConstraintFilterable":
        return self._analysis(lambda where: CountDistinct(column, where), assertion, hint)

    # -- distribution ---------------------------------------------------

    def has_histogram_values(
        self,
        column: str,
        assertion: Callable[[Any], bool],
        max_bins: int = 1000,
        hint: Optional[str] = None,
    ) -> "Check":
        return self.add_constraint(
            AnalysisBasedConstraint(
                Histogram(column, max_detail_bins=max_bins), assertion, hint=hint
            )
        )

    def has_entropy(
        self, column: str, assertion: Assertion, hint: Optional[str] = None
    ) -> "CheckWithLastConstraintFilterable":
        return self._analysis(lambda where: Entropy(column, where), assertion, hint)

    def has_mutual_information(
        self,
        column_a: str,
        column_b: str,
        assertion: Assertion,
        hint: Optional[str] = None,
    ) -> "CheckWithLastConstraintFilterable":
        return self._analysis(
            lambda where: MutualInformation((column_a, column_b), where), assertion, hint
        )

    # -- sketches -------------------------------------------------------

    def has_approx_count_distinct(
        self, column: str, assertion: Assertion, hint: Optional[str] = None
    ) -> "CheckWithLastConstraintFilterable":
        return self._analysis(
            lambda where: ApproxCountDistinct(column, where), assertion, hint
        )

    def has_approx_quantile(
        self,
        column: str,
        quantile: float,
        assertion: Assertion,
        hint: Optional[str] = None,
    ) -> "CheckWithLastConstraintFilterable":
        return self._analysis(
            lambda where: ApproxQuantile(column, quantile, where=where), assertion, hint
        )

    def kll_sketch_satisfies(
        self,
        column: str,
        assertion: Callable[[Any], bool],
        kll_parameters=None,
        hint: Optional[str] = None,
    ) -> "Check":
        analyzer = (
            KLLSketch(column, kll_parameters)
            if kll_parameters is not None
            else KLLSketch(column)
        )
        return self.add_constraint(
            AnalysisBasedConstraint(analyzer, assertion, hint=hint)
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

    def has_min_length(
        self, column: str, assertion: Assertion, hint: Optional[str] = None
    ) -> "CheckWithLastConstraintFilterable":
        return self._analysis(lambda where: MinLength(column, where), assertion, hint)

    def has_max_length(
        self, column: str, assertion: Assertion, hint: Optional[str] = None
    ) -> "CheckWithLastConstraintFilterable":
        return self._analysis(lambda where: MaxLength(column, where), assertion, hint)

    def has_correlation(
        self,
        column_a: str,
        column_b: str,
        assertion: Assertion,
        hint: Optional[str] = None,
    ) -> "CheckWithLastConstraintFilterable":
        return self._analysis(
            lambda where: Correlation(column_a, column_b, where), assertion, hint
        )

    # -- predicates -----------------------------------------------------

    def satisfies(
        self,
        column_condition: str,
        constraint_name: str,
        assertion: Assertion = is_one,
        hint: Optional[str] = None,
    ) -> "CheckWithLastConstraintFilterable":
        return self._analysis(
            lambda where: Compliance(constraint_name, column_condition, where),
            assertion,
            hint,
        )

    def has_pattern(
        self,
        column: str,
        pattern: str,
        assertion: Assertion = is_one,
        name: Optional[str] = None,
        hint: Optional[str] = None,
    ) -> "CheckWithLastConstraintFilterable":
        def create(where: Optional[str]) -> Constraint:
            constraint: Constraint = AnalysisBasedConstraint(
                PatternMatch(column, pattern, where), assertion, hint=hint
            )
            if name:
                constraint = NamedConstraint(constraint, name)
            return constraint

        return self._add_filterable(create)

    def contains_credit_card_number(
        self, column: str, assertion: Assertion = is_one
    ) -> "CheckWithLastConstraintFilterable":
        return self.has_pattern(
            column, PATTERN_CREDITCARD, assertion,
            name=f"containsCreditCardNumber({column})",
        )

    def contains_email(
        self, column: str, assertion: Assertion = is_one
    ) -> "CheckWithLastConstraintFilterable":
        return self.has_pattern(
            column, PATTERN_EMAIL, assertion, name=f"containsEmail({column})"
        )

    def contains_url(
        self, column: str, assertion: Assertion = is_one
    ) -> "CheckWithLastConstraintFilterable":
        return self.has_pattern(
            column, PATTERN_URL, assertion, name=f"containsURL({column})"
        )

    def contains_ssn(
        self, column: str, assertion: Assertion = is_one
    ) -> "CheckWithLastConstraintFilterable":
        return self.has_pattern(
            column, PATTERN_SSN, assertion, name=f"containsSSN({column})"
        )

    def has_data_type(
        self,
        column: str,
        data_type: ConstrainableDataTypes,
        assertion: Assertion = is_one,
        hint: Optional[str] = None,
    ) -> "CheckWithLastConstraintFilterable":
        def picker(distribution) -> float:
            total = sum(v.absolute for v in distribution.values.values())
            if total == 0:
                return 0.0
            if data_type == ConstrainableDataTypes.NUMERIC:
                hits = (
                    distribution.values["Fractional"].absolute
                    + distribution.values["Integral"].absolute
                )
            else:
                hits = distribution.values[data_type.value].absolute
            return hits / total

        return self._add_filterable(
            lambda where: AnalysisBasedConstraint(
                DataType(column, where), assertion, value_picker=picker, hint=hint
            )
        )

    # -- sign / range ---------------------------------------------------

    def is_non_negative(
        self, column: str, assertion: Assertion = is_one, hint: Optional[str] = None
    ) -> "CheckWithLastConstraintFilterable":
        # nulls are compliant, matching the reference's COALESCE(col, 0) >= 0
        return self.satisfies(
            f"{column} IS NULL OR {column} >= 0",
            f"{column} is non-negative",
            assertion,
            hint=hint,
        )

    def is_positive(
        self, column: str, assertion: Assertion = is_one, hint: Optional[str] = None
    ) -> "CheckWithLastConstraintFilterable":
        return self.satisfies(
            f"{column} IS NULL OR {column} > 0",
            f"{column} is positive",
            assertion,
            hint=hint,
        )

    def _compare(self, column_a, op, column_b, words, assertion, hint):
        return self.satisfies(
            f"{column_a} {op} {column_b}",
            f"{column_a} is {words} {column_b}",
            assertion,
            hint=hint,
        )

    def is_less_than(
        self, column_a: str, column_b: str, assertion: Assertion = is_one,
        hint: Optional[str] = None,
    ) -> "CheckWithLastConstraintFilterable":
        return self._compare(column_a, "<", column_b, "less than", assertion, hint)

    def is_less_than_or_equal_to(
        self, column_a: str, column_b: str, assertion: Assertion = is_one,
        hint: Optional[str] = None,
    ) -> "CheckWithLastConstraintFilterable":
        return self._compare(
            column_a, "<=", column_b, "less than or equal to", assertion, hint
        )

    def is_greater_than(
        self, column_a: str, column_b: str, assertion: Assertion = is_one,
        hint: Optional[str] = None,
    ) -> "CheckWithLastConstraintFilterable":
        return self._compare(column_a, ">", column_b, "greater than", assertion, hint)

    def is_greater_than_or_equal_to(
        self, column_a: str, column_b: str, assertion: Assertion = is_one,
        hint: Optional[str] = None,
    ) -> "CheckWithLastConstraintFilterable":
        return self._compare(
            column_a, ">=", column_b, "greater than or equal to", assertion, hint
        )

    def is_contained_in(
        self,
        column: str,
        allowed_values: Sequence[Union[str, float]],
        assertion: Assertion = is_one,
        hint: Optional[str] = None,
    ) -> "CheckWithLastConstraintFilterable":
        quoted = ", ".join(
            "'" + v.replace("'", "\\'") + "'" if isinstance(v, str) else str(v)
            for v in allowed_values
        )
        return self.satisfies(
            f"{column} IS NULL OR {column} IN ({quoted})",
            f"{column} contained in {','.join(str(v) for v in allowed_values)}",
            assertion,
            hint=hint,
        )

    def is_in_range(
        self,
        column: str,
        lower: float,
        upper: float,
        include_lower: bool = True,
        include_upper: bool = True,
        hint: Optional[str] = None,
    ) -> "CheckWithLastConstraintFilterable":
        lo_op = ">=" if include_lower else ">"
        hi_op = "<=" if include_upper else "<"
        predicate = (
            f"{column} IS NULL OR ({column} {lo_op} {lower} AND "
            f"{column} {hi_op} {upper})"
        )
        return self.satisfies(
            predicate, f"{column} between {lower} and {upper}", is_one, hint=hint
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
