"""Constraint suggestion rules.

Counterpart of ``deequ_tpu/suggestions/rules.py``: each rule decides
``should_be_applied(profile, num_records)`` and produces a candidate
carrying a description, a ready-to-paste code snippet (Python, this
package's Check DSL, the same string as the JAX package's) and the
constraint itself, applied through this package's Check methods.
``DEFAULT_RULES`` is the reference's default rule set.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, List

from deequ_tpu_torch.checks.check import Check, ConstrainableDataTypes
from deequ_tpu_torch.data.table import Kind
from deequ_tpu_torch.profiles.profiler import (
    NumericColumnProfile,
    StandardColumnProfile,
)


@dataclass
class ConstraintSuggestion:
    constraint_description: str
    column_name: str
    current_value: str
    description: str
    suggesting_rule: str
    code_for_constraint: str
    # applying the suggestion to a Check (used by train/test evaluation)
    apply_to_check: Callable[[Check], Check]


class ConstraintRule:
    """shouldBeApplied + candidate (reference: ConstraintRule)."""

    @property
    def rule_description(self) -> str:
        raise NotImplementedError

    def should_be_applied(
        self, profile: StandardColumnProfile, num_records: int
    ) -> bool:
        raise NotImplementedError

    def candidate(
        self, profile: StandardColumnProfile, num_records: int
    ) -> ConstraintSuggestion:
        raise NotImplementedError


class CompleteIfCompleteRule(ConstraintRule):
    """Column has no nulls -> suggest is_complete."""

    rule_description = (
        "If a column is complete in the sample, we suggest a NOT NULL "
        "constraint"
    )

    def should_be_applied(self, profile, num_records):
        return profile.completeness == 1.0

    def candidate(self, profile, num_records):
        column = profile.column
        return ConstraintSuggestion(
            constraint_description=f"'{column}' is not null",
            column_name=column,
            current_value="Completeness: 1.0",
            description=self.rule_description,
            suggesting_rule=type(self).__name__,
            code_for_constraint=f'.is_complete("{column}")',
            apply_to_check=lambda check: check.is_complete(column),
        )


class RetainCompletenessRule(ConstraintRule):
    """Partially complete column -> keep completeness above the lower
    bound of its binomial confidence interval."""

    rule_description = (
        "If a column is incomplete in the sample, we model its "
        "completeness as a binomial variable and require the estimate "
        "to stay above the interval's lower bound"
    )

    def __init__(self, min_completeness: float = 0.2, max_completeness: float = 1.0):
        self.min_completeness = min_completeness
        self.max_completeness = max_completeness

    def should_be_applied(self, profile, num_records):
        return (
            self.min_completeness <= profile.completeness
            < self.max_completeness
        )

    def candidate(self, profile, num_records):
        column = profile.column
        p = profile.completeness
        n = max(num_records, 1)
        interval = 1.96 * math.sqrt(p * (1 - p) / n)
        bound = round(max(0.0, p - interval), 2)
        return ConstraintSuggestion(
            constraint_description=(
                f"'{column}' has less than {round((1 - bound) * 100)}% "
                "missing values"
            ),
            column_name=column,
            current_value=f"Completeness: {p}",
            description=self.rule_description,
            suggesting_rule=type(self).__name__,
            code_for_constraint=(
                f'.has_completeness("{column}", lambda c: c >= {bound})'
            ),
            apply_to_check=lambda check: check.has_completeness(
                column, lambda c: c >= bound
            ),
        )


class RetainTypeRule(ConstraintRule):
    """String column whose values all parse as a concrete type ->
    constrain the inferred type."""

    rule_description = (
        "If a string column's values parse as a single concrete type, "
        "we suggest a data-type constraint"
    )

    _KIND_TO_DT = {
        Kind.INTEGRAL: ConstrainableDataTypes.INTEGRAL,
        Kind.FRACTIONAL: ConstrainableDataTypes.FRACTIONAL,
        Kind.BOOLEAN: ConstrainableDataTypes.BOOLEAN,
    }

    def should_be_applied(self, profile, num_records):
        return (
            profile.is_data_type_inferred
            and profile.data_type in self._KIND_TO_DT
        )

    def candidate(self, profile, num_records):
        column = profile.column
        dt = self._KIND_TO_DT[profile.data_type]
        # Integral values also satisfy FRACTIONAL (ints embed in floats)
        assert_dt = (
            ConstrainableDataTypes.NUMERIC
            if dt in (ConstrainableDataTypes.INTEGRAL, ConstrainableDataTypes.FRACTIONAL)
            else dt
        )
        return ConstraintSuggestion(
            constraint_description=f"'{column}' has type {dt.value}",
            column_name=column,
            current_value=f"DataType: {profile.data_type.value}",
            description=self.rule_description,
            suggesting_rule=type(self).__name__,
            code_for_constraint=(
                f'.has_data_type("{column}", '
                f"ConstrainableDataTypes.{dt.name})"
            ),
            apply_to_check=lambda check: check.has_data_type(
                column, assert_dt
            ),
        )


class CategoricalRangeRule(ConstraintRule):
    """Low-cardinality column -> values contained in the observed set."""

    rule_description = (
        "If a column has a small set of observed values, we suggest an "
        "IS IN (...) constraint over them"
    )

    def should_be_applied(self, profile, num_records):
        if profile.histogram is None:
            return False
        unique_ratio = profile.approximate_num_distinct_values / max(
            num_records, 1
        )
        return unique_ratio < 0.1

    def candidate(self, profile, num_records):
        column = profile.column
        hist = profile.histogram
        categories = [k for k in hist.values if k != "NullValue"]
        quoted = ", ".join(f'"{c}"' for c in sorted(categories))
        values = sorted(categories)
        return ConstraintSuggestion(
            constraint_description=(
                f"'{column}' has value range {quoted}"
            ),
            column_name=column,
            current_value=f"Distinct values: {len(categories)}",
            description=self.rule_description,
            suggesting_rule=type(self).__name__,
            code_for_constraint=(
                f'.is_contained_in("{column}", [{quoted}])'
            ),
            apply_to_check=lambda check: check.is_contained_in(
                column, values
            ),
        )


class FractionalCategoricalRangeRule(ConstraintRule):
    """Most (default 90%) of the rows fall into a small category set."""

    rule_description = (
        "If most values fall into a small category set, we suggest an "
        "IS IN (...) constraint holding for that fraction of rows"
    )

    def __init__(self, target_data_coverage_fraction: float = 0.9):
        self.target = target_data_coverage_fraction

    def should_be_applied(self, profile, num_records):
        hist = profile.histogram
        if hist is None or num_records == 0:
            return False
        top = sorted(
            (dv.ratio for k, dv in hist.values.items() if k != "NullValue"),
            reverse=True,
        )
        covered = 0.0
        for i, r in enumerate(top):
            covered += r
            if covered >= self.target:
                return i + 1 < len(top)  # strictly smaller set than all
        return False

    def candidate(self, profile, num_records):
        column = profile.column
        hist = profile.histogram
        ranked = sorted(
            (
                (k, dv.ratio)
                for k, dv in hist.values.items()
                if k != "NullValue"
            ),
            key=lambda kv: -kv[1],
        )
        covered = 0.0
        keep: List[str] = []
        for k, r in ranked:
            keep.append(k)
            covered += r
            if covered >= self.target:
                break
        quoted = ", ".join(f'"{c}"' for c in keep)
        # assert at a slightly laxer bound than observed coverage
        bound = round(max(0.0, covered - 0.05), 2)
        values = list(keep)
        return ConstraintSuggestion(
            constraint_description=(
                f"'{column}' has value range {quoted} for at least "
                f"{round(bound * 100)}% of values"
            ),
            column_name=column,
            current_value=f"Coverage: {covered:.2f}",
            description=self.rule_description,
            suggesting_rule=type(self).__name__,
            code_for_constraint=(
                f'.is_contained_in("{column}", [{quoted}], '
                f"lambda v: v >= {bound})"
            ),
            apply_to_check=lambda check: check.is_contained_in(
                column, values, lambda v: v >= bound
            ),
        )


class NonNegativeNumbersRule(ConstraintRule):
    """Numeric column with min >= 0 -> suggest non-negativity."""

    rule_description = (
        "If a numeric column's observed minimum is non-negative, we "
        "suggest a non-negativity constraint"
    )

    def should_be_applied(self, profile, num_records):
        return (
            isinstance(profile, NumericColumnProfile)
            and profile.minimum is not None
            and profile.minimum >= 0.0
        )

    def candidate(self, profile, num_records):
        column = profile.column
        return ConstraintSuggestion(
            constraint_description=f"'{column}' has no negative values",
            column_name=column,
            current_value=f"Minimum: {profile.minimum}",
            description=self.rule_description,
            suggesting_rule=type(self).__name__,
            code_for_constraint=f'.is_non_negative("{column}")',
            apply_to_check=lambda check: check.is_non_negative(column),
        )


class UniqueIfApproximatelyUniqueRule(ConstraintRule):
    """Approx distinct count ~ row count -> suggest uniqueness."""

    rule_description = (
        "If the approximate distinct count is within the sketch's error "
        "of the row count, we suggest a UNIQUE constraint"
    )

    def should_be_applied(self, profile, num_records):
        if num_records == 0 or profile.completeness < 1.0:
            return False
        uniqueness = profile.approximate_num_distinct_values / num_records
        return abs(1.0 - uniqueness) <= 0.08

    def candidate(self, profile, num_records):
        column = profile.column
        return ConstraintSuggestion(
            constraint_description=f"'{column}' is unique",
            column_name=column,
            current_value=(
                f"ApproxDistinctness: "
                f"{profile.approximate_num_distinct_values / max(num_records, 1)}"
            ),
            description=self.rule_description,
            suggesting_rule=type(self).__name__,
            code_for_constraint=f'.is_unique("{column}")',
            apply_to_check=lambda check: check.is_unique(column),
        )


DEFAULT_RULES: List[ConstraintRule] = [
    CompleteIfCompleteRule(),
    RetainCompletenessRule(),
    RetainTypeRule(),
    CategoricalRangeRule(),
    FractionalCategoricalRangeRule(),
    NonNegativeNumbersRule(),
    UniqueIfApproximatelyUniqueRule(),
]
