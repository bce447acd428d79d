"""Constraint suggestion: rules over column profiles, and their runner."""

from deequ_tpu_torch.suggestions.rules import (
    DEFAULT_RULES,
    CategoricalRangeRule,
    CompleteIfCompleteRule,
    ConstraintRule,
    ConstraintSuggestion,
    FractionalCategoricalRangeRule,
    NonNegativeNumbersRule,
    RetainCompletenessRule,
    RetainTypeRule,
    UniqueIfApproximatelyUniqueRule,
)
from deequ_tpu_torch.suggestions.runner import (
    ConstraintSuggestionResult,
    ConstraintSuggestionRunBuilder,
    ConstraintSuggestionRunner,
)

__all__ = [
    "CategoricalRangeRule",
    "CompleteIfCompleteRule",
    "ConstraintRule",
    "ConstraintSuggestion",
    "ConstraintSuggestionResult",
    "ConstraintSuggestionRunBuilder",
    "ConstraintSuggestionRunner",
    "DEFAULT_RULES",
    "FractionalCategoricalRangeRule",
    "NonNegativeNumbersRule",
    "RetainCompletenessRule",
    "RetainTypeRule",
    "UniqueIfApproximatelyUniqueRule",
]
