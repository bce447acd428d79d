"""ConstraintSuggestionRunner: profile, apply the rules, and optionally
verify the suggestions on a held-out split.

Counterpart of ``deequ_tpu/suggestions/runner.py``. The split draws
``np.random.default_rng(seed).random(n) < ratio`` as the JAX package
does, so both packages hold out the same rows.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from deequ_tpu_torch.checks.check import Check, CheckLevel
from deequ_tpu_torch.data.table import Dataset
from deequ_tpu_torch.engine.scan import AnalysisEngine
from deequ_tpu_torch.profiles.profiler import (
    DEFAULT_LOW_CARDINALITY_THRESHOLD,
    ColumnProfiler,
    ColumnProfiles,
)
from deequ_tpu_torch.sketches.kll import KLLParameters
from deequ_tpu_torch.suggestions.rules import ConstraintRule, ConstraintSuggestion
from deequ_tpu_torch.verification.suite import VerificationResult, VerificationSuite


@dataclass
class ConstraintSuggestionResult:
    column_profiles: ColumnProfiles
    constraint_suggestions: Dict[str, List[ConstraintSuggestion]] = field(
        default_factory=dict
    )
    verification_result: Optional[VerificationResult] = None

    def all_suggestions(self) -> List[ConstraintSuggestion]:
        return [s for group in self.constraint_suggestions.values() for s in group]


class ConstraintSuggestionRunner:
    def on_data(self, data: Dataset) -> "ConstraintSuggestionRunBuilder":
        return ConstraintSuggestionRunBuilder(data)


class ConstraintSuggestionRunBuilder:
    def __init__(self, data: Dataset):
        self._data = data
        self._rules: List[ConstraintRule] = []
        self._restrict_to_columns: Optional[Sequence[str]] = None
        self._low_cardinality_threshold: Optional[int] = None
        self._kll_profiling = False
        self._kll_parameters: Optional[KLLParameters] = None
        self._testset_ratio: Optional[float] = None
        self._testset_seed: int = 42
        self._engine: Optional[AnalysisEngine] = None

    def add_constraint_rule(self, rule: ConstraintRule) -> "ConstraintSuggestionRunBuilder":
        self._rules.append(rule)
        return self

    def add_constraint_rules(
        self, rules: Sequence[ConstraintRule]
    ) -> "ConstraintSuggestionRunBuilder":
        self._rules.extend(rules)
        return self

    def restrict_to_columns(self, columns: Sequence[str]) -> "ConstraintSuggestionRunBuilder":
        self._restrict_to_columns = list(columns)
        return self

    def with_low_cardinality_histogram_threshold(
        self, threshold: int
    ) -> "ConstraintSuggestionRunBuilder":
        self._low_cardinality_threshold = threshold
        return self

    def with_kll_profiling(
        self, kll_parameters: Optional[KLLParameters] = None
    ) -> "ConstraintSuggestionRunBuilder":
        self._kll_profiling = True
        self._kll_parameters = kll_parameters
        return self

    def use_train_test_split_with_testset_ratio(
        self, testset_ratio: float, seed: int = 42
    ) -> "ConstraintSuggestionRunBuilder":
        if not 0.0 < testset_ratio < 1.0:
            raise ValueError("testset_ratio must be in (0, 1)")
        self._testset_ratio = testset_ratio
        self._testset_seed = seed
        return self

    def with_engine(self, engine: AnalysisEngine) -> "ConstraintSuggestionRunBuilder":
        self._engine = engine
        return self

    def run(self) -> ConstraintSuggestionResult:
        train, test = self.split()
        profiles = ColumnProfiler.profile(
            train,
            restrict_to_columns=self._restrict_to_columns,
            low_cardinality_histogram_threshold=(
                self._low_cardinality_threshold or DEFAULT_LOW_CARDINALITY_THRESHOLD
            ),
            kll_profiling=self._kll_profiling,
            kll_parameters=self._kll_parameters,
            engine=self._engine,
        )
        suggestions: Dict[str, List[ConstraintSuggestion]] = {}
        for column, profile in profiles.profiles.items():
            for rule in self._rules:
                try:
                    if rule.should_be_applied(profile, profiles.num_records):
                        suggestions.setdefault(column, []).append(
                            rule.candidate(profile, profiles.num_records)
                        )
                except Exception:  # noqa: BLE001 — a rule must not kill the run
                    continue

        verification_result = None
        if test is not None and any(suggestions.values()):
            check = Check(CheckLevel.WARNING, "Suggested constraints (holdout eval)")
            for group in suggestions.values():
                for suggestion in group:
                    check = suggestion.apply_to_check(check)
            verification_result = (
                VerificationSuite().on_data(test).add_check(check)
                .with_engine(self._engine).run()
            )
        return ConstraintSuggestionResult(profiles, suggestions, verification_result)

    def split(self) -> Tuple[Dataset, Optional[Dataset]]:
        """(train, test): the whole dataset and None without a test
        ratio, else the rows outside and inside the held-out draw."""
        if self._testset_ratio is None:
            return self._data, None
        rng = np.random.default_rng(self._testset_seed)
        test_mask = rng.random(self._data.num_rows) < self._testset_ratio
        return self._data.filter_rows(~test_mask), self._data.filter_rows(test_mask)
