"""VerificationSuite: the top user entry point.

Counterpart of ``deequ_tpu/verification/suite.py``: collect the required
analyzers of every check, delegate to the AnalysisRunner (ONE fused
scan), evaluate each check against the AnalyzerContext (pure metric
lookups), and aggregate the statuses.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Sequence

from deequ_tpu_torch.analyzers.base import Analyzer
from deequ_tpu_torch.analyzers.runner import AnalysisRunner, AnalyzerContext
from deequ_tpu_torch.checks.check import Check, CheckResult, CheckStatus
from deequ_tpu_torch.data.table import Dataset
from deequ_tpu_torch.engine.scan import AnalysisEngine
from deequ_tpu_torch.metrics.metric import Metric

_STATUS_ORDER = ["Success", "Warning", "Error"]


class VerificationResult:
    """Overall status + per-check results + all computed metrics."""

    def __init__(
        self,
        status: CheckStatus,
        check_results: Dict[Check, CheckResult],
        metrics: Dict[Analyzer, Metric],
    ):
        self.status = status
        self.check_results = check_results
        self.metrics = metrics

    def success_metrics_as_records(self) -> List[Dict[str, Any]]:
        return AnalyzerContext(self.metrics).success_metrics_as_records()

    def success_metrics_as_json(self) -> str:
        return AnalyzerContext(self.metrics).success_metrics_as_json()

    def check_results_as_records(self) -> List[Dict[str, Any]]:
        records = []
        for check, result in self.check_results.items():
            for cr in result.constraint_results:
                records.append(
                    {
                        "check": check.description,
                        "check_level": check.level.value,
                        "check_status": result.status.value,
                        "constraint": str(cr.constraint),
                        "constraint_status": cr.status.value,
                        "constraint_message": cr.message or "",
                    }
                )
        return records

    def check_results_as_json(self) -> str:
        return json.dumps(self.check_results_as_records(), indent=2)


class VerificationSuite:
    def on_data(self, data: Dataset) -> "VerificationRunBuilder":
        return VerificationRunBuilder(data)

    @staticmethod
    def do_verification_run(
        data: Dataset,
        checks: Sequence[Check],
        required_analyzers: Sequence[Analyzer] = (),
        aggregate_with=None,
        save_states_with=None,
        engine: Optional[AnalysisEngine] = None,
    ) -> VerificationResult:
        analyzers = list(required_analyzers) + [
            a for check in checks for a in check.required_analyzers()
        ]
        context = AnalysisRunner.do_analysis_run(
            data,
            analyzers,
            aggregate_with=aggregate_with,
            save_states_with=save_states_with,
            engine=engine,
        )
        return VerificationSuite.evaluate(checks, context)

    @staticmethod
    def evaluate(
        checks: Sequence[Check], context: AnalyzerContext
    ) -> VerificationResult:
        check_results = {check: check.evaluate(context) for check in checks}
        status = max(
            (r.status for r in check_results.values()),
            key=lambda s: _STATUS_ORDER.index(s.value),
            default=CheckStatus.SUCCESS,
        )
        return VerificationResult(status, check_results, context.metric_map)


class VerificationRunBuilder:
    """Fluent builder (reference: VerificationRunBuilder.scala)."""

    def __init__(self, data: Dataset):
        self._data = data
        self._checks: List[Check] = []
        self._required_analyzers: List[Analyzer] = []
        self._engine: Optional[AnalysisEngine] = None
        self._aggregate_with = None
        self._save_states_with = None

    def add_check(self, check: Check) -> "VerificationRunBuilder":
        self._checks.append(check)
        return self

    def add_checks(self, checks: Sequence[Check]) -> "VerificationRunBuilder":
        self._checks.extend(checks)
        return self

    def add_required_analyzer(self, analyzer: Analyzer) -> "VerificationRunBuilder":
        self._required_analyzers.append(analyzer)
        return self

    def add_required_analyzers(
        self, analyzers: Sequence[Analyzer]
    ) -> "VerificationRunBuilder":
        self._required_analyzers.extend(analyzers)
        return self

    def with_engine(self, engine: AnalysisEngine) -> "VerificationRunBuilder":
        self._engine = engine
        return self

    def aggregate_with(self, state_loader) -> "VerificationRunBuilder":
        self._aggregate_with = state_loader
        return self

    def save_states_with(self, state_persister) -> "VerificationRunBuilder":
        self._save_states_with = state_persister
        return self

    def run(self) -> VerificationResult:
        return VerificationSuite.do_verification_run(
            self._data,
            self._checks,
            required_analyzers=self._required_analyzers,
            aggregate_with=self._aggregate_with,
            save_states_with=self._save_states_with,
            engine=self._engine,
        )
