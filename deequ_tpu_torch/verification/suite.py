"""VerificationSuite: the top user entry point.

Counterpart of ``deequ_tpu/verification/suite.py``: collect the required
analyzers of every check, delegate to the AnalysisRunner (ONE fused
scan), evaluate each check against the AnalyzerContext (pure metric
lookups), and aggregate the statuses. Also the incremental variant
``run_on_aggregated_states`` (checks over merged persisted states, no
data), and the repository wiring: reuse and save of a run's metrics,
and anomaly checks of a metric against its stored history
(``anomalydetection/wiring.py``).

A run whose scans quarantined batches, or that a cancel or a deadline
stopped, computed its metrics over PARTIAL data: its status is floored
as ``config.degradation_policy`` says ("fail": Error, "warn": at least
Warning, "tolerate": the checks alone), and ``result.degradation`` and
``result.interruption`` carry the records either way.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Sequence

from deequ_tpu_torch.analyzers.base import Analyzer
from deequ_tpu_torch.analyzers.runner import AnalysisRunner, AnalyzerContext
from deequ_tpu_torch.checks.check import Check, CheckLevel, CheckResult, CheckStatus
from deequ_tpu_torch.data.table import Dataset, Schema
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
        degradation=None,
        interruption=None,
    ):
        self.status = status
        self.check_results = check_results
        self.metrics = metrics
        # engine/resilience.ScanDegradation and engine/deadline
        # .ScanInterruption of the run (None: none)
        self.degradation = degradation
        self.interruption = interruption

    def success_metrics_as_records(self) -> List[Dict[str, Any]]:
        return AnalyzerContext(self.metrics).success_metrics_as_records()

    def success_metrics_as_json(self) -> str:
        return AnalyzerContext(self.metrics).success_metrics_as_json()

    def success_metrics_as_dataframe(self):
        """The success metrics as a ``pandas.DataFrame`` (pandas is
        imported here only)."""
        return AnalyzerContext(self.metrics).success_metrics_as_dataframe()

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

    def check_results_as_dataframe(self):
        """The check results as a ``pandas.DataFrame`` (pandas is
        imported here only)."""
        import pandas as pd

        return pd.DataFrame(self.check_results_as_records())


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
        metrics_repository=None,
        reuse_existing_results_for_key=None,
        fail_if_results_missing: bool = False,
        save_or_append_results_with_key=None,
        deadline=None,
        cancel=None,
    ) -> VerificationResult:
        """Run every check. ``deadline`` (seconds or a ``RunBudget``) and
        ``cancel`` (a ``CancelToken``) bound the run: an interrupt still
        returns a result, with partial metrics, the status floored by
        ``config.degradation_policy`` and ``result.interruption``."""
        analyzers = list(required_analyzers) + [
            a for check in checks for a in check.required_analyzers()
        ]
        context = AnalysisRunner.do_analysis_run(
            data,
            analyzers,
            aggregate_with=aggregate_with,
            save_states_with=save_states_with,
            engine=engine,
            metrics_repository=metrics_repository,
            reuse_existing_results_for_key=reuse_existing_results_for_key,
            fail_if_results_missing=fail_if_results_missing,
            save_or_append_results_with_key=save_or_append_results_with_key,
            deadline=deadline,
            cancel=cancel,
        )
        return VerificationSuite.evaluate(checks, context)

    @staticmethod
    def install_graceful_shutdown(signals=None):
        """Map SIGTERM (or ``signals``) onto the process-wide shutdown
        token, so every supervised run stops cleanly (final checkpoint,
        partial metrics) when the orchestrator says stop. Returns an
        ``uninstall()`` callable (``engine/deadline.py``)."""
        from deequ_tpu_torch.engine.deadline import install_graceful_shutdown

        return install_graceful_shutdown(signals)

    @staticmethod
    def run_on_aggregated_states(
        schema: Schema,
        checks: Sequence[Check],
        state_loaders: Sequence[Any],
        required_analyzers: Sequence[Analyzer] = (),
        save_states_with=None,
    ) -> VerificationResult:
        """The checks over the merged states of ``state_loaders``,
        without the data."""
        analyzers = list(required_analyzers) + [
            a for check in checks for a in check.required_analyzers()
        ]
        context = AnalysisRunner.run_on_aggregated_states(
            schema, analyzers, state_loaders, save_states_with
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
        degradation, interruption = context.degradation, context.interruption
        if (degradation is not None and degradation.is_degraded) or interruption is not None:
            from deequ_tpu_torch import config

            policy = config.options().degradation_policy
            if policy not in ("fail", "warn", "tolerate"):
                raise ValueError("config.degradation_policy must be 'fail', 'warn' or "
                                 f"'tolerate', got {policy!r}")
            floor = {"fail": CheckStatus.ERROR, "warn": CheckStatus.WARNING,
                     "tolerate": status}[policy]
            status = max((status, floor), key=lambda s: _STATUS_ORDER.index(s.value))
        return VerificationResult(status, check_results, context.metric_map,
                                  degradation, interruption)


class VerificationRunBuilder:
    """Fluent builder (reference: VerificationRunBuilder.scala)."""

    def __init__(self, data: Dataset):
        self._data = data
        self._checks: List[Check] = []
        self._required_analyzers: List[Analyzer] = []
        self._engine: Optional[AnalysisEngine] = None
        self._aggregate_with = None
        self._save_states_with = None
        self._repository = None
        self._reuse_key = None
        self._fail_if_results_missing = False
        self._save_key = None
        self._anomaly_checks: List = []
        self._deadline = None
        self._cancel = None

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

    def with_deadline(self, deadline) -> "VerificationRunBuilder":
        """Bound the run: seconds, or a ``RunBudget``."""
        self._deadline = deadline
        return self

    def with_cancel(self, cancel) -> "VerificationRunBuilder":
        """A ``CancelToken`` that stops the run cleanly when cancelled."""
        self._cancel = cancel
        return self

    def aggregate_with(self, state_loader) -> "VerificationRunBuilder":
        self._aggregate_with = state_loader
        return self

    def save_states_with(self, state_persister) -> "VerificationRunBuilder":
        self._save_states_with = state_persister
        return self

    def use_repository(self, repository) -> "VerificationRunBuilder":
        self._repository = repository
        return self

    def reuse_existing_results_for_key(
        self, key, fail_if_results_missing: bool = False
    ) -> "VerificationRunBuilder":
        self._reuse_key = key
        self._fail_if_results_missing = fail_if_results_missing
        return self

    def save_or_append_result(self, key) -> "VerificationRunBuilder":
        self._save_key = key
        return self

    def add_anomaly_check(
        self, strategy, analyzer: Analyzer, anomaly_check_config=None
    ) -> "VerificationRunBuilder":
        """Check ``analyzer``'s metric against its history in the
        repository: the strategy decides whether this run's value is
        anomalous. Needs ``use_repository`` first."""
        if self._repository is None:
            raise ValueError("add_anomaly_check requires use_repository(...) first")
        from deequ_tpu_torch.anomalydetection.wiring import AnomalyCheckConfig

        config = anomaly_check_config or AnomalyCheckConfig(
            level=CheckLevel.WARNING,
            description=f"Anomaly check for {analyzer.name}({analyzer.instance})",
        )
        self._anomaly_checks.append((strategy, analyzer, config))
        return self

    def run(self) -> VerificationResult:
        from deequ_tpu_torch.anomalydetection.wiring import build_anomaly_check

        checks = list(self._checks) + [
            build_anomaly_check(
                self._repository, strategy, analyzer, config, current_key=self._save_key
            )
            for strategy, analyzer, config in self._anomaly_checks
        ]
        return VerificationSuite.do_verification_run(
            self._data,
            checks,
            required_analyzers=self._required_analyzers,
            aggregate_with=self._aggregate_with,
            save_states_with=self._save_states_with,
            engine=self._engine,
            metrics_repository=self._repository,
            reuse_existing_results_for_key=self._reuse_key,
            fail_if_results_missing=self._fail_if_results_missing,
            save_or_append_results_with_key=self._save_key,
            deadline=self._deadline,
            cancel=self._cancel,
        )
