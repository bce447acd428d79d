"""RunListener: callback API over run execution, analogous to Spark's
``SparkListener``/deequ's reliance on the Spark UI (SURVEY.md §5.1).

Listeners observe; they must never steer. Every callback is dispatched
best-effort — an exception inside a listener is swallowed (recorded on
the ``telemetry.listener_errors`` counter) so a broken dashboard hook
cannot fail a verification run.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional


class RunListener:
    """Subclass and override the callbacks you care about.

    Callback timing:

    - ``on_run_start/on_run_end`` — one analysis/verification run
      (``AnalysisRunner.do_analysis_run`` granularity)
    - ``on_pass_start/on_pass_end`` — one engine pass (fused scan,
      frequency pass, direct analyzers)
    - ``on_analyzer_computed`` — each (analyzer, metric) as the run
      assembles its AnalyzerContext (failure metrics included)
    - ``on_check_evaluated`` — each (check, check_result) as the
      VerificationSuite evaluates checks
    - ``on_engine_event`` — structured engine events (``scan_phases``
      wall decomposition, ``grouping_spill`` fallbacks, ...)
    """

    def on_run_start(self, run_id: int, name: str) -> None:
        pass

    def on_run_end(self, run_id: int, name: str, summary: Optional[Dict[str, Any]]) -> None:
        pass

    def on_pass_start(self, name: str, rows: int, num_analyzers: int) -> None:
        pass

    def on_pass_end(
        self, name: str, wall_s: float, rows: int, num_analyzers: int
    ) -> None:
        pass

    def on_analyzer_computed(self, analyzer: Any, metric: Any) -> None:
        pass

    def on_check_evaluated(self, check: Any, result: Any) -> None:
        pass

    def on_engine_event(self, event: Dict[str, Any]) -> None:
        pass


class CollectingRunListener(RunListener):
    """Records every callback (tests, notebooks, debugging)."""

    def __init__(self) -> None:
        self.run_starts: List[tuple] = []
        self.run_ends: List[tuple] = []
        self.pass_starts: List[tuple] = []
        self.pass_ends: List[tuple] = []
        self.analyzers_computed: List[tuple] = []
        self.checks_evaluated: List[tuple] = []
        self.engine_events: List[Dict[str, Any]] = []

    def on_run_start(self, run_id, name):
        self.run_starts.append((run_id, name))

    def on_run_end(self, run_id, name, summary):
        self.run_ends.append((run_id, name, summary))

    def on_pass_start(self, name, rows, num_analyzers):
        self.pass_starts.append((name, rows, num_analyzers))

    def on_pass_end(self, name, wall_s, rows, num_analyzers):
        self.pass_ends.append((name, wall_s, rows, num_analyzers))

    def on_analyzer_computed(self, analyzer, metric):
        self.analyzers_computed.append((analyzer, metric))

    def on_check_evaluated(self, check, result):
        self.checks_evaluated.append((check, result))

    def on_engine_event(self, event):
        self.engine_events.append(event)
