"""Metrics repository: persisted metric series keyed by time and tags.

Counterpart of ``deequ_tpu/repository/base.py``. A repository saves and
loads ``AnalysisResult``s by ``ResultKey(timestamp, tags)``; its loader
filters by time (``after``/``before``), by tags and by analyzers, and
exports records or JSON. Pure Python; it feeds the anomaly checks
(``anomalydetection/wiring.py``).
"""

from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from deequ_tpu_torch.analyzers.base import Analyzer
from deequ_tpu_torch.analyzers.runner import AnalyzerContext


@dataclass(frozen=True)
class ResultKey:
    """Identifies one analysis run: epoch-millis timestamp + tags."""

    dataset_date: int
    tags: Tuple[Tuple[str, str], ...] = ()

    @staticmethod
    def of(dataset_date: Optional[int] = None, tags: Optional[Dict[str, str]] = None) -> "ResultKey":
        if dataset_date is None:
            dataset_date = ResultKey.current_milli_time()
        return ResultKey(dataset_date, tuple(sorted((tags or {}).items())))

    @staticmethod
    def current_milli_time() -> int:
        return int(time.time() * 1000)

    @property
    def tags_dict(self) -> Dict[str, str]:
        return dict(self.tags)


@dataclass
class AnalysisResult:
    result_key: ResultKey
    analyzer_context: AnalyzerContext


class MetricsRepository:
    def save(self, result: AnalysisResult) -> None:
        raise NotImplementedError

    def load_by_key(self, key: ResultKey) -> Optional[AnalysisResult]:
        raise NotImplementedError

    def load(self) -> "MetricsRepositoryMultipleResultsLoader":
        raise NotImplementedError


class MetricsRepositoryMultipleResultsLoader:
    """A fluent query over stored results:
    ``repository.load().after(t).before(t).with_tag_values(m).get()``.
    ``after`` and ``before`` are inclusive; ``get`` sorts by date."""

    def __init__(self, results: Sequence[AnalysisResult]):
        self._results = list(results)
        self._after: Optional[int] = None
        self._before: Optional[int] = None
        self._tag_values: Optional[Dict[str, str]] = None
        self._for_analyzers: Optional[List[Analyzer]] = None

    def after(self, dataset_date: int) -> "MetricsRepositoryMultipleResultsLoader":
        self._after = dataset_date
        return self

    def before(self, dataset_date: int) -> "MetricsRepositoryMultipleResultsLoader":
        self._before = dataset_date
        return self

    def with_tag_values(self, tag_values: Dict[str, str]) -> "MetricsRepositoryMultipleResultsLoader":
        self._tag_values = tag_values
        return self

    def for_analyzers(self, analyzers: Sequence[Analyzer]) -> "MetricsRepositoryMultipleResultsLoader":
        self._for_analyzers = list(analyzers)
        return self

    def get(self) -> List[AnalysisResult]:
        out = []
        for result in self._results:
            key = result.result_key
            if self._after is not None and key.dataset_date < self._after:
                continue
            if self._before is not None and key.dataset_date > self._before:
                continue
            if self._tag_values is not None:
                tags = key.tags_dict
                if any(tags.get(k) != v for k, v in self._tag_values.items()):
                    continue
            context = result.analyzer_context
            if self._for_analyzers is not None:
                context = AnalyzerContext(
                    {a: m for a, m in context.metric_map.items() if a in self._for_analyzers}
                )
            out.append(AnalysisResult(key, context))
        return sorted(out, key=lambda r: r.result_key.dataset_date)

    def get_success_metrics_as_records(self) -> List[Dict]:
        records = []
        for result in self.get():
            for rec in result.analyzer_context.success_metrics_as_records():
                rec = dict(rec)
                rec["dataset_date"] = result.result_key.dataset_date
                rec.update(result.result_key.tags_dict)
                records.append(rec)
        return records

    def get_success_metrics_as_json(self) -> str:
        return json.dumps(self.get_success_metrics_as_records(), indent=2)

    def get_success_metrics_as_dataframe(self):
        import pandas as pd

        return pd.DataFrame(self.get_success_metrics_as_records())


class InMemoryMetricsRepository(MetricsRepository):
    """Results in a dict behind a lock (safe for concurrent writers)."""

    def __init__(self) -> None:
        self._store: Dict[ResultKey, AnalysisResult] = {}
        self._lock = threading.Lock()

    def save(self, result: AnalysisResult) -> None:
        _bump("repository.saves")
        with self._lock:
            self._store[result.result_key] = result

    def load_by_key(self, key: ResultKey) -> Optional[AnalysisResult]:
        _bump("repository.loads")
        with self._lock:
            return self._store.get(key)

    def load(self) -> MetricsRepositoryMultipleResultsLoader:
        _bump("repository.loads")
        with self._lock:
            return MetricsRepositoryMultipleResultsLoader(list(self._store.values()))


def _bump(counter: str) -> None:
    from deequ_tpu_torch.telemetry import get_telemetry

    get_telemetry().counter(counter).inc()
