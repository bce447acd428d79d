"""Metrics repositories (counterpart of ``deequ_tpu/repository``)."""

from deequ_tpu_torch.repository.base import (
    AnalysisResult,
    InMemoryMetricsRepository,
    MetricsRepository,
    MetricsRepositoryMultipleResultsLoader,
    ResultKey,
)
from deequ_tpu_torch.repository.fs import FileSystemMetricsRepository

__all__ = [
    "AnalysisResult",
    "FileSystemMetricsRepository",
    "InMemoryMetricsRepository",
    "MetricsRepository",
    "MetricsRepositoryMultipleResultsLoader",
    "ResultKey",
]
