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
    "TableMetricsRepository",
]


def __getattr__(name: str):
    # TableMetricsRepository writes parquet: pyarrow is imported only
    # when it is asked for
    if name == "TableMetricsRepository":
        from deequ_tpu_torch.repository.table import TableMetricsRepository

        return TableMetricsRepository
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
