"""deequ_tpu_torch — the PyTorch/CUDA port of deequ_tpu.

Declarative data-quality checks evaluated against metrics that one fused
pass over device-resident columns computes. The engine runs on a CUDA
device unless the caller asks for the CPU (``device="cpu"`` on
:class:`AnalysisEngine`, or ``config.set_option(device="cpu")``); the
HLL register build runs through a hand-written Hopper kernel
(``csrc/scatter_max.cu``), built from source at first use. ``where=``
filters and Compliance predicates compile from SQL expressions
(``sql/predicate.py``). KLL quantile sketches fold their per-batch
samples on the host (``sketches/kll.py``). Grouping analyzers count
dense joint codes in the same pass, or sort high-cardinality keys on the
device after it (``analyzers/grouping.py``, ``analyzers/spill.py``).
``ColumnProfilerRunner`` profiles every column in up to three such
passes, and ``ConstraintSuggestionRunner`` turns the profiles into
suggested constraints (``profiles/``, ``suggestions/``). States persist
(``io/``) and merge without the data; metrics persist in repositories
(``repository/``) that anomaly checks read. A scan whose columns fit
``config.device_cache_bytes`` keeps them resident on the device;
otherwise it streams them batch by batch through pinned staging
buffers (``engine/scan.py``, ``engine/wire.py``). ``Dataset.from_parquet``
reads parquet files lazily and streams them through an ordered pool of
decode threads (``data/parquet.py``, ``engine/ingest.py``); the parquet
paths and ``TableMetricsRepository`` need pyarrow, the rest of the
package does not. A scan retries a failing source batch and quarantines
one that keeps failing (``RetryPolicy``, ``ScanDegradation``), resumes
from a ``ScanCheckpointer``, stops cleanly under a ``RunBudget`` or a
``CancelToken`` (``ScanInterruption``), and feeds an update that runs
out of device memory again in halved slices (``engine/resilience.py``,
``engine/deadline.py``, ``engine/memory.py``).

The package mirrors the module paths of ``deequ_tpu``, the JAX package
it is checked against, and imports nothing of it.
"""

from __future__ import annotations

from deequ_tpu_torch import config
from deequ_tpu_torch.analyzers import (
    AnalysisRunner,
    AnalyzerContext,
    Applicability,
    ApproxCountDistinct,
    ApproxQuantile,
    ApproxQuantiles,
    ColumnCount,
    Completeness,
    Compliance,
    Correlation,
    CountDistinct,
    CustomSql,
    DataType,
    Distinctness,
    Entropy,
    Histogram,
    KLLSketch,
    Maximum,
    MaxLength,
    Mean,
    Minimum,
    MinLength,
    MutualInformation,
    PatternMatch,
    RatioOfSums,
    Size,
    StandardDeviation,
    Sum,
    Uniqueness,
    UniqueValueRatio,
)
from deequ_tpu_torch.anomalydetection import (
    AbsoluteChangeStrategy,
    AnomalyCheckConfig,
    AnomalyDetector,
    BatchNormalStrategy,
    DataPoint,
    HoltWinters,
    MetricInterval,
    OnlineNormalStrategy,
    RelativeRateOfChangeStrategy,
    SeriesSeasonality,
    SimpleThresholdStrategy,
)
from deequ_tpu_torch.anomalydetection.seasonal import SeasonalityModel
from deequ_tpu_torch.checks import Check, CheckLevel, CheckStatus
from deequ_tpu_torch.data import Dataset, DictionaryColumn
from deequ_tpu_torch.engine import AnalysisEngine
from deequ_tpu_torch.engine.deadline import (
    CancelToken,
    DeadlineExceeded,
    RunBudget,
    RunCancelled,
    ScanInterruption,
    install_graceful_shutdown,
)
from deequ_tpu_torch.engine.resilience import (
    RetryPolicy,
    ScanDegradation,
    ScanStalled,
    TransientScanError,
)
from deequ_tpu_torch.io.state_provider import (
    FileSystemStateProvider,
    InMemoryStateProvider,
    ScanCheckpointer,
)
from deequ_tpu_torch.metrics import (
    DoubleMetric,
    Entity,
    HistogramMetric,
    KLLMetric,
    Metric,
)
from deequ_tpu_torch.profiles import ColumnProfiler, ColumnProfilerRunner, ColumnProfiles
from deequ_tpu_torch.repository import (
    AnalysisResult,
    FileSystemMetricsRepository,
    InMemoryMetricsRepository,
    MetricsRepository,
    ResultKey,
)
from deequ_tpu_torch.schema import RowLevelSchema, RowLevelSchemaValidator
from deequ_tpu_torch.sketches.kll import KLLParameters
from deequ_tpu_torch.suggestions import (
    DEFAULT_RULES,
    ConstraintSuggestionResult,
    ConstraintSuggestionRunner,
)
from deequ_tpu_torch.utils.observe import RunMetadata
from deequ_tpu_torch.verification import VerificationResult, VerificationSuite

__all__ = [
    "AbsoluteChangeStrategy",
    "AnalysisEngine",
    "AnalysisResult",
    "AnalysisRunner",
    "AnalyzerContext",
    "AnomalyCheckConfig",
    "AnomalyDetector",
    "Applicability",
    "ApproxCountDistinct",
    "ApproxQuantile",
    "ApproxQuantiles",
    "BatchNormalStrategy",
    "CancelToken",
    "Check",
    "CheckLevel",
    "CheckStatus",
    "ColumnCount",
    "ColumnProfiler",
    "ColumnProfilerRunner",
    "ColumnProfiles",
    "Completeness",
    "Compliance",
    "config",
    "ConstraintSuggestionResult",
    "ConstraintSuggestionRunner",
    "Correlation",
    "CountDistinct",
    "CustomSql",
    "DataPoint",
    "Dataset",
    "DataType",
    "DeadlineExceeded",
    "DEFAULT_RULES",
    "DictionaryColumn",
    "Distinctness",
    "DoubleMetric",
    "Entity",
    "Entropy",
    "FileSystemMetricsRepository",
    "FileSystemStateProvider",
    "Histogram",
    "HistogramMetric",
    "HoltWinters",
    "InMemoryMetricsRepository",
    "InMemoryStateProvider",
    "install_graceful_shutdown",
    "KLLMetric",
    "KLLParameters",
    "KLLSketch",
    "Maximum",
    "MaxLength",
    "Mean",
    "Metric",
    "MetricInterval",
    "MetricsRepository",
    "Minimum",
    "MinLength",
    "MutualInformation",
    "OnlineNormalStrategy",
    "PatternMatch",
    "RatioOfSums",
    "RelativeRateOfChangeStrategy",
    "ResultKey",
    "RetryPolicy",
    "RowLevelSchema",
    "RowLevelSchemaValidator",
    "RunBudget",
    "RunCancelled",
    "RunMetadata",
    "ScanCheckpointer",
    "ScanDegradation",
    "ScanInterruption",
    "ScanStalled",
    "SeasonalityModel",
    "SeriesSeasonality",
    "SimpleThresholdStrategy",
    "Size",
    "StandardDeviation",
    "Sum",
    "TableMetricsRepository",
    "TransientScanError",
    "Uniqueness",
    "UniqueValueRatio",
    "VerificationResult",
    "VerificationSuite",
]


def __getattr__(name: str):
    # TableMetricsRepository writes parquet: pyarrow is imported only
    # when it is asked for, never by ``import deequ_tpu_torch``
    if name == "TableMetricsRepository":
        from deequ_tpu_torch.repository.table import TableMetricsRepository

        return TableMetricsRepository
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
