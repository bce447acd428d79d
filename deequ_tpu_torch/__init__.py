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

The package mirrors the module paths of ``deequ_tpu``, the JAX package
it is checked against, and imports nothing of it.
"""

from __future__ import annotations

from deequ_tpu_torch import config
from deequ_tpu_torch.analyzers import (
    AnalysisRunner,
    AnalyzerContext,
    ApproxCountDistinct,
    ApproxQuantile,
    ApproxQuantiles,
    ColumnCount,
    Completeness,
    Compliance,
    Correlation,
    CountDistinct,
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
from deequ_tpu_torch.checks import Check, CheckLevel, CheckStatus
from deequ_tpu_torch.data import Dataset, DictionaryColumn
from deequ_tpu_torch.engine import AnalysisEngine
from deequ_tpu_torch.metrics import (
    DoubleMetric,
    Entity,
    HistogramMetric,
    KLLMetric,
    Metric,
)
from deequ_tpu_torch.sketches.kll import KLLParameters
from deequ_tpu_torch.verification import VerificationResult, VerificationSuite

__all__ = [
    "AnalysisEngine",
    "AnalysisRunner",
    "AnalyzerContext",
    "ApproxCountDistinct",
    "ApproxQuantile",
    "ApproxQuantiles",
    "Check",
    "CheckLevel",
    "CheckStatus",
    "ColumnCount",
    "Completeness",
    "Compliance",
    "Correlation",
    "CountDistinct",
    "DataType",
    "Dataset",
    "DictionaryColumn",
    "Distinctness",
    "DoubleMetric",
    "Entity",
    "Entropy",
    "Histogram",
    "HistogramMetric",
    "KLLMetric",
    "KLLParameters",
    "KLLSketch",
    "Maximum",
    "MaxLength",
    "Mean",
    "Metric",
    "Minimum",
    "MinLength",
    "MutualInformation",
    "PatternMatch",
    "RatioOfSums",
    "Size",
    "StandardDeviation",
    "Sum",
    "Uniqueness",
    "UniqueValueRatio",
    "VerificationResult",
    "VerificationSuite",
    "config",
]
