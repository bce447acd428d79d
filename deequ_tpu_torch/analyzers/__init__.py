"""Analyzers, their states, and the runner that fuses them into one pass."""

from deequ_tpu_torch.analyzers.basic import (
    ColumnCount,
    Completeness,
    Compliance,
    Correlation,
    Maximum,
    MaxLength,
    Mean,
    Minimum,
    MinLength,
    PatternMatch,
    RatioOfSums,
    Size,
    StandardDeviation,
    Sum,
)
from deequ_tpu_torch.analyzers.applicability import Applicability, ApplicabilityResult
from deequ_tpu_torch.analyzers.custom import CustomSql
from deequ_tpu_torch.analyzers.datatype import DataType
from deequ_tpu_torch.analyzers.grouping import (
    CountDistinct,
    Distinctness,
    Entropy,
    Histogram,
    MutualInformation,
    Uniqueness,
    UniqueValueRatio,
)
from deequ_tpu_torch.analyzers.hll import ApproxCountDistinct
from deequ_tpu_torch.analyzers.kll import ApproxQuantile, ApproxQuantiles, KLLSketch
from deequ_tpu_torch.analyzers.runner import AnalysisRunner, AnalyzerContext

__all__ = [
    "AnalysisRunner",
    "AnalyzerContext",
    "Applicability",
    "ApplicabilityResult",
    "ApproxCountDistinct",
    "ApproxQuantile",
    "ApproxQuantiles",
    "ColumnCount",
    "Completeness",
    "Compliance",
    "Correlation",
    "CountDistinct",
    "CustomSql",
    "DataType",
    "Distinctness",
    "Entropy",
    "Histogram",
    "KLLSketch",
    "Maximum",
    "MaxLength",
    "Mean",
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
]
