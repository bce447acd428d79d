"""Analyzers, their states, and the runner that fuses them into one pass."""

from deequ_tpu_torch.analyzers.basic import (
    Completeness,
    Compliance,
    Correlation,
    Maximum,
    MaxLength,
    Mean,
    Minimum,
    MinLength,
    RatioOfSums,
    Size,
    StandardDeviation,
    Sum,
)
from deequ_tpu_torch.analyzers.hll import ApproxCountDistinct
from deequ_tpu_torch.analyzers.runner import AnalysisRunner, AnalyzerContext

__all__ = [
    "AnalysisRunner",
    "AnalyzerContext",
    "ApproxCountDistinct",
    "Completeness",
    "Compliance",
    "Correlation",
    "Maximum",
    "MaxLength",
    "Mean",
    "Minimum",
    "MinLength",
    "RatioOfSums",
    "Size",
    "StandardDeviation",
    "Sum",
]
