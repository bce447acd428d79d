"""Column profiles and the runner that builds them."""

from deequ_tpu_torch.profiles.profiler import (
    ColumnProfiler,
    ColumnProfiles,
    NumericColumnProfile,
    StandardColumnProfile,
)
from deequ_tpu_torch.profiles.runner import ColumnProfilerRunBuilder, ColumnProfilerRunner

__all__ = [
    "ColumnProfiler",
    "ColumnProfilerRunBuilder",
    "ColumnProfilerRunner",
    "ColumnProfiles",
    "NumericColumnProfile",
    "StandardColumnProfile",
]
