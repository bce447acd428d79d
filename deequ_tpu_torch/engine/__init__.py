from deequ_tpu_torch.engine.deadline import (
    CancelToken,
    DeadlineExceeded,
    RunBudget,
    RunCancelled,
    ScanInterrupted,
    ScanInterruption,
    install_graceful_shutdown,
)
from deequ_tpu_torch.engine.mesh import monoid_all_reduce
from deequ_tpu_torch.engine.scan import AnalysisEngine
from deequ_tpu_torch.engine.subproc import (
    BreakerOpen,
    CircuitBreaker,
    CrashLoopError,
    IsolatedRunner,
    ProcessCrashed,
    checkpoint_progress_probe,
    run_isolated,
)

__all__ = [
    "AnalysisEngine",
    "BreakerOpen",
    "CancelToken",
    "CircuitBreaker",
    "CrashLoopError",
    "DeadlineExceeded",
    "IsolatedRunner",
    "ProcessCrashed",
    "RunBudget",
    "RunCancelled",
    "ScanInterrupted",
    "ScanInterruption",
    "checkpoint_progress_probe",
    "install_graceful_shutdown",
    "monoid_all_reduce",
    "run_isolated",
]
