"""Row-level egress: the bad rows of a scan, extracted while it runs, to
a clean/quarantine parquet split. Counterpart of ``deequ_tpu/egress``.

- :class:`RowLevelSink`: the request (``VerificationRunBuilder
  .with_row_level_sink`` or ``row_level_sink=`` of
  ``do_verification_run``);
- :class:`EgressReport`: what a run's egress wrote (``sink.report``,
  ``result.row_level_egress``);
- :data:`BATCH_QUARANTINED`: the ``__failed_constraints__`` marker of
  rows whose whole batch the resilience layer quarantined;
- ``plan_row_sink`` / ``finalize_row_sink``: the run's hooks
  (``verification/suite.py``).

Importing this package imports pyarrow; ``import deequ_tpu_torch`` does
not import it.
"""

from deequ_tpu_torch.egress.plan import RowSinkPlan, finalize_row_sink, plan_row_sink
from deequ_tpu_torch.egress.writer import (
    BATCH_QUARANTINED,
    EgressReport,
    QuarantineWriter,
    RowLevelSink,
)

__all__ = [
    "BATCH_QUARANTINED",
    "EgressReport",
    "QuarantineWriter",
    "RowLevelSink",
    "RowSinkPlan",
    "finalize_row_sink",
    "plan_row_sink",
]
