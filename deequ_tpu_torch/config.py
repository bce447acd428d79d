"""Engine configuration for the PyTorch port.

Only the options that change where or how a run computes are carried
over from the JAX package's ``config.py``:

- ``accumulation_dtype`` — dtype of scalar *float* state accumulators
  ("float64" default). Per-element work runs in the column's native
  dtype and only the per-batch scalar results are cast into it; counts
  are always exact int64, and integral columns always widen per
  element to float64.
- ``batch_size`` — rows per fused-scan step. ``None`` means the engine
  default, ``min(rows, 2**21)``.
- ``device`` — where the engine runs. ``None`` means ``"cuda"``: a run
  with no GPU raises instead of continuing on the CPU. Pass ``"cpu"``
  (here or to ``AnalysisEngine``) to run on the host.
- ``device_cache_bytes`` — the device budget of a scan's resident
  columns (8 GiB, the JAX package's default). A scan whose requested
  columns fit it (``Dataset.estimated_device_bytes``) copies them to the
  device once and keeps them there; a larger one, or any scan with a
  budget of 0, streams its batches through pinned staging buffers and
  leaves nothing on the device (``engine/scan.py``). The spill headroom
  gate reads it too (a plan spills on the device only when rows x 64
  bytes fit it).
- ``dense_grouping_budget_bytes``, ``device_spill_grouping`` and
  ``one_pass_spill`` — the grouping planner's other gates
  (``analyzers/grouping.py``, ``analyzers/spill.py``), with the JAX
  package's defaults, so both packages pick the same path for a
  frequency plan. The gates read the same on ``"cpu"`` as on
  ``"cuda"``, so the CPU tests run the path the card runs.
- ``wire_codecs`` — True makes a streamed scan ship integer columns at
  the narrowest width their values need and float64 columns as float32
  where every value round-trips bit for bit (``engine/wire.py``). Off by
  default, unlike the JAX package: on an H100 the host pack, not the
  pinned copy, bounds a streamed scan, and the codecs' guards and casts
  cost it more host time than the copies they save. Results are the
  same either way.
- ``ingest_depth`` — batches a streamed scan packs ahead of the device:
  the prefetch queue's depth and the ring of pinned staging buffers.
- ``dict_deltas`` and ``dict_delta_capacity`` — a parquet source's string
  columns build their dictionaries inside the streamed pass and ship only
  the new values of each batch (``data/parquet.py``); the HLL and
  DataType groups then carry their lookup tables in their states, at
  ``dict_delta_capacity`` entries a column, and a dictionary that grows
  past it raises. False builds each dictionary in a pre-pass instead.
- ``ingest_workers`` and ``ingest_lookahead`` — the ordered ingest pool
  of a streamed parquet scan (``engine/ingest.py``): 0 workers means
  ``min(4, cpus)``, 1 the single prefetch thread; 0 lookahead means
  twice the workers.

The four options above are read from ``DEEQU_TPU_DICT_DELTAS``,
``DEEQU_TPU_DICT_DELTA_CAPACITY``, ``DEEQU_TPU_INGEST_WORKERS`` and
``DEEQU_TPU_INGEST_LOOKAHEAD`` when those are set, as the JAX package
reads them.
- Resilience (``engine/resilience.py``, ``engine/memory.py``,
  ``engine/deadline.py``), with the JAX package's defaults:
  ``scan_retry``, ``degradation_policy``, ``checkpoint_every_batches``,
  ``run_deadline_seconds``, ``batch_stall_seconds``,
  ``max_concurrent_runs``, ``memory_backoff``, ``min_batch_rows``,
  ``memory_heal_after_batches`` and ``memory_watermark_bytes``, read from
  the JAX package's environment variables (``DEEQU_TPU_DEGRADATION_POLICY``,
  ``DEEQU_TPU_CHECKPOINT_EVERY``, ``DEEQU_TPU_RUN_DEADLINE``,
  ``DEEQU_TPU_BATCH_STALL``, ``DEEQU_TPU_MAX_CONCURRENT_RUNS``,
  ``DEEQU_TPU_MEMORY_BACKOFF``, ``DEEQU_TPU_MIN_BATCH_ROWS``,
  ``DEEQU_TPU_MEMORY_HEAL_AFTER``, ``DEEQU_TPU_MEMORY_WATERMARK_BYTES``).

- ``process_sharded_ingest`` and ``collective_timeout_s`` — a mesh
  engine (``engine/mesh.py``): whether each rank of a parquet source
  reads only its own row-group shard (``DEEQU_TPU_PROCESS_SHARDED_INGEST``,
  on by default, as in the JAX package), and the seconds a collective
  waits for its peers before it raises (``DEEQU_TPU_COLLECTIVE_TIMEOUT``,
  600).

Set options with :func:`set_option` or the :func:`configure` context
manager.
"""

from __future__ import annotations

import contextlib
import functools
import os
import threading
from dataclasses import dataclass, field, replace
from typing import Iterator, Optional

import torch


@dataclass
class Options:
    # dtype for scalar state accumulators ("float64" | "float32")
    accumulation_dtype: str = "float64"
    # rows per fused-scan batch (None = engine default)
    batch_size: Optional[int] = None
    # engine device ("cuda", "cuda:N" or "cpu"); None = "cuda"
    device: Optional[str] = None
    # device budget for the dense grouping count vectors (bytes): the
    # combined joint key space the frequency plans of one scan may hold
    dense_grouping_budget_bytes: int = 1 << 30
    # device sort + segment count for high-cardinality grouping
    # (analyzers/spill.py); False sends such plans to the host group-by
    device_spill_grouping: bool = True
    # spill key extraction rides the shared fused scan (one pass); False
    # re-reads the columns once a spill plan (the deferred form)
    one_pass_spill: bool = True
    # device budget of a scan's resident columns (bytes); a scan that
    # does not fit it, or any scan at 0, streams. The spill headroom gate
    # reads it too: a plan spills on the device only when rows x 64
    # bytes fit it
    device_cache_bytes: int = 8 << 30
    # per-column wire codecs on the streamed scan (engine/wire.py); off:
    # they cost the host pack more than they save the copy
    wire_codecs: bool = False
    # batches packed ahead of the device on the streamed scan (the
    # prefetch queue and the pinned staging ring)
    ingest_depth: int = 2
    # one-pass dictionary deltas for a parquet source's string codes
    dict_deltas: bool = field(
        default_factory=lambda: os.environ.get("DEEQU_TPU_DICT_DELTAS", "1") != "0")
    # entries of a delta-carrying lookup table a column; a dictionary
    # that grows past it raises
    dict_delta_capacity: int = field(
        default_factory=lambda: int(os.environ.get("DEEQU_TPU_DICT_DELTA_CAPACITY", 1 << 16)))
    # decode and pack threads of a streamed parquet scan (0: min(4, cpus);
    # 1: the single prefetch thread)
    ingest_workers: int = field(
        default_factory=lambda: int(os.environ.get("DEEQU_TPU_INGEST_WORKERS", 0) or 0))
    # batches in flight inside the ingest pool (0: twice the workers)
    ingest_lookahead: int = field(
        default_factory=lambda: int(os.environ.get("DEEQU_TPU_INGEST_LOOKAHEAD", 0) or 0))
    # per-batch retry of a scan's read, decode and copy
    # (engine/resilience.RetryPolicy; None: 3 attempts, exponential
    # backoff, deterministic jitter; max_attempts=1 disables retries)
    scan_retry: Optional[object] = None
    # what quarantined batches or an interrupted run do to a
    # VerificationSuite's status: "fail" (Error), "warn" (at least
    # Warning) or "tolerate" (the checks alone decide)
    degradation_policy: str = field(
        default_factory=lambda: os.environ.get("DEEQU_TPU_DEGRADATION_POLICY", "fail"))
    # batches between scan checkpoints of an engine with a
    # ScanCheckpointer (io/state_provider.py); <= 0 disables
    checkpoint_every_batches: int = field(
        default_factory=lambda: int(os.environ.get("DEEQU_TPU_CHECKPOINT_EVERY", 64)))
    # wall seconds of a whole run; past them the scan stops with partial
    # metrics and a final checkpoint (engine/deadline.py); <= 0 disables
    run_deadline_seconds: float = field(
        default_factory=lambda: float(os.environ.get("DEEQU_TPU_RUN_DEADLINE", 0) or 0))
    # seconds a batch may take before it counts as stalled (retried,
    # then quarantined); <= 0 disables
    batch_stall_seconds: float = field(
        default_factory=lambda: float(os.environ.get("DEEQU_TPU_BATCH_STALL", 0) or 0))
    # concurrent runs admitted in the process, the rest queue in order;
    # 0 = no bound
    max_concurrent_runs: int = field(
        default_factory=lambda: int(os.environ.get("DEEQU_TPU_MAX_CONCURRENT_RUNS", 0) or 0))
    # an update that runs out of device memory is fed again in halved
    # slices (engine/memory.py); False: the OOM fails the scan
    memory_backoff: bool = field(
        default_factory=lambda: os.environ.get("DEEQU_TPU_MEMORY_BACKOFF", "1") != "0")
    # the smallest backed-off slice; an OOM there quarantines the rest
    # of the batch
    min_batch_rows: int = field(
        default_factory=lambda: int(os.environ.get("DEEQU_TPU_MIN_BATCH_ROWS", 4096)))
    # clean batches at a reduced size before it doubles back; <= 0 keeps
    # the reduced size to the end of the scan
    memory_heal_after_batches: int = field(
        default_factory=lambda: int(os.environ.get("DEEQU_TPU_MEMORY_HEAL_AFTER", 8)))
    # runs queue once the sum of their estimated device bytes
    # (AnalysisEngine.estimated_run_bytes) would pass this; 0 disables
    memory_watermark_bytes: int = field(
        default_factory=lambda: int(os.environ.get("DEEQU_TPU_MEMORY_WATERMARK_BYTES", 0) or 0))

    # a mesh engine's parquet source: each rank reads only its own
    # row-group shard (``ParquetDataset.shard_view``); False splits the
    # rows as an in-memory table's are split
    process_sharded_ingest: bool = field(
        default_factory=lambda: os.environ.get("DEEQU_TPU_PROCESS_SHARDED_INGEST", "1") != "0")
    # seconds a mesh engine's collective waits for its peers before it
    # raises (engine/mesh.py)
    collective_timeout_s: float = field(
        default_factory=lambda: float(os.environ.get("DEEQU_TPU_COLLECTIVE_TIMEOUT", 600) or 600))

    def accumulation_float(self) -> torch.dtype:
        if self.accumulation_dtype == "float64":
            return torch.float64
        if self.accumulation_dtype == "float32":
            return torch.float32
        raise ValueError(
            "accumulation_dtype must be 'float64' or 'float32', got "
            f"{self.accumulation_dtype!r}"
        )


_lock = threading.Lock()
_options = Options()


def options() -> Options:
    return _options


def set_option(**kwargs) -> None:
    global _options
    with _lock:
        _options = replace(_options, **kwargs)


@contextlib.contextmanager
def configure(**kwargs) -> Iterator[Options]:
    """Temporarily override options within a block."""
    global _options
    with _lock:
        prev = _options
        _options = replace(_options, **kwargs)
    try:
        yield _options
    finally:
        with _lock:
            _options = prev


def resolve_device(device=None) -> torch.device:
    """The device a run uses: the explicit argument, else
    ``options().device``, else ``"cuda"``. A CUDA device without a
    usable GPU raises — a run never falls back to the CPU unless the
    caller asked for it."""
    if device is None:
        device = _options.device
    resolved = torch.device("cuda" if device is None else device)
    if resolved.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "deequ_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the host"
        )
    if resolved.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {resolved}")
    return resolved


def sm_count(device: torch.device) -> int:
    """The streaming multiprocessors of a CUDA device, read from the
    CUDA runtime once per device: the kernels' launch paths size their grids
    by it on every call."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    return _sm_count(index)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def on_device(device: torch.device):
    """``device`` as the current CUDA device, for a kernel launch: no
    switch (a ``torch.cuda.device`` context costs microseconds a launch)
    when it already is."""
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)
