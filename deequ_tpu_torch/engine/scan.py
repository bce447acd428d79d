"""The fused scan: every analyzer's update on each batch, in one pass.

Counterpart of ``deequ_tpu/engine/scan.py``. ``prepare_scan`` decides a
scan's mode as the JAX package does: **resident** when
``config.device_cache_bytes`` is non-zero and the requested columns fit
it (``Dataset.estimated_device_bytes``), else **streaming**.

- Resident: each requested column representation is copied to the
  device once and stays there (``Dataset.device_column``); a batch is a
  set of views into the resident columns.
- Streaming: nothing stays on the device. A prefetch thread
  (``_prefetched``) packs each batch of host rows into one buffer
  (``_StreamWire.pack``: masks bit-packed little-endian, a column
  without nulls sends no mask, the row mask is the row count, and with
  ``config.wire_codecs`` on, columns narrowed by ``engine/wire.py``'s
  codecs), written straight into a
  pinned staging slot from a ring of ``config.ingest_depth + 1``; the
  scan's thread copies it with ``non_blocking=True`` on a copy stream,
  records an event, makes the compute stream wait on it, and unpacks it
  there into the same batch dict a resident scan gives (views of the
  copied buffer, every mask expanded in one shift-and-mask, codec
  columns cast back). A slot is refilled only after its copy's event
  has completed, and the copied buffer is marked used by the compute
  stream (``record_stream``), so neither the host nor the caching
  allocator reuses bytes still in flight. On ``"cpu"`` the same path
  runs with plain host buffers and no second stream.
- Streaming a parquet source (``data/parquet.py``) with
  ``config.ingest_workers`` above 1: the ordered ingest pool
  (``engine/ingest.py``) decodes and packs on worker threads, each
  straight into a pinned slot taken in batch order, and releases the
  batches in order; its ordered commit cuts the one-pass dictionary
  deltas. A batch's deltas ride it to the scan's thread, which applies
  them to the ops' states (``ScanOps.host_delta``) before the batch's
  update; a resident scan primes those ops with the whole dictionaries.

Either way a scan is a Python loop over batches that runs every unit's
``update`` on the same batch and keeps the states on the device; at the
end ONE packed transfer (``engine/pack.py``) brings every final state
to the host.

Host-folded ops (``ScanOps.host_fold``: the KLL sketches) emit a
per-batch output instead of carrying a state. The engine keeps each
batch's output on the device and stacks them; the same packed transfer
that fetches the states fetches them, and the host folds them into the
op's accumulator in batch order. Retained outputs are drained (one more
fetch) only when ``DRAIN_EVERY`` batches are pending, which bounds their
device memory; a scan of up to ``DRAIN_EVERY`` batches fetches once.

Device-result ops (``ScanOps.device_result``: the spill collectors'
key buffers) keep their final state on the device: it stays out of the
packed transfer and is returned as device tensors, for a finalize that
the caller dispatches after the scan.

Resilience (the JAX package's batch-level fault domains,
``engine/resilience.py``, ``engine/memory.py``, ``engine/deadline.py``):
both modes pull their batches through ``resilient_batches`` over a
``make_iter(start)`` factory (``_StreamSource.open`` rebuilds a streamed
source from a batch index, after tearing the old one down: its ring
closed, its threads joined, its last copy waited on), so a transient
source error is retried from the failing batch and a batch that keeps
failing is quarantined into ``last_degradation``. A batch's update is
all-or-nothing (``_ScanRun.update``): every op's update is out of place
except a collector's key-slot writes, which are rolled back
(``ScanOps.revert``) when an op raises, so an update that runs out of
device memory is fed again in slices of the backed-off size from the
states before the batch, bit-identical to a run at that size. Any other
exception of an update fails the scan. With a ``checkpointer`` the
scan saves its whole state every ``interval()`` batches (one fetch) and
resumes from the last checkpoint of the same source and plan. With a
``budget`` or ``cancel`` token (or a graceful-shutdown handler) a
``ScanSupervisor`` and its watchdog run beside the scan: a stalled batch
is retried, and a cancel or a deadline stops the scan cleanly, with a
final checkpoint, partial states and ``last_interruption``.

A ``dp`` mesh (``AnalysisEngine(mesh=DeviceMesh(..., mesh_dim_names=
("dp",)))``, ``engine/mesh.py``): every rank runs this engine over its
own part of the table (``local_view``: a contiguous row share of an
in-memory table, a parquet source's row-group shard), then the ranks
merge the carried and host-folded states ONCE, each op's ``merge``
folded in rank order, so every rank returns the same whole-table
states. Before its first batch each rank agrees its plan with its peers
(the structure, shapes and dtypes of the states to merge), and a rank
that fails anywhere in the scan makes every rank raise. A spill
collector's key buffer is not merged: its finalize shuffles the keys
between ranks (``analyzers/spill.py``). A dense grouping's codes-keyed
counts add across ranks only when the ranks share dictionaries.

Counters on the engine:

- ``data_passes``    — traversals of the data, one per scan however many
                       analyzers ride it;
- ``device_fetches`` — synchronising device -> host transfers: the final
                       one, plus one a drain;
- ``stream_stats``   — the last streamed scan's wire bytes, host pack
                       seconds and copies (None after a resident scan);
- ``checkpoints``    — the last scan's checkpoints: batch, bytes, seconds
                       and the fetches each took;
- ``last_backoff``   — the last scan's ``AdaptiveBatchBackoff`` (its
                       settled ``effective`` size), None with backoff off;
- ``oom_events``     — the last scan's classified allocation failures:
                       stage, batch, rows, the error's class and message;
- ``resumed_at``     — the batch the last scan resumed from a checkpoint
                       at, None when it started at batch 0;
- ``egress_rows_replayed`` — rows a row-level sink wrote again when the
                       last scan resumed (0 by construction), None when
                       no sink resumed.

Row-level egress (``egress/``): a run with a sink arms
``active_egress`` (its ``QuarantineWriter``) for its fused scan. A
checkpoint flushes the writer's open span durably BEFORE it saves the
cursor, which carries the writer's ``EgressCursor``; a scan that loads
a checkpoint reconciles the writer with it first (``align_resume``),
and resumes only when the writer trusts its cursor, else both start
fresh. This holds on the resident and streamed paths and through the
ordered ingest pool.
"""

from __future__ import annotations

import hashlib
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from deequ_tpu_torch import config
from deequ_tpu_torch.analyzers.base import DELTA_PRIME, ScanOps
from deequ_tpu_torch.data.table import (
    DICT_DELTA_PREFIX,
    ROW_MASK,
    ColumnRequest,
    Dataset,
    add_transfer_bytes,
)
from deequ_tpu_torch.engine import wire as wire_mod
from deequ_tpu_torch.engine.deadline import (
    CancelToken,
    RunBudget,
    ScanInterrupted,
    ScanInterruption,
    ScanSupervisor,
    shutdown_installed,
    shutdown_token,
)
from deequ_tpu_torch.engine.ingest import (
    IngestPoolStats,
    active_ingest_threads,
    ordered_ingest,
    register_ingest_thread,
    resolve_ingest_lookahead,
    resolve_ingest_workers,
)
from deequ_tpu_torch.engine.mesh import MeshContext, MeshError, monoid_all_reduce
from deequ_tpu_torch.engine.memory import (
    BackoffExhausted,
    classify_memory_pressure,
    make_backoff,
    oom_probe_of,
    record_memory_pressure,
)
from deequ_tpu_torch.engine.pack import count_data_pass, count_device_fetch, packed_device_get
from deequ_tpu_torch.engine.resilience import (
    BatchIntegrityError,
    RetryPolicy,
    ScanDegradation,
    resilient_batches,
)
from deequ_tpu_torch.telemetry import PhaseClock, get_telemetry

DEFAULT_MAX_BATCH = 1 << 21  # rows per fused-scan step, as the JAX package
# batches of host-folded outputs retained on the device before a drain:
# about 10 KB a KLL column a batch (k = 2048), so 64 batches of 40
# columns hold 26 MB
DRAIN_EVERY = 64
# seconds the scan's thread waits for the prefetch thread to exit
_JOIN_TIMEOUT_S = 30.0


def _to_device(tree: Any, device: torch.device) -> Any:
    return pytree.tree_map(
        lambda x: x.to(device) if isinstance(x, torch.Tensor) else x, tree
    )


@dataclass
class ScanPlan:
    """The static half of a fused scan: ops, the column requests they
    read, the batch geometry, the device, and the mode ("resident" or
    "streaming") with the device-cache budget that decided it and the
    streamed wire's codec switch."""

    ops: Tuple[ScanOps, ...]
    requests: Tuple[ColumnRequest, ...]
    batch_size: int
    device: torch.device
    mode: str = "resident"
    wire_codecs: bool = False
    cache_budget: int = 0


def estimated_run_bytes(dataset: Dataset, engine=None) -> int:
    """``AnalysisEngine.estimated_run_bytes`` without an engine in hand
    (a dataset cache sizing its handles): the coarse footprint the
    admission watermark reads."""
    return (engine or AnalysisEngine()).estimated_run_bytes(dataset)


# -- plan composition --------------------------------------------------------
#
# A plan is a set of monoid ops over one batch geometry, so two plans that
# agree on that geometry compose by the union of their ops: one traversal
# of the merged plan computes every member's states. plan_compatibility is
# the predicate, merge_plans the union and plan_diff the inspection.
# An op is deduplicated by its behaviour token (``ScanOps.behaviour_token``,
# set by the runner's planner from the member analyzers' identity keys,
# the unit's kind and its column requests); an op without one is kept as
# it is. The port keeps no plan cache, so a merged plan has no cache key.


def _op_dedup_token(op: ScanOps) -> Optional[Any]:
    """The token under which ``op`` may be deduplicated, or None when it
    must be kept as it is: nothing vouched for it, or it cannot key a
    set."""
    token = op.behaviour_token
    if token is None:
        return None
    try:
        hash(token)
    except TypeError:
        return None
    return token


def plan_compatibility(a: ScanPlan, b: ScanPlan) -> Optional[str]:
    """Why two prepared plans must NOT merge, or None when one superset
    scan serves both: the batch size, the mode, the device, the budget
    and the wire codecs must agree. The dataset's identity is the
    caller's to check."""
    for name in ("batch_size", "mode", "device", "cache_budget", "wire_codecs"):
        left, right = getattr(a, name), getattr(b, name)
        if left != right:
            return f"{name} {left} != {right}"
    return None


def merge_plans(*plans: ScanPlan) -> ScanPlan:
    """The union of compatible plans as ONE plan whose traversal
    computes every member's states: ops with a behaviour token are
    deduplicated by it (two members asking for ``Completeness("x")`` pay
    one op), ops without one are kept; the requests are recomputed over
    the merged ops. The merged plan keeps the members' mode and budget
    (compatibility pinned them equal): a caller merging many resident
    plans whose union may outgrow the budget prepares the union's
    analyzers anew instead. Raises ``ValueError`` on incompatible plans."""
    if not plans:
        raise ValueError("merge_plans needs at least one plan")
    first = plans[0]
    for other in plans[1:]:
        reason = plan_compatibility(first, other)
        if reason is not None:
            raise ValueError(f"incompatible plans: {reason}")
    ops: List[ScanOps] = []
    seen_ops: set = set()
    requests: List[ColumnRequest] = []
    seen_requests: set = set()
    for plan in plans:
        for op in plan.ops:
            token = _op_dedup_token(op)
            if token is not None:
                if token in seen_ops:
                    continue
                seen_ops.add(token)
            ops.append(op)
        for request in plan.requests:
            if request.key not in seen_requests:
                seen_requests.add(request.key)
                requests.append(request)
    return ScanPlan(ops=tuple(ops), requests=tuple(requests), batch_size=first.batch_size,
                    device=first.device, mode=first.mode, wire_codecs=first.wire_codecs,
                    cache_budget=first.cache_budget)


@dataclass(frozen=True)
class PlanDiff:
    """Two plans' op tokens side by side: the tokens both hold, each
    one's own, the ops of each without a token (never provably shared)
    and the compatibility verdict. ``savings`` is the op slots a merge
    deduplicates."""

    shared: tuple
    only_a: tuple
    only_b: tuple
    opaque_a: int
    opaque_b: int
    incompatible: Optional[str]

    @property
    def mergeable(self) -> bool:
        return self.incompatible is None

    @property
    def savings(self) -> int:
        return len(self.shared)


def plan_diff(a: ScanPlan, b: ScanPlan) -> PlanDiff:
    """Compare two plans' ops by token (in ``a``'s order for ``shared``
    and ``only_a``, ``b``'s for ``only_b``)."""
    tokens_a = [_op_dedup_token(op) for op in a.ops]
    tokens_b = [_op_dedup_token(op) for op in b.ops]
    set_a = {t for t in tokens_a if t is not None}
    set_b = {t for t in tokens_b if t is not None}
    return PlanDiff(
        shared=tuple(t for t in tokens_a if t in set_b),
        only_a=tuple(t for t in tokens_a if t is not None and t not in set_b),
        only_b=tuple(t for t in tokens_b if t is not None and t not in set_a),
        opaque_a=sum(1 for t in tokens_a if t is None),
        opaque_b=sum(1 for t in tokens_b if t is None),
        incompatible=plan_compatibility(a, b),
    )


def coalesce_key_surface() -> tuple:
    """Every option a plan's decisions read, as one hashable tuple: runs
    whose surfaces differ never share a superset scan (a ``configure``
    between two submissions cannot fold two differently planned runs
    into one)."""
    opts = config.options()
    return (
        opts.device,
        opts.batch_size,
        opts.device_cache_bytes,
        opts.wire_codecs,
        opts.accumulation_dtype,
        opts.dense_grouping_budget_bytes,
        opts.device_spill_grouping,
        opts.one_pass_spill,
        opts.dict_deltas,
        opts.dict_delta_capacity,
    )


# -- the prefetch thread -----------------------------------------------------


def active_prefetch_workers() -> List[threading.Thread]:
    """Prefetch and ingest-pool threads still alive (a leak probe for
    the tests)."""
    return active_ingest_threads()


def _prefetched(iterator, depth: int, supervisor: Optional[ScanSupervisor] = None,
                on_teardown=None):
    """Run ``iterator`` on a background thread behind a bounded queue,
    so the host work of batch i+1 overlaps the copy and compute of
    batch i; every torch call on the device stays on the caller's
    thread. The queue carries tagged items (``("item", x)``,
    ``("error", exc)``, ``("done", None)``): an exception of the worker
    re-raises on the caller's thread as the original object, after the
    items produced before it (FIFO position). With a ``supervisor`` the
    caller polls the queue: every empty poll runs its cancel, deadline
    and stall checks (``on_wait``), every item re-arms its stall timer.
    Closing the generator (or an exception on the caller's side) stops
    the worker, releases a source blocked on the supervisor's interrupt
    event, runs ``on_teardown()`` (which closes the scan's ring, so a
    packer waiting for a slot gives up) and joins the worker."""
    q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
    stop = threading.Event()

    def put(msg) -> bool:
        # a bounded put that notices an abandoned consumer
        while not stop.is_set():
            try:
                q.put(msg, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in iterator:
                # stamped when queued: its stall is judged by when the
                # source produced it, not by when the consumer got to it
                stamp = supervisor.clock.now() if supervisor is not None else None
                if not put(("item", (item, stamp))) or stop.is_set():
                    return
        except BaseException as exc:  # noqa: BLE001 — re-raised by the consumer
            put(("error", exc))
        else:
            put(("done", None))

    thread = register_ingest_thread(
        threading.Thread(target=worker, daemon=True, name="deequ-tpu-torch-prefetch"))
    thread.start()
    try:
        while True:
            if supervisor is None:
                tag, payload = q.get()
            else:
                try:
                    tag, payload = q.get(timeout=supervisor.poll_s())
                except queue.Empty:
                    supervisor.on_wait()  # cancel, deadline and stall checks
                    continue
            if tag == "item":
                item, stamp = payload
                if supervisor is not None:
                    supervisor.note_arrival(stamp)
                yield item
            elif tag == "error":
                raise payload
            else:
                return
    finally:
        stop.set()  # consumer done or raised: release the worker
        if supervisor is not None:
            # a worker blocked in a hung read cannot see ``stop``
            supervisor.release_source()
        if on_teardown is not None:
            on_teardown()
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass
        thread.join(timeout=_JOIN_TIMEOUT_S)


def _supervised_iter(inner, supervisor: ScanSupervisor):
    """A batch iterator read on the scan's own thread (the resident
    path), with the supervisor's arrival-time stall check: a batch that
    took longer than ``stall_s`` raises ``ScanStalled`` from ``next()``,
    where the retry takes it."""
    for item in inner:
        supervisor.note_arrival()
        yield item


def _arm_source(dataset, supervisor: Optional[ScanSupervisor]) -> None:
    """A fresh stall window and a fresh interrupt event for a source
    (re)start: a retry inherits neither the stalled timer nor the spent
    event of the last stall."""
    if supervisor is None:
        return
    supervisor.reset_progress()
    attach = getattr(dataset, "attach_interrupt", None)
    if attach is not None:
        attach(supervisor.arm_source())


# -- the streamed wire -------------------------------------------------------


class _RingClosed(Exception):
    """The staging ring closed while the packer waited for a slot."""


class _StagingRing:
    """Pinned host slots that packed batches are written into. A slot is
    handed to a packer only once the scan's thread has released it,
    and the packer waits for the event of the slot's last copy before
    it writes, so no byte still being copied is overwritten.

    Packers on several threads (the ingest pool) take slots in batch
    order: ``acquire(nbytes, seq)`` waits until every batch before
    ``seq`` has its slot. A slot therefore only ever goes to the oldest
    batch without one, whose earlier batches all hold slots and need
    nothing more than to be consumed, so the scan's thread, consuming in
    order, always frees the next slot: no later batch can hold the last
    free slot while an earlier one waits.

    ``first_seq`` is the batch a (re)started source begins at: a source
    restarted at batch k (a retry, a resume, the batch after a
    quarantined one) takes its first slot in turn k."""

    def __init__(self, slots: int, first_seq: int = 0):
        self._free: "queue.Queue" = queue.Queue()
        for _ in range(slots):
            self._free.put({"buffer": None, "event": None})
        self._closed = threading.Event()
        self._turn = threading.Condition()
        self._next = first_seq  # the batch whose packer takes the next slot

    def acquire(self, nbytes: int, seq: Optional[int] = None) -> Tuple[dict, np.ndarray]:
        """(slot, a uint8 numpy view of ``nbytes`` of its pinned memory);
        with ``seq``, only once batches 0..seq-1 have theirs."""
        if seq is not None:
            with self._turn:
                while self._next != seq:
                    if self._closed.is_set():
                        raise _RingClosed()
                    self._turn.wait(timeout=0.1)
        while True:
            if self._closed.is_set():
                raise _RingClosed()
            try:
                slot = self._free.get(timeout=0.1)
                break
            except queue.Empty:
                continue
        if seq is not None:
            with self._turn:
                self._next = seq + 1
                self._turn.notify_all()
        if slot["event"] is not None:
            slot["event"].synchronize()
        return slot, self.view(slot, nbytes)

    @staticmethod
    def view(slot: dict, nbytes: int) -> np.ndarray:
        """A uint8 view of ``nbytes`` of a held slot's pinned memory
        (grown when too small)."""
        buf = slot["buffer"]
        if buf is None or buf.numel() < nbytes:
            buf = slot["buffer"] = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
        return buf[:nbytes].numpy()

    def release(self, slot: dict, event) -> None:
        slot["event"] = event
        self._free.put(slot)

    def close(self) -> None:
        self._closed.set()
        with self._turn:
            self._turn.notify_all()


@dataclass
class _Packed:
    """One packed batch: its host bytes, the layout and codec version it
    was packed under, its row count, the byte offsets of the keys still
    to be written (``_StreamWire.fill``), its host-only dictionary
    deltas, and what packing it took (seconds, bytes shipped and at
    canonical widths)."""

    layout: "_Layout"
    rows: int
    host: np.ndarray  # uint8
    slot: Optional[dict] = None
    version: int = 0
    pending: Dict[str, int] = field(default_factory=dict)
    deltas: Dict[str, Any] = field(default_factory=dict)
    pack_s: float = 0.0
    encoded_bytes: int = 0
    raw_bytes: int = 0


@dataclass
class _Layout:
    """The byte layout of one codec version's batches: sections by
    descending element size (every section starts aligned to its
    element size), each the keys of one dtype in sorted order; packed
    masks are the last section. ``decode_to`` holds the canonical dtype
    of every codec column whose wire dtype differs from it."""

    sections: Tuple[Tuple[np.dtype, Tuple[str, ...]], ...]
    masks: Tuple[str, ...]
    decode_to: Dict[str, torch.dtype]


@dataclass
class StreamStats:
    """A streamed scan's wire: bytes shipped and what they would have
    been at canonical widths (each batch counts 4 more for its row
    count, as the JAX package counts its width scalar), seconds spent
    packing (summed over the packing threads), seconds the single
    prefetch thread waited on its source (reading and converting the
    batches), the copies' device seconds and bytes, batches re-packed
    after a codec widening, the dictionary deltas applied and their
    values, and the ingest pool's own accounting (None without a pool)."""

    batches: int = 0
    encoded_bytes: int = 0
    raw_bytes: int = 0
    pack_s: float = 0.0
    source_s: float = 0.0
    copy_s: float = 0.0
    copy_bytes: int = 0
    repacks: int = 0
    deltas: int = 0
    delta_values: int = 0
    pool: Optional[IngestPoolStats] = None
    _copy_events: List[Tuple[Any, Any]] = field(default_factory=list, repr=False)

    def settle(self) -> None:
        """Sum the copies' device time, once the last copy is done."""
        if self._copy_events:
            self._copy_events[-1][1].synchronize()
        self.copy_s = sum(a.elapsed_time(b) for a, b in self._copy_events) / 1e3
        self._copy_events = []


_TORCH_DTYPES = {
    np.dtype(np.int8): torch.int8, np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32, np.dtype(np.int64): torch.int64,
    np.dtype(np.float32): torch.float32, np.dtype(np.float64): torch.float64,
    np.dtype(np.uint8): torch.uint8,
}


class _StreamWire:
    """Packs host batches into one buffer each (on the prefetch thread)
    and unpacks them on the device (on the scan's thread)."""

    def __init__(self, dataset: Dataset, requests, codecs: wire_mod.CodecTable,
                 stats: StreamStats):
        keys = dataset._dedup_requests(requests)
        # a column without nulls sends no mask: its batches use the row mask
        self.alias = tuple(sorted(
            k for k, r in keys.items() if r.repr == "mask" and dataset._is_all_valid(r.column)
        ))
        self.keys = tuple(sorted(k for k in keys if k not in self.alias))
        self.codecs = codecs
        self.stats = stats
        self._layouts: Dict[int, _Layout] = {}
        self._lock = threading.Lock()

    def _layout(self, version: int, dtypes: Dict[str, np.dtype]) -> _Layout:
        with self._lock:
            layout = self._layouts.get(version)
            if layout is None:
                layout = self._layouts[version] = self._new_layout(dtypes)
        return layout

    def _new_layout(self, dtypes: Dict[str, np.dtype]) -> _Layout:
        by_dtype: Dict[np.dtype, List[str]] = {}
        masks = []
        for k in self.keys:
            if k.endswith("::mask"):
                masks.append(k)
            else:
                by_dtype.setdefault(dtypes[k], []).append(k)
        decode_to = {
            k: _TORCH_DTYPES[c.canonical] for k, c in self.codecs.codecs.items()
            if c.active and k in self.keys
        }
        return _Layout(
            tuple(sorted(((d, tuple(ks)) for d, ks in by_dtype.items()),
                         key=lambda e: -e[0].itemsize)),
            tuple(masks), decode_to,
        )

    def _encode(self, batch: Dict[str, np.ndarray], skip=()):
        """(version, encoded columns but ``skip``) under the current codec
        table; a violation widens the table and encodes the batch again."""
        while True:
            version = self.codecs.version
            try:
                out = {}
                for k in self.keys:
                    if k in skip:
                        continue
                    v = batch[k]
                    if k.endswith("::mask"):
                        out[k] = np.packbits(v, bitorder="little")
                    else:
                        out[k] = self.codecs.encode(k, v)
                return version, out
            except wire_mod.CodecViolation as violation:
                self.codecs.widen(violation.key, violation.required)
                with self._lock:
                    self.stats.repacks += 1

    def defers(self, keys) -> bool:
        """Whether a batch can be packed before ``keys`` are known: they
        ship at their canonical int32 width (no codec re-decides it)."""
        return not any(k in self.codecs.codecs for k in keys)

    def pack(self, rows: int, batch: Dict[str, np.ndarray], ring: Optional[_StagingRing],
             seq: Optional[int] = None, pending=(), slot: Optional[dict] = None) -> _Packed:
        """Pack a batch into one buffer: a pinned slot of ``ring`` (taken
        in turn ``seq``, or ``slot`` itself when re-packing into it), or
        plain host memory without a ring. Room is left for the int32
        keys ``pending``, which ``fill`` writes later."""
        t0 = time.perf_counter()
        for k in self.keys:
            v = batch.get(k)
            if v is not None and len(v) != rows:
                # a short array would shift every later section
                raise BatchIntegrityError(
                    f"streamed batch column {k!r} has {len(v)} rows, want {rows}: "
                    "truncated or corrupt batch"
                )
        version, encoded = self._encode(batch, pending)
        dtypes = {k: v.dtype for k, v in encoded.items()}
        dtypes.update((k, np.dtype(np.int32)) for k in pending)
        layout = self._layout(version, dtypes)
        order = [k for _, ks in layout.sections for k in ks] + list(layout.masks)
        sizes = {k: encoded[k].nbytes if k in encoded else rows * 4 for k in order}
        nbytes = sum(sizes.values())
        raw = 4 + sum(rows * 4 for _ in pending) + sum(
            p.nbytes if k.endswith("::mask") else self.codecs.raw_bytes_of(k, p)
            for k, p in encoded.items()
        )
        t1 = time.perf_counter()
        if slot is not None:
            host = _StagingRing.view(slot, nbytes)
        elif ring is not None:
            slot, host = ring.acquire(nbytes, seq)
        else:
            host = np.empty(nbytes, dtype=np.uint8)
        t2 = time.perf_counter()
        offset = 0
        offsets = {}
        for k in order:
            if k in encoded:
                flat = encoded[k].reshape(-1).view(np.uint8)
                host[offset:offset + flat.size] = flat
            else:
                offsets[k] = offset
            offset += sizes[k]
        deltas = {k: v for k, v in batch.items() if k.startswith(DICT_DELTA_PREFIX)}
        return _Packed(layout, rows, host, slot, version, offsets, deltas,
                       (t1 - t0) + (time.perf_counter() - t2), 4 + nbytes, raw)

    def fill(self, packed: _Packed, batch: Dict[str, np.ndarray]) -> None:
        """Write the keys a batch was packed without into their places,
        and take its dictionary deltas."""
        t0 = time.perf_counter()
        for k, offset in packed.pending.items():
            flat = np.ascontiguousarray(batch[k], dtype=np.int32).view(np.uint8)
            packed.host[offset:offset + flat.size] = flat
        packed.pending = {}
        packed.deltas = {k: v for k, v in batch.items() if k.startswith(DICT_DELTA_PREFIX)}
        packed.pack_s += time.perf_counter() - t0

    def account(self, packed: _Packed) -> None:
        """Count a released batch's packing in the run's stats (on the
        scan's thread)."""
        stats = self.stats
        stats.batches += 1
        stats.encoded_bytes += packed.encoded_bytes
        stats.raw_bytes += packed.raw_bytes
        stats.pack_s += packed.pack_s
        stats.deltas += len(packed.deltas)
        stats.delta_values += sum(len(d["values"]) for d in packed.deltas.values())
        # the JAX package's counters, from sizes the host already holds
        tm = get_telemetry()
        tm.counter("engine.wire_bytes_encoded").inc(packed.encoded_bytes)
        tm.counter("engine.wire_bytes_raw").inc(packed.raw_bytes)
        add_transfer_bytes(packed.host.size)
        for key, delta in packed.deltas.items():
            count = int(len(delta["values"]))
            tm.counter("engine.dict_deltas").inc()
            tm.counter("engine.dict_delta_values").inc(count)
            tm.event("dictionary_delta", column=key[len(DICT_DELTA_PREFIX):],
                     start=int(delta["start"]), count=count)

    def copy_in(self, packed: _Packed, device: torch.device, copy_stream,
                ring: Optional[_StagingRing]) -> torch.Tensor:
        """A packed batch's bytes on ``device``: on CUDA copied from its
        pinned slot on the copy stream, with the compute stream made to
        wait for the copy; on the CPU the host buffer itself."""
        if copy_stream is None:
            return torch.from_numpy(packed.host)
        compute = torch.cuda.current_stream(device)
        start = torch.cuda.Event(enable_timing=True)
        done = torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(copy_stream):
            dev = torch.empty(packed.host.size, dtype=torch.uint8, device=device)
            start.record(copy_stream)
            dev.copy_(packed.slot["buffer"][:packed.host.size], non_blocking=True)
            done.record(copy_stream)
        ring.release(packed.slot, done)
        compute.wait_event(done)
        # made on the copy stream, read on the compute stream
        dev.record_stream(compute)
        self.stats._copy_events.append((start, done))
        self.stats.copy_bytes += packed.host.size
        return dev

    def unpack(self, packed: _Packed, dev: torch.Tensor,
               device: torch.device) -> Dict[str, torch.Tensor]:
        """The batch dict of a packed batch whose bytes are ``dev``:
        views of it, every mask expanded in one shift-and-mask, codec
        columns cast back to their canonical dtypes."""
        rows = packed.rows
        layout = packed.layout
        row = torch.ones(rows, dtype=torch.bool, device=device)
        batch: Dict[str, torch.Tensor] = {ROW_MASK: row}
        for k in self.alias:
            batch[k] = row
        offset = 0
        for dtype, ks in layout.sections:
            count = rows * len(ks)
            section = dev[offset:offset + count * dtype.itemsize].view(_TORCH_DTYPES[dtype])
            offset += count * dtype.itemsize
            for i, k in enumerate(ks):
                piece = section[i * rows:(i + 1) * rows]
                target = layout.decode_to.get(k)
                batch[k] = piece if target is None else piece.to(target)
        if layout.masks:
            width = -(-rows // 8)
            packed_bits = dev[offset:offset + width * len(layout.masks)].view(len(layout.masks), width)
            shifts = torch.arange(8, dtype=torch.uint8, device=device)
            bits = ((packed_bits.unsqueeze(-1) >> shifts) & 1).reshape(len(layout.masks), -1)
            bits = bits[:, :rows].bool()
            for i, k in enumerate(layout.masks):
                batch[k] = bits[i]
        return batch


class _StreamSource:
    """One streamed scan's source, which ``open(start)`` (re)builds from
    a batch index: a ring of pinned slots whose turns begin at ``start``,
    and the packed batches from a prefetch thread, or, for a dataset
    that supports it with ``config.ingest_workers`` above 1, from the
    ordered ingest pool (``_pool_packed``). ``close()`` tears the source
    down before a rebuild and at the end: the ring closed (a packer
    waiting for a slot gives up), every thread joined, and the last copy
    issued from a slot waited on. ``to_device`` copies a packed batch in
    and unpacks it; ``to_host`` unpacks it in place on the host, for a
    batch whose copy ran out of device memory."""

    def __init__(self, dataset: Dataset, requests: Sequence[ColumnRequest], batch_size: int,
                 device: torch.device, wire_codecs: bool, stats: StreamStats,
                 supervisor: Optional[ScanSupervisor] = None):
        self.dataset = dataset
        self.requests = requests
        self.batch_size = batch_size
        self.device = device
        self.stats = stats
        self.supervisor = supervisor
        self.wire = _StreamWire(dataset, requests,
                                wire_mod.resolve_codecs(dataset, requests, enabled=wire_codecs),
                                stats)
        opts = config.options()
        self.depth = max(1, int(opts.ingest_depth))
        self.cuda = device.type == "cuda"
        self.copy_stream = torch.cuda.Stream(device) if self.cuda else None
        self.workers = resolve_ingest_workers(opts.ingest_workers)
        self.lookahead = resolve_ingest_lookahead(opts.ingest_lookahead, self.workers)
        # declared on the CLASS (a wrapper that only delegates through
        # __getattr__ must not reach its inner planner past its faults),
        # its truth read on the instance
        self.use_pool = (self.workers > 1 and "supports_parallel_ingest" in dir(type(dataset))
                         and bool(getattr(dataset, "supports_parallel_ingest", False)))
        if self.use_pool:
            stats.pool = IngestPoolStats()
        self.ring: Optional[_StagingRing] = None
        self._packed: Optional[Iterator[_Packed]] = None
        # one event a batch on the compute stream, recorded once the scan
        # has dispatched the batch's updates: the scan's thread runs at
        # most depth + 1 batches ahead of the device, which bounds the
        # copied buffers alive at once
        self._computed: List[Any] = []
        self._last_copy = None

    def open(self, start: int = 0) -> Iterator[_Packed]:
        self.close()
        self.ring = _StagingRing(self.depth + 1, first_seq=start) if self.cuda else None
        _arm_source(self.dataset, self.supervisor)
        if self.use_pool:
            self._packed = _pool_packed(self.dataset, self.requests, self.batch_size, self.wire,
                                        self.ring, self.workers, self.lookahead, self.stats.pool,
                                        start=start, supervisor=self.supervisor)
            return self._packed
        n, bs, wire, ring = self.dataset.num_rows, self.batch_size, self.wire, self.ring
        # a dataset need not take start_batch unless it is restarted
        rows = (self.dataset.host_batches(self.requests, bs, start_batch=start) if start
                else self.dataset.host_batches(self.requests, bs))
        source = _timed(rows, self.stats)
        self._packed = _prefetched(
            (wire.pack(min(bs, n - first), batch, ring)
             for first, batch in zip(range(start * bs, n, bs), source)),
            self.depth, self.supervisor, ring.close if ring is not None else None,
        )
        return self._packed

    def close(self) -> None:
        if self.ring is not None:
            self.ring.close()
        if self._packed is not None:
            self._packed.close()  # joins the prefetch thread or the pool
            self._packed = None
        if self._last_copy is not None:
            # no slot of the old ring is still being copied from
            self._last_copy.synchronize()
            self._last_copy = None

    def to_device(self, packed: _Packed) -> Dict[str, Any]:
        """A packed batch's dict on the device, its deltas riding along."""
        if len(self._computed) > self.depth:
            self._computed.pop(0).synchronize()
        dev = self.wire.copy_in(packed, self.device, self.copy_stream, self.ring)
        if self.cuda:
            self._last_copy = self.stats._copy_events[-1][1]
        batch = self.wire.unpack(packed, dev, self.device)
        batch.update(packed.deltas)
        return batch

    def to_host(self, packed: _Packed) -> Dict[str, Any]:
        """A packed batch's dict as views of its host bytes (nothing is
        copied); ``release`` hands its slot back once they are used."""
        cpu = torch.device("cpu")
        batch = self.wire.unpack(packed, torch.from_numpy(packed.host), cpu)
        batch.update(packed.deltas)
        return batch

    def release(self, packed: _Packed) -> None:
        if self.ring is not None and packed.slot is not None:
            self.ring.release(packed.slot, None)

    def dispatched(self) -> None:
        """The scan has dispatched the updates of the last batch."""
        if self.cuda:
            self._computed.append(torch.cuda.current_stream(self.device).record_event())


def stream_batches(
    dataset: Dataset,
    requests: Sequence[ColumnRequest],
    batch_size: int,
    device: torch.device,
    wire_codecs: bool = False,
    stats: Optional[StreamStats] = None,
) -> Iterator[Dict[str, torch.Tensor]]:
    """The streamed batches of a read outside the fused scan, on
    ``device``: the same dicts a resident scan's batches are, with any
    dictionary deltas riding along as host payloads
    (``DICT_DELTA_PREFIX`` keys), through a ``_StreamSource`` opened at
    batch 0. Closing the generator closes the ring and joins every
    thread."""
    source = _StreamSource(dataset, requests, batch_size, device, wire_codecs,
                           stats if stats is not None else StreamStats())
    try:
        for packed in source.open(0):
            source.wire.account(packed)
            yield source.to_device(packed)
            source.dispatched()
    finally:
        source.close()


def _timed(source: Iterator, stats: StreamStats) -> Iterator:
    """``source``'s items, with the seconds spent waiting on it added to
    ``stats.source_s`` (on the prefetch thread)."""
    while True:
        t0 = time.perf_counter()
        try:
            item = next(source)
        except StopIteration:
            return
        stats.source_s += time.perf_counter() - t0
        yield item


def _pool_packed(dataset, requests, batch_size: int, wire: _StreamWire,
                 ring: Optional[_StagingRing], workers: int, lookahead: int,
                 pool: IngestPoolStats, start: int = 0,
                 supervisor: Optional[ScanSupervisor] = None) -> Iterator[_Packed]:
    """The packed batches of a streamed scan through the ordered ingest
    pool. A worker decodes a batch and packs it straight into a pinned
    slot, taken in batch order (``_StagingRing``), leaving room for the
    codes of the dictionary-delta columns; the ordered ``commit``, on
    the consuming thread, cuts the batch's deltas and writes those codes
    into the slot (a few MB a batch). Where those codes have a wire
    codec, or the codec table widened since the pack, the batch is
    packed (again) in ``commit``. ``start`` is the batch the source
    begins at, ``supervisor`` the scan's (``ordered_ingest``)."""
    items = (dataset.ingest_work_items(requests, batch_size, start_batch=start) if start
             else dataset.ingest_work_items(requests, batch_size))

    def work(item):
        t0 = time.perf_counter()
        decoded = item.decode()
        pool.add("decode_s", time.perf_counter() - t0)
        if not wire.defers(item.deferred):
            return None, decoded
        packed = wire.pack(item.width, decoded, ring, seq=item.index, pending=item.deferred)
        # the pack itself, without the wait for a slot's turn
        pool.add("encode_s", packed.pack_s)
        return packed, decoded

    def commit(result, item):
        packed, decoded = result
        batch = item.commit(decoded)
        if packed is None:
            packed = wire.pack(item.width, batch, ring, seq=item.index)
        elif packed.version != wire.codecs.version:
            packed = wire.pack(item.width, batch, ring, slot=packed.slot)
        else:
            wire.fill(packed, batch)
        return packed

    def sizer(result) -> int:
        return sum(getattr(v, "nbytes", 0) for v in result[1].values())

    # a worker waiting for its slot's turn gives up once the consumer stops
    return ordered_ingest(items, work, commit, workers=workers, lookahead=lookahead,
                          supervisor=supervisor, stats=pool, sizer=sizer,
                          on_teardown=ring.close if ring is not None else None)


def _fits(dataset: Dataset, requests: Sequence[ColumnRequest]) -> bool:
    """Whether a scan of ``requests`` stays resident: the budget is
    non-zero and the columns fit it."""
    budget = config.options().device_cache_bytes
    return bool(budget) and dataset.estimated_device_bytes(requests) <= budget


class _ScanRun:
    """One scan's carried states, its host-folded outputs still on the
    device (``pending``) and their host accumulators."""

    def __init__(self, ops: Sequence[ScanOps], states: List[Any], consts: List[Any]):
        self.ops = ops
        self.states = states
        self.consts = consts
        self.host_slots = [i for i, op in enumerate(ops) if op.host_fold is not None]
        self.accs = {i: ops[i].host_init() for i in self.host_slots}
        self.pending: List[List[Any]] = []  # per batch: the host slots' outputs
        self.fold_s = 0.0

    def update(self, batch: Dict[str, Any]) -> None:
        """Every op's update of one batch (or slice of one), all or
        nothing: the states are rebound only once every op has returned,
        and each update is out of place but a collector's key-slot
        writes, which ``ScanOps.revert`` undoes when an op raises. A
        retry of the batch therefore starts from the states as they were
        before it."""
        new: List[Any] = []
        # the units memoize shared blocks of the batch in the dict they
        # get (engine/vectorize.py): a copy keeps the caller's batch clean
        # for slicing after a failed update
        shared = dict(batch)
        try:
            for op, state, c in zip(self.ops, self.states, self.consts):
                new.append(op.apply_update(state, shared, c))
        except BaseException:
            rows = batch[ROW_MASK].shape[0]
            for op, state in zip(self.ops[:len(new) + 1], self.states):
                if op.revert is not None:
                    op.revert(state, rows)
            raise
        self.states = new
        if self.host_slots:
            self.pending.append([new[i] for i in self.host_slots])

    def apply_deltas(self, deltas: Dict[str, Any]) -> None:
        """A batch's dictionary deltas, in batch order, before its update:
        no code indexes past the written entries."""
        if deltas:
            self.states = [s if op.host_delta is None else op.host_delta(s, deltas)
                           for op, s in zip(self.ops, self.states)]


def _host_numpy(tree: Any) -> Any:
    """A fetched state tree with every tensor as a numpy array (what a
    checkpoint pickles)."""
    return pytree.tree_map(lambda x: x.numpy() if isinstance(x, torch.Tensor) else x, tree)


def _from_numpy(tree: Any, device: torch.device) -> Any:
    """A checkpoint's state tree back as tensors on ``device``."""
    return pytree.tree_map(
        lambda x: torch.from_numpy(x).to(device) if isinstance(x, np.ndarray) else x, tree
    )


def _plan_token(plan: ScanPlan, states: Sequence[Any]) -> str:
    """A checkpoint's key: a digest of the states' structure, shapes and
    dtypes, the columns the scan reads, the batch size and the mode, so
    a checkpoint restores only into the plan that wrote it."""
    leaves, spec = pytree.tree_flatten(list(states))
    parts: List[Any] = [str(spec), plan.mode, plan.batch_size,
                        sorted(r.key for r in plan.requests)]
    parts += [(tuple(x.shape), str(x.dtype)) if isinstance(x, torch.Tensor) else type(x).__name__
              for x in leaves]
    return hashlib.sha1(repr(parts).encode()).hexdigest()[:20]


class AnalysisEngine:
    """Executes fused analyzer scans on one device.

    ``device`` — ``"cuda"`` (the default, from ``config.options().device``
    when not given) or ``"cpu"``; a CUDA default without a GPU raises
    here, never later. ``batch_size`` — rows per fused step
    (``config.options().batch_size``, else ``min(rows, 2**21)``).
    ``checkpointer`` — an ``io.state_provider.ScanCheckpointer``: the
    scan saves itself every ``interval()`` batches and resumes from its
    last checkpoint. ``budget`` (a ``RunBudget``) and ``cancel`` (a
    ``CancelToken``) bound every scan; the runner sets them for a run.
    ``mesh`` — a ``torch.distributed.device_mesh.DeviceMesh`` with a
    ``dp_axis`` dimension, over a default process group the caller has
    initialised: the engine then runs one rank of a mesh scan (module
    docstring). A mesh engine takes no checkpointer, deadline or cancel
    token yet: the resilience of a mesh scan is a later slice.
    """

    def __init__(self, device=None, batch_size: Optional[int] = None, checkpointer=None,
                 budget: Optional[RunBudget] = None, cancel: Optional[CancelToken] = None,
                 mesh=None, dp_axis: str = "dp"):
        if mesh is not None and (checkpointer is not None or budget is not None
                                 or cancel is not None):
            raise ValueError(
                "a mesh engine takes no checkpointer, deadline or cancel token: "
                "checkpoints, deadlines and cancellation of a mesh scan are not "
                "supported yet")
        self.device = config.resolve_device(device)
        self.batch_size = batch_size
        self.checkpointer = checkpointer
        self.budget = budget
        self.cancel = cancel
        self.mesh = mesh
        self.dp_axis = dp_axis
        self._mesh: Optional[MeshContext] = None if mesh is None else MeshContext(mesh, dp_axis)
        self.data_passes = 0
        self.device_fetches = 0
        # wall seconds of the last scan, by phase (host clock): the JAX
        # package's PhaseClock buckets and "mode", then the port's own
        # split: "scan_s" ends in the synchronising fetch, "fold_s" is the
        # host folds of the per-batch outputs, drains' folds included;
        # "resident_s" the copy of a resident scan's columns, 0 when it
        # streams, and a streamed scan adds "pack_s" and "copy_s"
        self.phase_times: Optional[Dict[str, Any]] = None
        # the last scan's scan_phases event (the runner's record of a run
        # with telemetry off)
        self.phase_event: Optional[Dict[str, Any]] = None
        self.stream_stats: Optional[StreamStats] = None
        # the merged record of every scan since reset_degradation() (a
        # run spans several scans: its deferred re-reads), the first
        # interruption, and the record of the scan running now
        self.last_degradation: Optional[ScanDegradation] = None
        self.last_interruption: Optional[ScanInterruption] = None
        self.active_degradation: Optional[ScanDegradation] = None
        self.last_backoff = None
        self.oom_events: List[Dict[str, Any]] = []
        self.resumed_at: Optional[int] = None
        self.checkpoints: List[Dict[str, Any]] = []
        # the row-level sink's writer of the scan running now (armed by
        # egress/plan.py's RowSinkPlan.bind_scan_geometry, cleared when
        # its scan completes)
        self.active_egress: Optional[Any] = None
        self.egress_rows_replayed: Optional[int] = None

    @property
    def mesh_context(self) -> Optional[MeshContext]:
        """The mesh's ``dp`` rank, world and group (None on one device)."""
        return self._mesh

    @property
    def placement(self) -> str:
        """``device``, or ``mesh<W>`` for a rank of a W-rank mesh."""
        return "device" if self._mesh is None else self._mesh.placement

    def local_view(self, dataset: Dataset) -> Dataset:
        """The part of ``dataset`` this rank scans: the dataset itself on
        one device or when it already is a rank's part; a parquet
        source's row-group shard with ``config.process_sharded_ingest``
        (``engine/ingest.py::process_sharded_feed``, one exchange of the
        shards' row counts); else the rank's contiguous row share, which
        keeps the whole table's dictionaries (``Dataset.row_share``)."""
        ctx = self._mesh
        if ctx is None or dataset.mesh_share is not None:
            return dataset
        if hasattr(dataset, "shard_view") and config.options().process_sharded_ingest:
            from deequ_tpu_torch.engine.ingest import process_sharded_feed

            return process_sharded_feed(dataset, ctx)
        return dataset.row_share(ctx.rank, ctx.world)

    def _resolve_batch_size(self, num_rows: int) -> int:
        size = self.batch_size
        if size is None:
            size = config.options().batch_size
        if size is None:
            size = min(max(num_rows, 1), DEFAULT_MAX_BATCH)
        return max(int(size), 1)

    def scan_row_capacity(self, dataset: Dataset) -> int:
        """Rows a scan feeds through the ops for this dataset: a spill
        collector sizes its key buffer by it, so no batch's append can
        overrun it. The port pads no batch, so it is the row count (at
        least 1, the JAX package's capacity of an empty dataset)."""
        return max(dataset.num_rows, 1)

    def estimated_run_bytes(self, dataset: Dataset) -> int:
        """A coarse device footprint of a run for the admission
        watermark (``config.memory_watermark_bytes``), as the JAX package
        reckons it: the scan's rows times one float64 and one mask byte
        a column, plus the row mask."""
        try:
            ncols = max(1, int(dataset.num_columns))
        except Exception:  # noqa: BLE001 — a source without columns: one
            ncols = 1
        return self.scan_row_capacity(dataset) * (9 * ncols + 1)

    # -- resilience -------------------------------------------------------

    def reset_degradation(self) -> None:
        """A fresh degradation and interruption record (the runner calls
        this once a run; every scan of the run merges into it)."""
        self.last_degradation = None
        self.last_interruption = None
        self.active_degradation = None

    def _make_supervisor(self) -> Optional[ScanSupervisor]:
        """A supervisor for the next scan, or None when nothing bounds it
        (no budget, no token, no shutdown handler): an unbounded scan
        runs no watchdog and blocks on its queues."""
        if self._mesh is not None:
            return None  # a mesh scan runs unsupervised (the constructor)
        tokens = [self.cancel]
        if shutdown_installed():
            tokens.append(shutdown_token())
        if self.budget is None and not any(t is not None for t in tokens):
            return None
        return ScanSupervisor(self.budget, tokens)

    def _record_interruption(self, exc: ScanInterrupted, batch_index: int, row_offset: int,
                             checkpointed: bool) -> None:
        kind = getattr(exc, "kind", "interrupted")
        interruption = ScanInterruption(kind=kind, reason=str(exc) or kind,
                                        batch_index=batch_index, row_offset=row_offset,
                                        checkpointed=checkpointed)
        self.last_interruption = ScanInterruption.merge_optional(self.last_interruption,
                                                                 interruption)
        tm = get_telemetry()
        tm.counter("engine.deadline_exceeded" if kind == "deadline"
                   else "engine.runs_cancelled").inc()
        tm.event("run_cancelled", **interruption.to_dict())

    def _retry_policy(self) -> RetryPolicy:
        policy = config.options().scan_retry
        return policy if policy is not None else RetryPolicy()

    def _checkpoint_setup(self, dataset: Dataset, plan: ScanPlan, states):
        """(checkpointer, plan token, source fingerprint, interval) when
        checkpoints are on and the source has an identity, else
        (None, None, None, 0): without one a resume could fold another
        dataset."""
        ckpt = self.checkpointer
        if ckpt is None:
            return None, None, None, 0
        every = ckpt.interval()
        if every <= 0:
            return None, None, None, 0
        try:
            fingerprint = dataset.fingerprint()
        except Exception:  # noqa: BLE001 — no identity: no checkpoint
            return None, None, None, 0
        return ckpt, _plan_token(plan, states), fingerprint, int(every)

    def _write_checkpoint(self, ckpt, token: str, fingerprint: str, run: _ScanRun,
                          degradation: ScanDegradation, batch_index: int, num_rows: int,
                          batch_size: int) -> None:
        """Save the states of batches [0, batch_index) in ONE fetch: the
        pending host-fold outputs come with the states and are folded
        first, so the accumulators saved hold exactly those batches, in
        order, and a resumed run folds the rest in the same order."""
        from deequ_tpu_torch.io.state_provider import ScanCursor

        t0 = time.perf_counter()
        count_device_fetch(self)
        host_states, fetched = packed_device_get((list(run.states), _stack_outputs(run.pending)))
        run.pending = []
        run.fold_s += self._fold(run.ops, run.host_slots, run.accs, fetched)
        # flush, then cursor: the folds above routed their spans through
        # the sink's writer; its open span is made durable FIRST, and only
        # then is the cursor naming that state saved, so a resume writes
        # no row twice and drops none
        egress = self.active_egress.flush_durable() if self.active_egress is not None else None
        nbytes = ckpt.save(
            ScanCursor(batch_index, min(num_rows, batch_index * batch_size), fingerprint,
                       batch_size, egress=egress),
            token, _host_numpy(host_states), dict(run.accs), degradation,
        )
        self.checkpoints.append({"batch_index": batch_index, "bytes": nbytes,
                                 "seconds": time.perf_counter() - t0, "fetches": 1})
        tm = get_telemetry()
        tm.counter("engine.checkpoints_written").inc()
        tm.event("scan_checkpoint", batch_index=batch_index,
                 row_offset=min(num_rows, batch_index * batch_size))

    def _load_checkpoint(self, ckpt, token, fingerprint, batch_size: int, mode: str):
        """The checkpoint of this exact (source, plan, batch size), or
        None. Counts and events the resume."""
        if ckpt is None:
            return None
        payload = ckpt.load(fingerprint, token)
        if payload is None:
            return None
        cursor = payload["cursor"]
        if cursor.batch_size != batch_size or cursor.batch_index <= 0:
            return None
        tm = get_telemetry()
        tm.counter("engine.resumes").inc()
        tm.event("scan_resumed", mode=mode, batch_index=cursor.batch_index,
                 row_offset=cursor.row_offset)
        return payload

    # -- the scan ---------------------------------------------------------

    def run_scan(
        self, dataset: Dataset, analyzers_and_ops: Sequence[Tuple[Any, ScanOps]]
    ) -> List[Any]:
        """Run every unit's update in one fused pass; returns the final
        states on the host, index-aligned with the input."""
        dataset = self.local_view(dataset)
        plan = self.prepare_scan(dataset, analyzers_and_ops)
        if plan is None:
            return []
        return self.execute_plan(plan, dataset)

    def prepare_scan(
        self, dataset: Dataset, analyzers_and_ops: Sequence[Tuple[Any, ScanOps]]
    ) -> Optional[ScanPlan]:
        if not analyzers_and_ops:
            return None
        requests: List[ColumnRequest] = []
        for analyzer, _ in analyzers_and_ops:
            requests.extend(analyzer.device_requests(dataset))
        return ScanPlan(
            ops=tuple(o for _, o in analyzers_and_ops),
            requests=tuple(requests),
            batch_size=self._resolve_batch_size(dataset.num_rows),
            device=self.device,
            mode="resident" if _fits(dataset, requests) else "streaming",
            wire_codecs=config.options().wire_codecs,
            cache_budget=config.options().device_cache_bytes,
        )

    def batches(
        self, dataset: Dataset, requests: Sequence[ColumnRequest]
    ) -> Iterator[Dict[str, torch.Tensor]]:
        """The batches of ``requests`` for a read outside the fused scan
        (a deferred spill plan, the host group-by's where filter),
        resident or streamed by the rule ``prepare_scan`` applies."""
        batch_size = self._resolve_batch_size(dataset.num_rows)
        if _fits(dataset, requests):
            return dataset.device_batches(requests, batch_size, self.device)
        return stream_batches(
            dataset, requests, batch_size, self.device, config.options().wire_codecs
        )

    def execute_plan(self, plan: ScanPlan, dataset: Dataset) -> List[Any]:
        tm = get_telemetry()
        tm.counter("engine.scans").inc()
        # one traversal of the source, however many analyzers ride it
        count_data_pass(self)
        tm.metrics.gauge("engine.batch_rows_effective").set(plan.batch_size)
        self.phase_times = None
        try:
            return self._execute(plan, dataset)
        finally:
            self._finish_scan_telemetry()

    def _finish_scan_telemetry(self) -> None:
        """The scan's ``scan_phases`` event (``phase_times``, with the
        mesh placement), kept as ``phase_event`` for the runner's record
        of a run with telemetry off."""
        if self.phase_times is None:
            self.phase_event = None
            return
        fields = dict(self.phase_times)
        if self._mesh is not None:
            fields["placement"] = self.placement
        self.phase_event = {"event": "scan_phases", **fields}
        tm = get_telemetry()
        tm.event("scan_phases", **fields)
        if tm.current_trace() is None:
            return
        # a traced run gets the split as phase spans, from the same
        # buckets (the first batch's update, then the rest of the scan)
        times, mode = self.phase_times, self.phase_times.get("mode", "")
        compile_s = float(times.get("first_step_s", 0.0))
        scan_s = sum(float(times.get(k, 0.0)) for k in ("dispatch_s", "sync_s", "host_wait_s",
                                                         "put_s"))
        if compile_s > 0:
            tm.emit_span("phase:compile", compile_s, mode=mode, retraces=0)
        if scan_s > 0:
            tm.emit_span("phase:scan", scan_s, mode=mode)

    def _execute(self, plan: ScanPlan, dataset: Dataset) -> List[Any]:
        if self._mesh is not None:
            return self._execute_on_mesh(plan, dataset)
        supervisor = self._make_supervisor()
        if supervisor is not None:
            try:
                supervisor.check()
            except ScanInterrupted as exc:
                # the envelope closed before the scan (a deadline spent by
                # an earlier scan of the run, a token cancelled before the
                # start): the source is never touched, the states stay
                # at their identities
                self._record_interruption(exc, 0, 0, False)
                return self._run_scan(plan, dataset, None, read=False)
            supervisor.start_watchdog()
        try:
            return self._run_scan(plan, dataset, supervisor)
        finally:
            if supervisor is not None:
                supervisor.stop_watchdog()
                supervisor.flush_stall_events()

    # -- the mesh ---------------------------------------------------------

    def _mesh_merged(self, op: ScanOps, dataset: Dataset) -> bool:
        """Whether a mesh scan merges this op's state across ranks: not a
        collector's device buffer, and a codes-keyed count only when the
        ranks share dictionaries."""
        return not op.device_result and (not op.code_keyed or dataset.shared_dictionaries)

    def _mesh_token(self, plan: ScanPlan, states: Sequence[Any], merged: Sequence[int]) -> str:
        """What every rank must agree on before its scan: the placement,
        the structure, shapes and dtypes of the states to merge, and the
        number of key lanes of each spill collector."""
        ctx = self._mesh
        leaves, spec = pytree.tree_flatten([states[i] for i in merged])
        parts: List[Any] = [ctx.placement, len(merged), str(spec)]
        parts += [(tuple(x.shape), str(x.dtype)) if isinstance(x, torch.Tensor)
                  else type(x).__name__ for x in leaves]
        parts += [len(states[i][0]) for i, op in enumerate(plan.ops) if op.device_result]
        return hashlib.sha1(repr(parts).encode()).hexdigest()[:20]

    def _execute_on_mesh(self, plan: ScanPlan, dataset: Dataset) -> List[Any]:
        """One rank's scan of its part, then the one merge. The plan is
        agreed right after the states are made; a rank that raises
        anywhere before the merge meets its peers' next exchange with its
        error, so every rank raises ``RankFailed`` (a rank that raised
        alone would strand the others in the merge)."""
        ctx = self._mesh
        merged = [i for i, op in enumerate(plan.ops) if self._mesh_merged(op, dataset)]

        def agree(states) -> None:
            ctx.agree("scan-plan", self._mesh_token(plan, states, merged))

        earlier, self.last_degradation = self.last_degradation, None
        try:
            states = self._run_scan(plan, dataset, None, on_states=agree)
        except MeshError:
            raise
        except BaseException as exc:
            ctx.sync("scan", error=exc)
            raise
        # every rank's quarantined batches and retries, in rank order,
        # so that every rank reports (and judges) the same run
        records = ctx.sync("scan", self.last_degradation)
        merged_record = None
        for record in records:
            merged_record = ScanDegradation.merge_optional(merged_record, record)
        self.last_degradation = ScanDegradation.merge_optional(earlier, merged_record)
        t0 = time.perf_counter()
        before = ctx.bytes.get("merge", 0)
        out = monoid_all_reduce([states[i] for i in merged],
                                [plan.ops[i].merge for i in merged], ctx)
        for i, state in zip(merged, out):
            states[i] = state
        self.phase_times["merge_s"] = time.perf_counter() - t0
        self.phase_times["merge_bytes"] = float(ctx.bytes.get("merge", 0) - before)
        return states

    def _run_scan(self, plan: ScanPlan, dataset: Dataset,
                  supervisor: Optional[ScanSupervisor], read: bool = True,
                  on_states=None) -> List[Any]:
        t0 = time.perf_counter()
        ops, device, bs = plan.ops, plan.device, plan.batch_size
        resident = plan.mode == "resident"
        clock = PhaseClock(plan.mode)
        states = [_to_device(op.init(), device) for op in ops]
        if resident:
            # no deltas flow on a resident scan: delta-carrying ops load
            # their whole dictionaries
            states = [s if op.host_delta is None else op.host_delta(s, DELTA_PRIME)
                      for op, s in zip(ops, states)]
        run = _ScanRun(ops, states, [_to_device(op.consts, device) for op in ops])
        if on_states is not None:
            on_states(run.states)
        self.checkpoints, self.oom_events, self.resumed_at = [], [], None
        self.egress_rows_replayed = None
        self.stream_stats = None if resident else StreamStats()
        source = None
        n = dataset.num_rows

        def rows_for(i: int) -> int:
            return max(0, min(n - i * bs, bs))

        degradation = ScanDegradation()
        ckpt, token, fingerprint, every = self._checkpoint_setup(dataset, plan, run.states)
        start = 0
        payload = (self._load_checkpoint(ckpt, token, fingerprint, bs, plan.mode) if read
                   else None)
        if self.active_egress is not None and read:
            # the sink is reconciled with the checkpoint BEFORE the states
            # are restored: its durable cursor is trusted (a resume that
            # writes nothing again), or the artifact and the scan both
            # start fresh
            payload = self.active_egress.align_resume(payload)
            if payload is not None:
                self.egress_rows_replayed = self.active_egress.rows_replayed
        if payload is not None:
            start = self.resumed_at = payload["cursor"].batch_index
            run.states = [_from_numpy(s, device) for s in payload["states"]]
            for i in run.host_slots:
                run.accs[i] = payload["host_accs"][i]
            degradation = payload["degradation"] or degradation
        self.active_degradation = degradation
        backoff = make_backoff(bs)
        self.last_backoff = backoff
        probe = oom_probe_of(dataset)

        if resident:
            def build(i: int):
                # a dataset need not take start_batch unless it is restarted
                return (dataset.device_batches(plan.requests, bs, device, start_batch=i) if i
                        else dataset.device_batches(plan.requests, bs, device))

            # the first source is built before the clock starts, so the
            # resident upload is timed apart from the scan
            first = [build(start)] if read else []

            def make_iter(i: int):
                it = first.pop() if first else build(i)
                _arm_source(dataset, supervisor)
                return it if supervisor is None else _supervised_iter(it, supervisor)

            def validate(i: int, batch) -> None:
                want = rows_for(i)
                for k, v in batch.items():
                    if v.shape[0] != want:
                        raise BatchIntegrityError(
                            f"batch {i} column {k!r} has {v.shape[0]} rows, want {want}: "
                            "truncated or corrupt batch")

            close = None
        elif read:  # a scan stopped before it starts touches no source
            source = _StreamSource(dataset, plan.requests, bs, device, plan.wire_codecs,
                                   self.stream_stats, supervisor)
            make_iter, validate = source.open, None

            def close(_it) -> None:
                source.close()

        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t1 = time.perf_counter()
        interrupted = None
        if read:
            done = start  # batches [start, done) are folded or quarantined
            batch_iter = resilient_batches(make_iter, self._retry_policy(), degradation, rows_for,
                                           start=start, validate=validate, close=close)
            try:
                for index, item in clock.timed_iter(batch_iter):
                    done = index
                    if supervisor is not None:
                        supervisor.check()
                    if len(run.pending) >= DRAIN_EVERY:
                        count_device_fetch(self)
                        with clock.phase("sync_s"):
                            drained = packed_device_get(_stack_outputs(run.pending))
                        run.fold_s += self._fold(ops, run.host_slots, run.accs, drained)
                        run.pending = []
                    if resident:
                        with clock.phase("dispatch_s"):
                            clean = self._dispatch(run, index, item, rows_for(index), backoff,
                                                   probe, degradation)
                    else:
                        clean = self._stream_dispatch(run, source, index, item, backoff, probe,
                                                      degradation, clock)
                    if clean and backoff is not None:
                        backoff.note_clean()
                    done = index + 1
                    if ckpt is not None and done % every == 0:
                        self._write_checkpoint(ckpt, token, fingerprint, run, degradation, done,
                                               n, bs)
            except ScanInterrupted as exc:
                # cancel or deadline: stop CLEANLY. The source is torn down
                # now, a final cursor makes the run resumable, and the
                # normal epilogue returns the states of batches [0, done)
                batch_iter.close()
                interrupted = exc
                checkpointed = ckpt is not None and done > 0
                if checkpointed:
                    self._write_checkpoint(ckpt, token, fingerprint, run, degradation, done, n, bs)
                self._record_interruption(exc, done, min(n, done * bs), checkpointed)
            finally:
                batch_iter.close()
        if ckpt is not None and read and interrupted is None:
            ckpt.clear(token)  # finished: no stale cursor to resume into
        self.last_degradation = ScanDegradation.merge_optional(self.last_degradation, degradation)
        self.active_degradation = None
        if degradation.is_degraded:
            get_telemetry().event(
                "scan_degraded", batches_quarantined=degradation.batches_quarantined,
                rows_skipped=degradation.rows_skipped,
                error_classes=",".join(degradation.error_classes))
        count_device_fetch(self)
        # device results are shielded from the fetch: they stay where
        # they are (the JAX package's _shield_device_results)
        fetch_slots = [
            i for i, op in enumerate(ops) if i not in run.accs and not op.device_result
        ]
        collector_bytes = sum(
            leaf.numel() * leaf.element_size()
            for i, op in enumerate(ops) if op.device_result
            for leaf in pytree.tree_leaves(run.states[i]) if isinstance(leaf, torch.Tensor))
        if collector_bytes:
            get_telemetry().counter("engine.collector_bytes").inc(collector_bytes)
        with clock.phase("sync_s"):
            host_carried, fetched = packed_device_get(
                ([run.states[i] for i in fetch_slots], _stack_outputs(run.pending))
            )
        t2 = time.perf_counter()
        run.fold_s += self._fold(ops, run.host_slots, run.accs, fetched)
        host_states = list(run.states)
        for i, state in zip(fetch_slots, host_carried):
            host_states[i] = state
        for i, acc in run.accs.items():
            host_states[i] = acc
        # the JAX package's buckets (PhaseClock), then the port's own
        # split of the wall: upload, scan up to the fetch, host fold
        self.phase_times = {**clock.times, "resident_s": t1 - t0, "scan_s": t2 - t1,
                            "fold_s": run.fold_s}
        stats = self.stream_stats
        if stats is not None:
            stats.settle()
            self.phase_times.update(pack_s=stats.pack_s, copy_s=stats.copy_s)
        return host_states

    def _stream_dispatch(self, run: _ScanRun, source: _StreamSource, index: int,
                         packed: _Packed, backoff, probe, degradation: ScanDegradation,
                         clock: PhaseClock) -> bool:
        """One streamed batch: its copy to the device (a guarded stage of
        its own), its deltas, then its update. Once the backoff is active,
        and for a copy that runs out of memory, the batch is fed instead
        in slices of the effective size copied from its host bytes, as
        the JAX package feeds its raw rows. True when it ran without
        memory pressure."""
        source.wire.account(packed)
        if backoff is not None and backoff.active:
            return self._host_slices(run, source, index, packed, backoff, probe, degradation)
        try:
            if probe is not None:
                probe("transfer", index, packed.rows)
            with clock.phase("put_s"):
                batch = source.to_device(packed)
        except Exception as exc:  # noqa: BLE001 — classified below
            pressure = classify_memory_pressure(exc) if backoff is not None else None
            if pressure is None:
                raise
            message = self._note_oom("transfer", index, packed.rows, exc, pressure)
            del pressure
            batch = None
        if batch is None:
            # out of the handler: what the failed copy held is free again
            if backoff.shrink("transfer", index):
                self._host_slices(run, source, index, packed, backoff, probe, degradation)
            else:
                run.apply_deltas(_pop_deltas(source.to_host(packed)))
                source.release(packed)
                degradation.record_quarantine(index, packed.rows, BackoffExhausted(message), 1)
            return False
        run.apply_deltas(_pop_deltas(batch))
        with clock.phase("dispatch_s"):
            clean = self._dispatch(run, index, batch, packed.rows, backoff, probe, degradation,
                                   streamed=True)
        source.dispatched()
        return clean

    def _host_slices(self, run: _ScanRun, source: _StreamSource, index: int, packed: _Packed,
                     backoff, probe, degradation: ScanDegradation) -> bool:
        """A streamed batch fed in slices copied one at a time from its
        host bytes; its slot goes back to the ring afterwards."""
        try:
            host = source.to_host(packed)
            run.apply_deltas(_pop_deltas(host))
            return self._subdispatch(run, index, host, packed.rows, backoff, probe, degradation,
                                     to_device=source.device)
        finally:
            source.release(packed)

    def _dispatch(self, run: _ScanRun, index: int, batch: Dict[str, Any], rows: int, backoff,
                  probe, degradation: ScanDegradation, streamed: bool = False) -> bool:
        """One batch's update, guarded: an update that runs out of memory
        (``classify_memory_pressure``) halves the effective size and
        feeds the batch again in slices; any other exception fails the
        scan. True when the batch ran without memory pressure. The retry
        runs OUT of the handler: inside it, the exception's traceback
        would keep the failed update's tensors allocated."""
        if backoff is not None and backoff.active:
            return self._subdispatch(run, index, batch, rows, backoff, probe, degradation,
                                     streamed=streamed)
        try:
            if probe is not None:
                probe("dispatch", index, rows)
            run.update(batch)
            return True
        except Exception as exc:  # noqa: BLE001 — classified below
            pressure = classify_memory_pressure(exc) if backoff is not None else None
            if pressure is None:
                raise
            message = self._note_oom("dispatch", index, rows, exc, pressure)
            del pressure
        if not backoff.shrink("dispatch", index):
            degradation.record_quarantine(index, rows, BackoffExhausted(message), 1)
            return False
        return self._subdispatch(run, index, batch, rows, backoff, probe, degradation,
                                 streamed=streamed)

    def _subdispatch(self, run: _ScanRun, index: int, batch: Dict[str, Any], rows: int, backoff,
                     probe, degradation: ScanDegradation, streamed: bool = False,
                     to_device: Optional[torch.device] = None) -> bool:
        """Feed one batch in slices of the effective size, from the states
        before it, chaining the states: the updates and the fold order of
        a run configured at that size, so its states are bit-identical.
        Host slices (``to_device``) are copied one at a time. An OOM at
        the floor quarantines the batch's remaining rows. True when no
        slice ran out of memory."""
        clean = True
        r = 0
        while r < rows:
            w = min(backoff.effective, rows - r)
            try:
                if probe is not None and (streamed or to_device is not None):
                    probe("transfer", index, w)
                sub = {k: v[r:r + w] for k, v in batch.items()}
                if to_device is not None:
                    sub = {k: v.to(to_device) for k, v in sub.items()}
                if probe is not None:
                    probe("dispatch", index, w)
                run.update(sub)
                r += w
                continue
            except Exception as exc:  # noqa: BLE001 — classified below
                pressure = classify_memory_pressure(exc)
                if pressure is None:
                    raise
                message = self._note_oom("dispatch", index, w, exc, pressure)
                del pressure
            sub = None
            clean = False
            if not backoff.shrink("dispatch", index):
                degradation.record_quarantine(index, rows - r, BackoffExhausted(message), 1)
                return False
        return clean

    def _note_oom(self, stage: str, index: int, rows: int, exc: BaseException,
                  pressure: BaseException) -> str:
        """Record one classified allocation failure; returns its message
        (the record keeps strings only, never the exception, whose
        traceback holds the failed update's tensors)."""
        self.oom_events.append({"stage": stage, "batch_index": index, "rows": rows,
                                "error_class": type(exc).__name__, "message": str(exc)[:500]})
        record_memory_pressure(stage, index, rows, pressure)
        return str(pressure)

    @staticmethod
    def _fold(ops, host_slots, accs, fetched) -> float:
        """Fold fetched stacked outputs into the host accumulators, batch
        by batch in order; returns the seconds it took."""
        t0 = time.perf_counter()
        for i, stacked in zip(host_slots, fetched or []):
            leaves, spec = pytree.tree_flatten(stacked)
            leaves = [leaf.numpy() for leaf in leaves]
            acc = accs[i]
            for b in range(leaves[0].shape[0]):
                acc = ops[i].host_fold(
                    acc, pytree.tree_unflatten([leaf[b] for leaf in leaves], spec)
                )
            accs[i] = acc
        return time.perf_counter() - t0


def _pop_deltas(batch: Dict[str, Any]) -> Dict[str, Any]:
    """Take a streamed batch's host-only dictionary deltas out of it,
    by column."""
    keys = [k for k in batch if k.startswith(DICT_DELTA_PREFIX)]
    return {k[len(DICT_DELTA_PREFIX):]: batch.pop(k) for k in keys}


def _stack_outputs(pending: List[List[Any]]) -> Optional[List[Any]]:
    """The retained per-batch outputs, one tree a host slot whose leaves
    stack the batches on a new leading axis (None when nothing is
    pending)."""
    if not pending:
        return None
    out = []
    for slot in zip(*pending):
        leaves = [pytree.tree_flatten(tree) for tree in slot]
        spec = leaves[0][1]
        out.append(pytree.tree_unflatten(
            [torch.stack(parts) for parts in zip(*(lv for lv, _ in leaves))], spec
        ))
    return out
