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

Counters on the engine:

- ``data_passes``    — traversals of the data, one per scan however many
                       analyzers ride it;
- ``device_fetches`` — synchronising device -> host transfers: the final
                       one, plus one a drain;
- ``stream_stats``   — the last streamed scan's wire bytes, host pack
                       seconds and copies (None after a resident scan).
"""

from __future__ import annotations

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
from deequ_tpu_torch.data.table import DICT_DELTA_PREFIX, ROW_MASK, ColumnRequest, Dataset
from deequ_tpu_torch.engine import wire as wire_mod
from deequ_tpu_torch.engine.ingest import (
    IngestPoolStats,
    active_ingest_threads,
    ordered_ingest,
    register_ingest_thread,
    resolve_ingest_lookahead,
    resolve_ingest_workers,
)
from deequ_tpu_torch.engine.pack import packed_device_get

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
    "streaming") with the streamed wire's codec switch."""

    ops: Tuple[ScanOps, ...]
    requests: Tuple[ColumnRequest, ...]
    batch_size: int
    device: torch.device
    mode: str = "resident"
    wire_codecs: bool = False


# -- the prefetch thread -----------------------------------------------------


def active_prefetch_workers() -> List[threading.Thread]:
    """Prefetch and ingest-pool threads still alive (a leak probe for
    the tests)."""
    return active_ingest_threads()


def _prefetched(iterator, depth: int):
    """Run ``iterator`` on a background thread behind a bounded queue,
    so the host work of batch i+1 overlaps the copy and compute of
    batch i; every torch call on the device stays on the caller's
    thread. The queue carries tagged items (``("item", x)``,
    ``("error", exc)``, ``("done", None)``): an exception of the worker
    re-raises on the caller's thread as the original object, after the
    items produced before it (FIFO position). Closing the generator
    stops the worker and joins it."""
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
                if not put(("item", item)) or stop.is_set():
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
            tag, payload = q.get()
            if tag == "item":
                yield payload
            elif tag == "error":
                raise payload
            else:
                return
    finally:
        stop.set()  # consumer done or raised: release the worker
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass
        thread.join(timeout=_JOIN_TIMEOUT_S)


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
    free slot while an earlier one waits."""

    def __init__(self, slots: int):
        self._free: "queue.Queue" = queue.Queue()
        for _ in range(slots):
            self._free.put({"buffer": None, "event": None})
        self._closed = threading.Event()
        self._turn = threading.Condition()
        self._next = 0  # the batch whose packer takes the next slot

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


def stream_batches(
    dataset: Dataset,
    requests: Sequence[ColumnRequest],
    batch_size: int,
    device: torch.device,
    wire_codecs: bool = False,
    stats: Optional[StreamStats] = None,
) -> Iterator[Dict[str, torch.Tensor]]:
    """The streamed scan's batches on ``device``: the same dicts a
    resident scan's batches are, with any dictionary deltas riding along
    as host payloads (``DICT_DELTA_PREFIX`` keys). They are packed on a
    prefetch thread, or, for a dataset that supports it with
    ``config.ingest_workers`` above 1, decoded and packed by the ordered
    ingest pool (``_pool_packed``); copied through the pinned ring
    (CUDA) and unpacked. Closing the generator closes the ring and joins
    every thread."""
    stats = stats if stats is not None else StreamStats()
    codecs = wire_mod.resolve_codecs(dataset, requests, enabled=wire_codecs)
    wire = _StreamWire(dataset, requests, codecs, stats)
    opts = config.options()
    depth = max(1, int(opts.ingest_depth))
    cuda = device.type == "cuda"
    ring = _StagingRing(depth + 1) if cuda else None
    copy_stream = torch.cuda.Stream(device) if cuda else None
    workers = resolve_ingest_workers(opts.ingest_workers)
    if workers > 1 and getattr(type(dataset), "supports_parallel_ingest", False):
        stats.pool = IngestPoolStats()
        packed_iter = _pool_packed(dataset, requests, batch_size, wire, ring, workers,
                                   resolve_ingest_lookahead(opts.ingest_lookahead, workers),
                                   stats.pool)
    else:
        n = dataset.num_rows
        source = _timed(dataset.host_batches(requests, batch_size), stats)
        packed_iter = _prefetched(
            (wire.pack(min(batch_size, n - start), batch, ring)
             for start, batch in zip(range(0, n, batch_size), source)),
            depth,
        )
    # one event a batch on the compute stream, recorded once the scan has
    # dispatched the batch's updates: the scan's thread runs at most
    # depth + 1 batches ahead of the device, which bounds the copied
    # buffers alive at once
    computed: List[Any] = []
    try:
        for packed in packed_iter:
            wire.account(packed)
            if len(computed) > depth:
                computed.pop(0).synchronize()
            batch = wire.unpack(packed, wire.copy_in(packed, device, copy_stream, ring), device)
            batch.update(packed.deltas)
            yield batch
            if cuda:
                computed.append(torch.cuda.current_stream(device).record_event())
    finally:
        if ring is not None:
            ring.close()
        packed_iter.close()


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
                 pool: IngestPoolStats) -> Iterator[_Packed]:
    """The packed batches of a streamed scan through the ordered ingest
    pool. A worker decodes a batch and packs it straight into a pinned
    slot, taken in batch order (``_StagingRing``), leaving room for the
    codes of the dictionary-delta columns; the ordered ``commit``, on
    the consuming thread, cuts the batch's deltas and writes those codes
    into the slot (a few MB a batch). Where those codes have a wire
    codec, or the codec table widened since the pack, the batch is
    packed (again) in ``commit``."""
    items = dataset.ingest_work_items(requests, batch_size)

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

    return ordered_ingest(items, work, commit, workers=workers, lookahead=lookahead,
                          stats=pool, sizer=sizer)


def _fits(dataset: Dataset, requests: Sequence[ColumnRequest]) -> bool:
    """Whether a scan of ``requests`` stays resident: the budget is
    non-zero and the columns fit it."""
    budget = config.options().device_cache_bytes
    return bool(budget) and dataset.estimated_device_bytes(requests) <= budget


class AnalysisEngine:
    """Executes fused analyzer scans on one device.

    ``device`` — ``"cuda"`` (the default, from ``config.options().device``
    when not given) or ``"cpu"``; a CUDA default without a GPU raises
    here, never later. ``batch_size`` — rows per fused step
    (``config.options().batch_size``, else ``min(rows, 2**21)``).
    """

    def __init__(self, device=None, batch_size: Optional[int] = None):
        self.device = config.resolve_device(device)
        self.batch_size = batch_size
        self.data_passes = 0
        self.device_fetches = 0
        # wall seconds of the last scan, by phase (host clock; the
        # "scan_s" phase ends in the synchronising fetch, "fold_s" is the
        # host folds of the per-batch outputs, drains' folds included;
        # "resident_s" the copy of a resident scan's columns, 0 when it
        # streams, and a streamed scan adds "pack_s" and "copy_s")
        self.phase_times: Optional[Dict[str, float]] = None
        self.stream_stats: Optional[StreamStats] = None

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

    def run_scan(
        self, dataset: Dataset, analyzers_and_ops: Sequence[Tuple[Any, ScanOps]]
    ) -> List[Any]:
        """Run every unit's update in one fused pass; returns the final
        states on the host, index-aligned with the input."""
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
        self.data_passes += 1
        t0 = time.perf_counter()
        if plan.mode == "resident":
            self.stream_stats = None
            batches = dataset.device_batches(plan.requests, plan.batch_size, plan.device)
        else:
            self.stream_stats = StreamStats()
            batches = stream_batches(
                dataset, plan.requests, plan.batch_size, plan.device,
                plan.wire_codecs, self.stream_stats,
            )
        try:
            return self._run_scan(plan.ops, batches, plan.device, t0,
                                  prime=plan.mode == "resident")
        finally:
            if plan.mode == "streaming":
                batches.close()

    def _run_scan(
        self,
        ops: Sequence[ScanOps],
        batches: Iterator[Dict[str, torch.Tensor]],
        device: torch.device,
        t0: float,
        prime: bool = False,
    ) -> List[Any]:
        consts = [_to_device(op.consts, device) for op in ops]
        states = [_to_device(op.init(), device) for op in ops]
        if prime:
            # no deltas flow on a resident scan: delta-carrying ops load
            # their whole dictionaries
            states = [s if op.host_delta is None else op.host_delta(s, DELTA_PRIME)
                      for op, s in zip(ops, states)]
        host_slots = [i for i, op in enumerate(ops) if op.host_fold is not None]
        accs = {i: ops[i].host_init() for i in host_slots}
        pending: List[List[Any]] = []  # per batch: the host slots' outputs
        fold_s = 0.0
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t1 = time.perf_counter()
        for batch in batches:
            if len(pending) == DRAIN_EVERY:
                self.device_fetches += 1
                fold_s += self._fold(ops, host_slots, accs, packed_device_get(
                    _stack_outputs(pending)))
                pending = []
            deltas = _pop_deltas(batch)
            if deltas:
                # in batch order, before the update of the batch that
                # shipped them: no code indexes past the written rows
                states = [s if op.host_delta is None else op.host_delta(s, deltas)
                          for op, s in zip(ops, states)]
            states = [
                op.apply_update(s, batch, c) for op, s, c in zip(ops, states, consts)
            ]
            if host_slots:
                pending.append([states[i] for i in host_slots])
        self.device_fetches += 1
        # device results are shielded from the fetch: they stay where
        # they are (the JAX package's _shield_device_results)
        fetch_slots = [
            i for i, op in enumerate(ops) if i not in accs and not op.device_result
        ]
        host_carried, fetched = packed_device_get(
            ([states[i] for i in fetch_slots], _stack_outputs(pending))
        )
        t2 = time.perf_counter()
        fold_s += self._fold(ops, host_slots, accs, fetched)
        host_states = list(states)
        for i, state in zip(fetch_slots, host_carried):
            host_states[i] = state
        for i, acc in accs.items():
            host_states[i] = acc
        self.phase_times = {"resident_s": t1 - t0, "scan_s": t2 - t1, "fold_s": fold_s}
        stats = self.stream_stats
        if stats is not None:
            stats.settle()
            self.phase_times.update(pack_s=stats.pack_s, copy_s=stats.copy_s)
        return host_states

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
