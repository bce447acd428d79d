"""The host half of row-level egress: the clean/quarantine parquet split.

Counterpart of ``deequ_tpu/egress/writer.py``. The device half
(``egress/plan.py``) evaluates each row's constraint outcomes inside
the fused scan and packs them a batch into ``(planes, B/8)`` uint8 bit
planes; what arrives here is those planes, fetched with the scan's
other host-folded outputs, and a batch's valid-row count. Everything
this module does is Arrow and parquet on the host:

- a **sequential span reader** takes each consumed span's rows from the
  dataset's ``record_batches`` (no device, no data pass);
- per span (one fold of the scan: a batch, or a slice of one that an
  out-of-memory backoff fed), the rows split into **clean** and
  **quarantine** tables, each written as its own row group at once, so
  the host holds one span, never the table;
- a batch the resilience layer quarantined (``engine/resilience.py``)
  lands WHOLE in the quarantine split with its ``BatchFailure``
  provenance (``__error_class__``, ``__error_message__``,
  ``__retry_attempts__``) and null outcome columns;
- the provenance integers (``__row_index__``, ``__batch_seq__``) take
  ``engine/wire.py::narrowest_int_dtype`` of their range, decided once
  a run.

Filtered rows follow ``verification/rowlevel.py``: under ``"true"`` a
row a ``where`` filter excludes passes; under ``"null"`` its outcome is
null and only ``~pass & ~excluded`` quarantines.

Durable egress: every span lands in an OPEN segment under ``spans/``,
published as a CRC-stamped ``seg-{seq}.parquet`` at each checkpoint
before the scan's cursor is saved (``flush_durable``: flush, then
cursor), and compacted into the public split at ``finish``; a resumed
run reconciles the segments with the checkpoint's ``EgressCursor``
(``align_resume``) and replays no row. A run whose engine has no
checkpointer can never resume: its spans go straight into the split
files, row group for row group what compaction would write.
"""

from __future__ import annotations

import json
import os
import queue
import shutil
import struct
import threading
import time
import zlib
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq

from deequ_tpu_torch.engine.wire import narrowest_int_dtype
from deequ_tpu_torch.io.storage import durable_replace, storage_for
from deequ_tpu_torch.telemetry import get_telemetry

#: the ``__failed_constraints__`` marker of rows the scan never evaluated
#: because the resilience layer quarantined their whole batch
BATCH_QUARANTINED = "__batch_quarantined__"

_PROV_ROW = "__row_index__"
_PROV_SEQ = "__batch_seq__"
_PROV_FAILED = "__failed_constraints__"
_PROV_ERR_CLASS = "__error_class__"
_PROV_ERR_MSG = "__error_message__"
_PROV_ATTEMPTS = "__retry_attempts__"
_PROV_TENANT = "__tenant__"
_PROV_RUN = "__run_id__"

#: a segment's routing column: 0 = clean, 1 = quarantine. It exists only
#: inside ``spans/seg-*.parquet``; compaction drops it
_SPLIT_COL = "__egress_split__"

#: columns only the quarantine split carries (null on clean rows inside
#: a segment; dropped again at compaction)
_Q_ONLY = (
    _PROV_FAILED,
    _PROV_ERR_CLASS,
    _PROV_ERR_MSG,
    _PROV_ATTEMPTS,
    _PROV_TENANT,
    _PROV_RUN,
)

_Q_ONLY_TYPES = {
    _PROV_FAILED: pa.string(),
    _PROV_ERR_CLASS: pa.string(),
    _PROV_ERR_MSG: pa.string(),
    _PROV_ATTEMPTS: pa.int32(),
    _PROV_TENANT: pa.string(),
    _PROV_RUN: pa.string(),
}

#: a segment is a parquet payload followed by ``<magic, payload length,
#: crc32>``: a torn tail (a crash while publishing) fails the check and
#: is never read as data
_SEG_MAGIC = b"DQTPUSG1"
_SEG_FOOTER = struct.Struct("<8sqI")
# bytes a segment's checksum reads at a time
_CRC_CHUNK = 1 << 26


@dataclass
class RowLevelSink:
    """A request to stream each row's constraint outcomes to a clean and
    a quarantine parquet split under ``out_dir``. Pass it to
    ``VerificationRunBuilder.with_row_level_sink`` (or
    ``row_level_sink=`` of ``do_verification_run``); after the run
    ``sink.report`` (also ``result.row_level_egress``) says what was
    written."""

    out_dir: str
    #: "true" (rows a where filter excludes pass) or "null" (their
    #: outcome is null, and only ~pass & ~excluded quarantines)
    filtered_row_outcome: str = "true"
    #: the row columns the split carries (None: every column)
    columns: Optional[Sequence[str]] = None
    tenant: str = ""
    run_id: str = ""
    #: set by the run: the EgressReport of its finalize
    report: Optional["EgressReport"] = None

    def __post_init__(self):
        if self.filtered_row_outcome not in ("true", "null"):
            raise ValueError(
                "filtered_row_outcome must be 'true' or 'null', got "
                f"{self.filtered_row_outcome!r}"
            )


@dataclass
class EgressReport:
    """What one run's egress wrote (also the manifest's fields)."""

    status: str  # complete | interrupted | aborted | no_row_level_constraints
    rows_total: int = 0
    rows_clean: int = 0
    rows_quarantined: int = 0
    bytes_raw: int = 0
    bytes_encoded: int = 0
    #: constraint name -> "scan" (rode the fused scan) or "deferred"
    #: (evaluated at finalize: uniqueness, untraceable assertions)
    constraints: Dict[str, str] = field(default_factory=dict)
    #: constraint name -> why it has no outcome column
    unsupported: Dict[str, str] = field(default_factory=dict)
    clean_dir: str = ""
    quarantine_dir: str = ""
    manifest_path: str = ""

    @property
    def rows_written(self) -> int:
        return self.rows_clean + self.rows_quarantined


class _BackgroundWrites:
    """Parquet writes run in order on one background thread a file, so
    that encoding a span overlaps making the next; at most ``depth``
    writes wait a file. An error of a write is raised on the caller's
    thread at its next call (the run fails), and ``close`` joins every
    thread."""

    def __init__(self, depth: int = 2):
        self.depth = depth
        self.seconds = 0.0  # the threads' seconds in the writes
        self._queues: Dict[str, queue.Queue] = {}
        self._threads: List[threading.Thread] = []
        self._error: Optional[BaseException] = None
        self._lock = threading.Lock()

    def submit(self, key: str, fn, *args) -> None:
        self._raise()
        q = self._queues.get(key)
        if q is None:
            q = self._queues[key] = queue.Queue(self.depth)
            thread = threading.Thread(target=self._run, args=(q,), daemon=True,
                                      name=f"deequ-egress-{key}")
            thread.start()
            self._threads.append(thread)
        q.put((fn, args))

    def _run(self, q: queue.Queue) -> None:
        while True:
            item = q.get()
            try:
                if item is None:
                    return
                if self._error is None:
                    t0 = time.perf_counter()
                    item[0](*item[1])
                    with self._lock:
                        self.seconds += time.perf_counter() - t0
            except BaseException as exc:  # noqa: BLE001 — raised on the caller's thread
                self._error = exc
            finally:
                q.task_done()

    def drain(self, key: Optional[str] = None) -> None:
        """Wait for the writes of ``key`` (every file when None)."""
        for k, q in list(self._queues.items()):
            if key is None or k == key:
                q.join()
        self._raise()

    def close(self, raise_error: bool = True) -> None:
        """Finish the queued writes and join every thread."""
        for q in self._queues.values():
            q.put(None)
        for thread in self._threads:
            thread.join()
        self._queues.clear()
        self._threads.clear()
        if raise_error:
            self._raise()
        self._error = None

    def _raise(self) -> None:
        if self._error is not None:
            error, self._error = self._error, None
            raise error


class _SpanReader:
    """``take(n)``: the next n source rows as an Arrow table, from the
    dataset's ``record_batches``; it buffers at most one read batch
    beyond a span."""

    def __init__(self, data, columns: Sequence[str], batch_rows: int = 1 << 16):
        self._iter = iter(data.record_batches(list(columns), batch_rows))
        self._parts: List[pa.Table] = []
        self._buffered = 0

    def take(self, n: int) -> pa.Table:
        while self._buffered < n:
            nxt = next(self._iter, None)
            if nxt is None:
                break
            part = pa.Table.from_batches([nxt])
            self._parts.append(part)
            self._buffered += part.num_rows
        if self._buffered < n:
            raise RuntimeError(
                f"egress span reader exhausted: need {n} more rows, "
                f"source has {self._buffered}: the span accounting is "
                "misaligned with the scan"
            )
        tbl = pa.concat_tables(self._parts) if len(self._parts) > 1 else self._parts[0]
        out = tbl.slice(0, n)
        rest = tbl.slice(n)
        self._parts = [rest] if rest.num_rows else []
        self._buffered = rest.num_rows
        return out.combine_chunks()


@dataclass
class _FailureSpan:
    """A quarantined unit's rows in source coordinates: the TAIL of its
    unit, the rows a backed-off batch had not folded when it gave up."""

    start: int
    length: int
    error_class: str
    message: str
    attempts: int


def _repeat(value: Optional[str], n: int) -> pa.Array:
    """``n`` copies of a string, or ``n`` nulls: the array (and the byte
    count) that a list of them gives, without the list."""
    if value is None:
        return pa.nulls(n, pa.string())
    return pa.repeat(pa.scalar(value, pa.string()), n)


def _combine(
    passes: np.ndarray, excl: Optional[np.ndarray], mode: str
) -> Tuple[np.ndarray, Optional[np.ndarray], np.ndarray]:
    """(outcome values, null mask or None, per-row fail) of one
    constraint, as ``verification/rowlevel.py`` reckons them."""
    if excl is None:
        return passes, None, ~passes
    if mode == "true":
        outcome = passes | excl
        return outcome, None, ~outcome
    # "null": excluded rows are null and never quarantine
    return passes, excl, ~passes & ~excl


class QuarantineWriter:
    """Streams one run's row-level outcomes to a clean/quarantine split,
    in one of two modes:

    - **direct** (every outcome column rides the scan): each fold's span
      is written when it is consumed;
    - **spool** (a deferred constraint: uniqueness, or an assertion that
      does not run on a tensor): the scan only appends the packed planes
      to ``_scan_bits.spool`` (about planes/8 bytes a row), and
      ``replay_spool`` writes the split at finalize, merged with the
      deferred outcomes. The deferred families read the data again, so
      such a run counts ``engine.data_passes == 2``.
    """

    def __init__(
        self,
        sink: RowLevelSink,
        data,
        scan_names: Sequence[str],
        excl_of: Sequence[Optional[int]],
        deferred_names: Sequence[str],
        plane_shape: Tuple[int, int],
        row_columns: Sequence[str],
    ):
        self.sink = sink
        self._data = data
        self.scan_names = list(scan_names)
        self.excl_of = list(excl_of)
        self.deferred_names = list(deferred_names)
        self._plane_shape = tuple(plane_shape)
        self._row_columns = list(row_columns)
        self.num_rows = int(data.num_rows)
        self.cursor = 0
        self.rows_clean = 0
        self.rows_quarantined = 0
        self.bytes_raw = 0
        self.bytes_encoded = 0
        self._reader: Optional[_SpanReader] = None
        self._writers: Dict[str, pq.ParquetWriter] = {}
        self._paths: Dict[str, str] = {}
        self._schemas: Dict[str, pa.Schema] = {}
        self._published_schemas: Dict[pa.Schema, pa.Schema] = {}
        self._row_schema: Optional[pa.Schema] = None
        # the scan's geometry (bind_geometry): unit_rows is what the
        # resilience layer quarantines (a batch, on either path)
        self._unit_rows: Optional[int] = None
        self._batch_size: Optional[int] = None
        self._idx_dtype = narrowest_int_dtype(0, max(self.num_rows - 1, 0))
        self._seq_dtype = np.dtype(np.int64)
        self._probe = None  # the live ScanDegradation of the scan
        self._pending: List[_FailureSpan] = []
        self._seen_failure_idx: set = set()
        # the label of each failure pattern seen, by its packed words
        self._labels: Dict[Tuple[int, bytes], str] = {}
        self.spool_mode = bool(self.deferred_names)
        self._spool = None
        self._spool_path = os.path.join(sink.out_dir, "_scan_bits.spool")
        os.makedirs(sink.out_dir, exist_ok=True)
        # span segments: every span lands in the OPEN segment under
        # spans/, published as seg-{seq}.parquet at each durable flush
        # and compacted into the split at finish. The spool opens
        # lazily, to append: opening it for writing here would truncate
        # the bytes a resume is about to trust
        self._seg_dir = os.path.join(sink.out_dir, "spans")
        self._seg_tmp = os.path.join(self._seg_dir, ".seg-open.tmp")
        self._seg_seq = 0
        self._seg_writer: Optional[pq.ParquetWriter] = None
        self._seg_schema: Optional[pa.Schema] = None
        self._open_span_rows = 0
        self._span_row_bound: Optional[int] = None
        self._rows_replayed = 0
        # False for a run that cannot resume (no checkpointer): spans go
        # straight into the split files
        self.durable = True
        self._writes = _BackgroundWrites()
        # seconds of the writer's parts on the caller's thread (the
        # encoding is the write threads': ``write_seconds``)
        self.seconds: Dict[str, float] = {"spans": 0.0, "compaction": 0.0, "manifest": 0.0}
        self.segments_written = 0

    @property
    def write_seconds(self) -> float:
        """Seconds the write threads spent encoding parquet."""
        return self._writes.seconds

    @property
    def rows_replayed(self) -> int:
        """Rows a resumed run wrote again (0 by construction)."""
        return self._rows_replayed

    # -- wiring ---------------------------------------------------------

    def bind_geometry(self, unit_rows: int, batch_size: int, durable: bool = True) -> None:
        """Once the engine has planned the scan: the unit the resilience
        layer quarantines, the batch size of ``__batch_seq__`` (whose
        dtype is decided here, once a run), and whether the run can
        resume (``durable``: it has a checkpointer)."""
        from deequ_tpu_torch import config

        self._unit_rows = int(unit_rows)
        self._batch_size = int(batch_size)
        self.durable = bool(durable)
        n_units = max(1, -(-max(self.num_rows, 1) // max(self._batch_size, 1)))
        self._seq_dtype = narrowest_int_dtype(0, n_units - 1)
        # the open segment holds at most one checkpoint interval of rows;
        # past it, it is published early
        every = int(config.options().checkpoint_every_batches)
        self._span_row_bound = every * self._batch_size if every > 0 else None

    def set_degradation_probe(self, probe) -> None:
        """A callable returning the scan's live ``ScanDegradation``,
        read before each span so that quarantined units land in source
        order."""
        self._probe = probe

    # -- the scan's folds (the op's host_fold) --------------------------

    def consume(self, bits: np.ndarray, valid: int) -> None:
        """One fold of the scan: the packed ``(planes, B/8)`` uint8
        planes and the rows they cover; written at once (direct) or
        appended to the spool (spool mode)."""
        bits = np.ascontiguousarray(bits, dtype=np.uint8)
        valid = int(valid)
        if bits.shape != self._plane_shape:
            raise RuntimeError(
                f"egress fold shape {bits.shape} != planned {self._plane_shape}"
            )
        if self.spool_mode:
            spool = self._ensure_spool()
            spool.write(struct.pack("<q", valid))
            spool.write(bits.tobytes())
            spool.flush()
            return
        if self._probe is not None:
            self._refresh_failures(self._probe())
        self._emit(bits, valid, deferred=None)

    # -- quarantined units --------------------------------------------------

    def _refresh_failures(self, record) -> None:
        if record is None:
            return
        unit = self._unit_rows
        if unit is None:
            raise RuntimeError(
                "the egress writer has no scan geometry: bind_geometry was never called"
            )
        for f in getattr(record, "failures", ()):
            idx = int(f.batch_index)
            if idx in self._seen_failure_idx:
                continue
            self._seen_failure_idx.add(idx)
            unit_rows = max(0, min(self.num_rows - idx * unit, unit))
            length = min(int(f.rows), unit_rows)
            # a partial quarantine covers the TAIL of its unit
            start = idx * unit + (unit_rows - length)
            self._pending.append(_FailureSpan(
                start=start, length=length, error_class=str(f.error_class),
                message=str(f.message), attempts=int(f.attempts),
            ))
        self._pending.sort(key=lambda s: s.start)

    def _drain_failures(self) -> None:
        while self._pending and self._pending[0].start <= self.cursor:
            span = self._pending.pop(0)
            if span.start < self.cursor:
                raise RuntimeError(
                    f"egress alignment: the quarantined span at row {span.start} "
                    f"overlaps rows already written (cursor {self.cursor})"
                )
            self._emit_failure(span)

    # -- spans ------------------------------------------------------------

    def _ensure_reader(self) -> _SpanReader:
        if self._reader is None:
            self._reader = _SpanReader(self._data, self._row_columns)
        return self._reader

    def _emit(
        self,
        bits: np.ndarray,
        valid: int,
        deferred: Optional[Dict[str, Tuple[np.ndarray, Optional[np.ndarray]]]],
    ) -> None:
        self._drain_failures()
        if valid <= 0:
            return
        t0 = time.perf_counter()
        start = self.cursor
        planes = np.unpackbits(bits, axis=1, bitorder="little")[:, :valid].astype(bool)
        n_scan = len(self.scan_names)
        outcome_cols: List[Tuple[str, np.ndarray, Optional[np.ndarray]]] = []
        fails: List[np.ndarray] = []
        for i, name in enumerate(self.scan_names):
            e = self.excl_of[i]
            excl = planes[n_scan + e] if e is not None else None
            outcome, null_mask, fail = _combine(planes[i], excl, self.sink.filtered_row_outcome)
            outcome_cols.append((name, outcome, null_mask))
            fails.append(fail)
        for name in self.deferred_names:
            full = (deferred or {}).get(name)
            if full is None:
                continue  # the oracle dropped this constraint at finalize
            full_out, full_excl = full
            p = np.asarray(full_out[start:start + valid], dtype=bool)
            excl = (np.asarray(full_excl[start:start + valid], dtype=bool)
                    if full_excl is not None else None)
            outcome, null_mask, fail = _combine(p, excl, self.sink.filtered_row_outcome)
            outcome_cols.append((name, outcome, null_mask))
            fails.append(fail)
        fail_any = np.logical_or.reduce(fails) if fails else np.zeros(valid, dtype=bool)
        rows = self._ensure_reader().take(valid)
        row_idx = np.arange(start, start + valid)
        clean_sel = ~fail_any
        self._write_split("clean", rows, outcome_cols, clean_sel, row_idx)
        self._write_split(
            "quarantine", rows, outcome_cols, fail_any, row_idx,
            failed_labels=self._failed_labels(fails, fail_any, outcome_cols),
        )
        n_clean = int(clean_sel.sum())
        self.rows_clean += n_clean
        self.rows_quarantined += valid - n_clean
        self.cursor += valid
        self.seconds["spans"] += time.perf_counter() - t0
        self._note_open_span()

    def _failed_labels(self, fails, fail_any, outcome_cols) -> Optional[pa.Array]:
        """One ';'-joined set of failing constraints a quarantined row,
        made once a distinct failure pattern (each row's pattern packed
        into 64-bit words and grouped by them; a pattern's label kept for
        the later spans) and taken per row by Arrow: the array, to its
        buffers, that a list of the labels gives."""
        nq = int(fail_any.sum())
        if nq == 0 or not fails:
            return None
        names = [name for name, _o, _m in outcome_cols]
        sub = np.stack(fails, axis=0)[:, fail_any]
        packed = np.packbits(sub, axis=0, bitorder="little")
        words = np.zeros((-(-packed.shape[0] // 8) * 8, nq), dtype=np.uint8)
        words[:packed.shape[0]] = packed
        keys = np.ascontiguousarray(words.T).view(np.uint64)
        if keys.shape[1] == 1:
            _, first, inv = np.unique(keys[:, 0], return_index=True, return_inverse=True)
        else:
            _, first, inv = np.unique(keys, axis=0, return_index=True, return_inverse=True)
        labels = []
        for j in first:
            key = (len(names), keys[j].tobytes())
            label = self._labels.get(key)
            if label is None:
                label = self._labels[key] = ";".join(names[i] for i in np.nonzero(sub[:, j])[0])
            labels.append(label)
        taken = pa.DictionaryArray.from_arrays(
            pa.array(np.asarray(inv, dtype=np.int32).ravel()), pa.array(labels, pa.string())
        ).dictionary_decode()
        # no validity bitmap: no label is null
        return pa.Array.from_buffers(pa.string(), nq, [None] + taken.buffers()[1:], null_count=0)

    def _emit_failure(self, span: _FailureSpan) -> None:
        """A quarantined unit, whole, into the quarantine split with its
        provenance; its outcome columns are null (never evaluated)."""
        t0 = time.perf_counter()
        rows = self._ensure_reader().take(span.length)
        row_idx = np.arange(span.start, span.start + span.length)
        null_outcomes = [(name, None, None) for name in self.scan_names + self.deferred_names]
        self._write_split(
            "quarantine", rows, null_outcomes, np.ones(span.length, dtype=bool), row_idx,
            failed_labels=_repeat(BATCH_QUARANTINED, span.length),
            error=(span.error_class, span.message, span.attempts),
        )
        self.rows_quarantined += span.length
        self.cursor += span.length
        self.seconds["spans"] += time.perf_counter() - t0
        self._note_open_span()

    def _write_split(
        self,
        which: str,
        rows: pa.Table,
        outcome_cols,
        sel: np.ndarray,
        row_idx: np.ndarray,
        failed_labels: Optional[pa.Array] = None,
        error: Optional[Tuple[str, str, int]] = None,
    ) -> None:
        n = int(sel.sum())
        if n == 0:
            return
        if self._row_schema is None:
            self._row_schema = rows.schema
        arrays = list(rows.filter(pa.array(sel)).columns)
        names = list(rows.schema.names)
        for name, outcome, null_mask in outcome_cols:
            if outcome is None:  # a quarantined batch: never evaluated
                arrays.append(pa.nulls(n, pa.bool_()))
            elif null_mask is None:
                arrays.append(pa.array(outcome[sel]))
            else:
                arrays.append(pa.array(outcome[sel], mask=null_mask[sel]))
            names.append(name)
        idx = row_idx[sel]
        arrays.append(pa.array(idx.astype(self._idx_dtype)))
        names.append(_PROV_ROW)
        seq = idx // max(int(self._batch_size or 1), 1)
        arrays.append(pa.array(seq.astype(self._seq_dtype)))
        names.append(_PROV_SEQ)
        # the provenance integers narrowed; raw prices them at int64
        raw_extra = (16 - self._idx_dtype.itemsize - self._seq_dtype.itemsize) * n
        if which == "quarantine":
            arrays.append(_repeat("", n) if failed_labels is None else failed_labels)
            names.append(_PROV_FAILED)
            err_class, err_msg, attempts = error or (None, None, 0)
            arrays.append(_repeat(err_class, n))
            names.append(_PROV_ERR_CLASS)
            arrays.append(_repeat(err_msg, n))
            names.append(_PROV_ERR_MSG)
            arrays.append(pa.array(np.full(n, int(attempts), dtype=np.int32)))
            names.append(_PROV_ATTEMPTS)
            arrays.append(_repeat(self.sink.tenant, n))
            names.append(_PROV_TENANT)
            arrays.append(_repeat(self.sink.run_id, n))
            names.append(_PROV_RUN)
        table = pa.Table.from_arrays(arrays, names=names)
        # one row group a span's split, into the open segment (or, for a
        # run that cannot resume, the split file itself)
        self._segment_append(which, table)
        nbytes = table.nbytes
        self.bytes_encoded += nbytes
        self.bytes_raw += nbytes + raw_extra
        tm = get_telemetry()
        tm.counter("engine.egress_bytes_encoded").inc(nbytes)
        tm.counter("engine.egress_bytes_raw").inc(nbytes + raw_extra)

    def _ensure_writer(self, which: str, schema: pa.Schema) -> pq.ParquetWriter:
        writer = self._writers.get(which)
        if writer is None:
            split_dir = os.path.join(self.sink.out_dir, which)
            os.makedirs(split_dir, exist_ok=True)
            path = os.path.join(split_dir, "part-00000.parquet")
            writer = pq.ParquetWriter(path, schema)
            self._writers[which] = writer
            self._paths[which] = path
            self._schemas[which] = schema
        return writer

    # -- span segments ----------------------------------------------------

    def _ensure_spool(self):
        """The plane spool, opened at first use to APPEND: after a resume
        it holds every fsync'd record up to the cursor's offset."""
        if self._spool is None:
            self._spool = open(self._spool_path, "ab")
        return self._spool

    def _segment_schema(self, first: pa.Schema) -> pa.Schema:
        """The schema every segment of a run shares, whichever split
        seeds it: row, outcome and provenance columns, the
        quarantine-only columns (null on clean rows), the routing tag."""
        fields = list(first)
        names = set(first.names)
        for name in _Q_ONLY:
            if name not in names:
                fields.append(pa.field(name, _Q_ONLY_TYPES[name]))
        fields.append(pa.field(_SPLIT_COL, pa.int8()))
        return pa.schema(fields)

    def _published(self, table: pa.Table) -> pa.Table:
        """``table`` in the types a span segment's parquet round trip
        gives it (date64 as date32, time32[s] as time32[ms], a numeric
        dictionary decoded, a list's item named ``element``): the JAX
        package's split is always compacted from segments, so a split
        written directly carries those types too. A cast only where a
        type changes."""
        schema = self._published_schemas.get(table.schema)
        if schema is None:
            buf = pa.BufferOutputStream()
            pq.write_table(table.schema.empty_table(), buf)
            schema = pq.read_schema(pa.BufferReader(buf.getvalue()))
            self._published_schemas[table.schema] = schema
        return table if schema.equals(table.schema) else table.cast(schema, safe=False)

    def _segment_append(self, which: str, table: pa.Table) -> None:
        if not self.durable:
            table = self._published(table)
            self._writes.submit(which, self._ensure_writer(which, table.schema).write_table, table)
            return
        if self._seg_writer is None:
            if self._seg_schema is None:
                self._seg_schema = self._segment_schema(table.schema)
            os.makedirs(self._seg_dir, exist_ok=True)
            self._seg_writer = pq.ParquetWriter(self._seg_tmp, self._seg_schema)
        n = table.num_rows
        split_val = 1 if which == "quarantine" else 0
        arrays = []
        for fld in self._seg_schema:
            if fld.name == _SPLIT_COL:
                arrays.append(pa.array(np.full(n, split_val, dtype=np.int8)))
            elif fld.name in table.schema.names:
                arrays.append(table.column(fld.name))
            else:
                arrays.append(pa.nulls(n, fld.type))
        self._writes.submit("segment", self._seg_writer.write_table,
                            pa.Table.from_arrays(arrays, schema=self._seg_schema))
        self._open_span_rows += n

    def _note_open_span(self) -> None:
        """Past one checkpoint interval of rows the open segment is
        published early, so it never grows without bound; rows of such
        a segment past the last cursor are dropped and scanned again on
        a resume."""
        bound = self._span_row_bound
        if bound is None or self._open_span_rows <= bound:
            return
        get_telemetry().event("egress_span_overflow", open_rows=self._open_span_rows,
                              bound=bound, span_seq=self._seg_seq)
        self._finalize_open_segment()
        # an overflow rotation is durable progress between checkpoints:
        # a spawned child streams it to its parent (engine/subproc.py)
        from deequ_tpu_torch.engine.subproc import notify_egress_progress

        notify_egress_progress({"span_seq": self._seg_seq - 1, "rows_clean": self.rows_clean,
                                "rows_quarantined": self.rows_quarantined, "spool_offset": 0})

    def _finalize_open_segment(self) -> bool:
        """Close the open segment, stamp its CRC footer and publish it
        durably as ``spans/seg-{seq:010d}.parquet`` (fsync, atomic
        rename, directory fsync). False when nothing was written since
        the last one. This flush comes before every ``EgressCursor``."""
        if self._seg_writer is None:
            return False
        self._writes.drain("segment")
        self._seg_writer.close()
        self._seg_writer = None
        crc, length = 0, 0
        with open(self._seg_tmp, "rb") as fh:
            while True:
                chunk = fh.read(_CRC_CHUNK)
                if not chunk:
                    break
                crc = zlib.crc32(chunk, crc)
                length += len(chunk)
        footer = _SEG_FOOTER.pack(_SEG_MAGIC, length, crc & 0xFFFFFFFF)
        with open(self._seg_tmp, "ab") as fh:
            fh.write(footer)
        final = os.path.join(self._seg_dir, f"seg-{self._seg_seq:010d}.parquet")
        durable_replace(self._seg_tmp, final)
        self._seg_seq += 1
        self._open_span_rows = 0
        self.segments_written += 1
        get_telemetry().counter("engine.egress_spans_flushed").inc()
        return True

    def flush_durable(self):
        """Make every row consumed so far durable and return the
        :class:`~deequ_tpu_torch.io.state_provider.EgressCursor` naming
        that state. The engine calls it at a checkpoint after the
        pending folds are drained and BEFORE the scan's cursor is saved
        (flush, then cursor), so a resume replays nothing and drops
        nothing."""
        from deequ_tpu_torch.io.state_provider import EgressCursor

        spool_offset = 0
        if self.spool_mode and self._spool is not None:
            self._spool.flush()
            os.fsync(self._spool.fileno())
            spool_offset = self._spool.tell()
        self._finalize_open_segment()
        cursor = EgressCursor(
            last_durably_flushed_span_seq=self._seg_seq - 1,
            rows_emitted_clean=self.rows_clean,
            rows_emitted_quarantined=self.rows_quarantined,
            plane_spool_offset=spool_offset,
            bytes_raw=self.bytes_raw,
            bytes_encoded=self.bytes_encoded,
        )
        # a spawned child streams the durable cursor to its parent, so
        # egress that advances between scan checkpoints resets the
        # crash-loop count (engine/subproc.py)
        from deequ_tpu_torch.engine.subproc import notify_egress_progress

        notify_egress_progress({"span_seq": cursor.last_durably_flushed_span_seq,
                                "rows_clean": self.rows_clean,
                                "rows_quarantined": self.rows_quarantined,
                                "spool_offset": spool_offset})
        return cursor

    def align_resume(self, payload):
        """Reconcile the writer with a scan checkpoint (or its absence)
        BEFORE the scan starts. A trustworthy egress cursor restores the
        durable state (the torn tail past its segment dropped, the span
        reader moved past the rows written, nothing replayed) and the
        payload is returned for the scan to resume from; anything else
        (no checkpoint, one without a cursor, a missing or corrupt
        segment) starts a FRESH artifact and returns None, so the scan
        starts at row zero."""
        cursor = payload["cursor"] if payload is not None else None
        eg = getattr(cursor, "egress", None)
        if eg is None or not self._resume_from(eg, payload.get("degradation")):
            self.start_fresh()
            return None
        # 0 by construction: the cursor was written only after its
        # segment was made durable, so nothing is written again
        tm = get_telemetry()
        tm.counter("engine.egress_rows_replayed").inc(self._rows_replayed)
        tm.event("egress_resumed", span_seq=int(eg.last_durably_flushed_span_seq),
                 rows_clean=self.rows_clean, rows_quarantined=self.rows_quarantined,
                 rows_replayed=self._rows_replayed)
        return payload

    def _resume_from(self, eg, record) -> bool:
        seq = int(eg.last_durably_flushed_span_seq)
        # the torn open segment and any segment PAST the cursor (an early
        # publication after the last checkpoint) go: their rows were
        # never under a cursor, so the scan writes them again, once
        if os.path.exists(self._seg_tmp):
            os.remove(self._seg_tmp)
        have = self._list_segments()
        if any(s not in have for s in range(seq + 1)):
            return False
        if seq >= 0 and not self._segment_intact(have[seq]):
            return False
        for s, path in have.items():
            if s > seq:
                os.remove(path)
        offset = int(eg.plane_spool_offset)
        if self.spool_mode:
            if not os.path.exists(self._spool_path):
                if offset:
                    return False
            elif os.path.getsize(self._spool_path) < offset:
                return False
            else:
                with open(self._spool_path, "rb+") as fh:
                    fh.truncate(offset)
        self.rows_clean = int(eg.rows_emitted_clean)
        self.rows_quarantined = int(eg.rows_emitted_quarantined)
        self.cursor = self.rows_clean + self.rows_quarantined
        self.bytes_raw = int(eg.bytes_raw)
        self.bytes_encoded = int(eg.bytes_encoded)
        self._seg_seq = seq + 1
        self._rows_replayed = 0
        # the span reader moves past the rows already written: taken and
        # dropped, never written again
        skip = self.cursor
        reader = self._ensure_reader()
        while skip > 0:
            step = min(skip, 1 << 16)
            reader.take(step)
            skip -= step
        # quarantined units written before the cursor stay out of the queue
        self._refresh_failures(record)
        self._pending = [s for s in self._pending if s.start >= self.cursor]
        return True

    def start_fresh(self) -> None:
        """Remove whatever an earlier attempt left under ``out_dir``
        (segments, split files, spool, manifest), so an attempt that
        cannot resume writes from row zero, never over stale spans."""
        self._writes.close(raise_error=False)
        if self._seg_writer is not None:
            try:
                self._seg_writer.close()
            except Exception:  # noqa: BLE001 — best-effort teardown
                pass
            self._seg_writer = None
        for path in (self._seg_tmp, self._spool_path,
                     os.path.join(self.sink.out_dir, "manifest.json")):
            if os.path.exists(path):
                os.remove(path)
        for sub in ("spans", "clean", "quarantine"):
            shutil.rmtree(os.path.join(self.sink.out_dir, sub), ignore_errors=True)
        self._seg_seq = 0
        self._open_span_rows = 0
        self._rows_replayed = 0

    def _list_segments(self) -> Dict[int, str]:
        out: Dict[int, str] = {}
        if not os.path.isdir(self._seg_dir):
            return out
        for name in os.listdir(self._seg_dir):
            if name.startswith("seg-") and name.endswith(".parquet"):
                try:
                    out[int(name[4:-8])] = os.path.join(self._seg_dir, name)
                except ValueError:
                    continue
        return out

    def _read_segment_payload(self, path: str):
        """The parquet payload of a CRC-stamped segment (a buffer of a
        memory map), or None when its footer is missing, torn, or fails
        its checksum."""
        mapped = pa.memory_map(path, "r")
        size = mapped.size()
        if size < _SEG_FOOTER.size:
            return None
        blob = mapped.read_buffer()
        magic, length, crc = _SEG_FOOTER.unpack(blob.slice(size - _SEG_FOOTER.size).to_pybytes())
        if magic != _SEG_MAGIC or length != size - _SEG_FOOTER.size:
            return None
        view = memoryview(blob)
        got = 0
        for start in range(0, length, _CRC_CHUNK):
            got = zlib.crc32(view[start:min(length, start + _CRC_CHUNK)], got)
        if (got & 0xFFFFFFFF) != crc:
            return None
        return blob.slice(0, length)

    def _segment_intact(self, path: str) -> bool:
        try:
            return self._read_segment_payload(path) is not None
        except OSError:
            return False

    def _compact_segments(self) -> None:
        """Collapse the segments into the public ``clean/`` and
        ``quarantine/`` split, row group by row group in span order, each
        group routed whole by its ``__egress_split__`` tag, so that the
        split is byte-identical whether or not the run was ever
        interrupted."""
        have = self._list_segments()
        for s in range(len(have)):
            path = have.get(s)
            if path is None:
                raise RuntimeError(
                    f"egress segment seq {s} missing at compaction: the span "
                    "sequence must have no gap"
                )
            payload = self._read_segment_payload(path)
            if payload is None:
                raise RuntimeError(f"egress segment {path} failed its CRC check")
            pf = pq.ParquetFile(pa.BufferReader(payload))
            for g in range(pf.num_row_groups):
                group = pf.read_row_group(g)
                if group.num_rows == 0:
                    continue
                is_q = bool(group.column(_SPLIT_COL)[0].as_py())
                which = "quarantine" if is_q else "clean"
                drop = {_SPLIT_COL}
                if which == "clean":
                    drop.update(_Q_ONLY)
                routed = group.select([nm for nm in group.schema.names if nm not in drop])
                self._writes.submit(which, self._ensure_writer(which, routed.schema).write_table,
                                    routed)
            get_telemetry().counter("engine.egress_segments_compacted").inc()

    # -- finalize ---------------------------------------------------------

    def replay_spool(self, deferred, record) -> None:
        """Spool mode, at finalize: the spooled planes merged with the
        deferred outcomes, written span by span as the direct mode
        writes them."""
        if self._spool is not None:
            self._spool.close()
            self._spool = None
        self._refresh_failures(record)
        n_planes, b8 = self._plane_shape
        rec_bytes = n_planes * b8
        with open(self._spool_path, "rb") as fh:
            while True:
                head = fh.read(8)
                if len(head) < 8:
                    break
                (valid,) = struct.unpack("<q", head)
                payload = fh.read(rec_bytes)
                bits = np.frombuffer(payload, dtype=np.uint8).reshape(n_planes, b8)
                self._emit(bits, int(valid), deferred=deferred)

    def finish(self, record, interrupted: bool) -> Tuple[int, int]:
        """Write the quarantined units after the last fold, close the
        writers (an empty file for a split that has no row, so a reader
        always finds both) and return (rows_clean, rows_quarantined)."""
        self._refresh_failures(record)
        self._drain_failures()
        if not interrupted and self.cursor != self.num_rows:
            raise RuntimeError(
                f"egress wrote {self.cursor} of {self.num_rows} source rows "
                "without an interruption: the span accounting is wrong"
            )
        if interrupted:
            # the artifact stays in span form to resume from: the open
            # segment published, spool and segments kept, NO split file
            # (only a completing attempt compacts, so every row is
            # counted once across attempts)
            self._finalize_open_segment()
            self._writes.close()
            if self._spool is not None:
                self._spool.flush()
                self._spool.close()
                self._spool = None
            return self.rows_clean, self.rows_quarantined
        t0 = time.perf_counter()
        self._finalize_open_segment()
        self._compact_segments()
        self._writes.close()
        for which in ("clean", "quarantine"):
            if which not in self._writers:
                schema = self._split_schema_for(which)
                if schema is not None:
                    self._ensure_writer(which, schema)
        for writer in self._writers.values():
            writer.close()
        self._writers.clear()
        if self._spool is not None:
            self._spool.close()
            self._spool = None
        if os.path.exists(self._spool_path):
            os.remove(self._spool_path)
        shutil.rmtree(self._seg_dir, ignore_errors=True)
        self.seconds["compaction"] += time.perf_counter() - t0
        tm = get_telemetry()
        tm.counter("engine.rows_clean").inc(self.rows_clean)
        tm.counter("engine.rows_quarantined").inc(self.rows_quarantined)
        if tm.current_trace() is not None:
            tm.emit_span("egress", time.perf_counter() - t0, rows_clean=self.rows_clean,
                         rows_quarantined=self.rows_quarantined)
        return self.rows_clean, self.rows_quarantined

    def abort(self) -> None:
        """The scan failed outright: close everything without the
        alignment check; what was written stays for inspection, and the
        report says 'aborted'."""
        self._writes.close(raise_error=False)
        if self._seg_writer is not None:
            try:
                self._seg_writer.close()
            except Exception:  # noqa: BLE001 — best-effort teardown
                pass
            self._seg_writer = None
        for writer in self._writers.values():
            try:
                writer.close()
            except Exception:  # noqa: BLE001 — best-effort teardown
                pass
        self._writers.clear()
        if self._spool is not None:
            try:
                self._spool.close()
            except Exception:  # noqa: BLE001
                pass
            self._spool = None
        if os.path.exists(self._spool_path):
            os.remove(self._spool_path)

    def _split_schema_for(self, which: str) -> Optional[pa.Schema]:
        """The schema of an empty split file: from the run's row schema,
        else (a resumed run that wrote nothing after its resume) from
        the other split's, else None (no row at all, no file)."""
        if self._row_schema is not None:
            return self._empty_schema_for(which)
        other = self._schemas.get("quarantine" if which == "clean" else "clean")
        if other is None:
            return None
        if which == "clean":
            return pa.schema([f for f in other if f.name not in _Q_ONLY])
        return pa.schema(list(other) + [pa.field(nm, _Q_ONLY_TYPES[nm])
                                        for nm in _Q_ONLY if nm not in other.names])

    def _empty_schema_for(self, which: str) -> pa.Schema:
        fields = list(self._row_schema)
        for name in self.scan_names + self.deferred_names:
            fields.append(pa.field(name, pa.bool_()))
        fields.append(pa.field(_PROV_ROW, pa.from_numpy_dtype(self._idx_dtype)))
        fields.append(pa.field(_PROV_SEQ, pa.from_numpy_dtype(self._seq_dtype)))
        if which == "quarantine":
            fields.extend(pa.field(nm, _Q_ONLY_TYPES[nm]) for nm in _Q_ONLY)
        return pa.schema(fields)

    def write_manifest(self, report: EgressReport, extra: Dict[str, Any]) -> str:
        t0 = time.perf_counter()
        path = os.path.join(self.sink.out_dir, "manifest.json")
        payload = {
            "status": report.status,
            "tenant": self.sink.tenant,
            "run_id": self.sink.run_id,
            "filtered_row_outcome": self.sink.filtered_row_outcome,
            "rows_total": report.rows_total,
            "rows_clean": report.rows_clean,
            "rows_quarantined": report.rows_quarantined,
            "bytes_raw": report.bytes_raw,
            "bytes_encoded": report.bytes_encoded,
            "constraints": report.constraints,
            "unsupported": report.unsupported,
            "clean": self._paths.get("clean", ""),
            "quarantine": self._paths.get("quarantine", ""),
            **extra,
        }
        blob = json.dumps(payload, indent=2, default=str).encode()
        # durable and atomic (temp, fsync, rename): a crash in finalize
        # never leaves a torn manifest
        storage_for(self.sink.out_dir).write_bytes("manifest.json", blob, durable=True)
        self.seconds["manifest"] += time.perf_counter() - t0
        return path
