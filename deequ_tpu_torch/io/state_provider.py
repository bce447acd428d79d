"""State persistence: the incremental path's loaders and persisters.

Counterpart of ``deequ_tpu/io/state_provider.py`` (its ``StateLoader``,
``StatePersister``, ``InMemoryStateProvider`` and
``FileSystemStateProvider``). Every state is a mergeable monoid, so
persisted states give append-only datasets checked a partition at a
time, partitions computed apart and merged later, and metrics over all
of them without a re-scan (``AnalysisRunner.run_on_aggregated_states``).

The files are the JAX package's, byte for byte for equal states: one
``state-<sha1(repr(analyzer))[:16]>.npz`` a state, written by
``numpy.savez`` from the arrays of ``interop.states_to_numpy``
(``__type__``, ``__version__`` and the fields; a KLL sketch's
``to_arrays``; a frequency state's JSON columns and keys with its
counts), and an ``index.json`` from each analyzer's repr to its file.
The two packages' analyzer reprs agree, so a state saved by either
loads and merges in the other.

:class:`ScanCheckpointer` keeps a scan's whole carried state MID-SCAN,
with a :class:`ScanCursor`, so an interrupted scan resumes where it
stopped. Its blobs are the port's own: a blob the JAX package wrote
loads as None here (the scan then starts fresh), and the JAX package
does not read the port's. State files stay readable by both.
"""

from __future__ import annotations

import hashlib
import io
import json
import pickle
import threading
from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np

from deequ_tpu_torch.analyzers.base import Analyzer
from deequ_tpu_torch.interop import states_from_numpy, states_to_numpy
from deequ_tpu_torch.io.storage import storage_for


class StateLoader:
    def load(self, analyzer: Analyzer) -> Optional[Any]:
        raise NotImplementedError


class StatePersister:
    def persist(self, analyzer: Analyzer, state: Any) -> None:
        raise NotImplementedError


class InMemoryStateProvider(StateLoader, StatePersister):
    """A thread-safe in-process store, keyed by the analyzer's repr."""

    def __init__(self) -> None:
        self._states: Dict[str, Any] = {}
        self._lock = threading.Lock()

    def load(self, analyzer: Analyzer) -> Optional[Any]:
        with self._lock:
            return self._states.get(repr(analyzer))

    def persist(self, analyzer: Analyzer, state: Any) -> None:
        with self._lock:
            self._states[repr(analyzer)] = state

    def __repr__(self) -> str:
        return f"InMemoryStateProvider({len(self._states)} states)"


class MeshStatePersister(StatePersister):
    """Writes a mesh run's states once: every rank holds the same
    merged states, so rank 0 alone persists them through ``inner``. A
    state whose groups live on the ranks (``analyzers/spill.py::
    ShardedDeviceFrequencies``) is gathered by EVERY rank first (its
    gather is a collective), and every rank learns whether the write
    succeeded, so a failed write fails the analyzer on every rank."""

    def __init__(self, inner: StatePersister, ctx):
        self.inner = inner
        self.ctx = ctx

    def persist(self, analyzer: Analyzer, state: Any) -> None:
        from deequ_tpu_torch.analyzers.spill import ShardedDeviceFrequencies

        error = None
        try:
            if isinstance(state, ShardedDeviceFrequencies):
                state.keys  # the collective gather, on every rank
            if self.ctx.rank == 0:
                self.inner.persist(analyzer, state)
        except Exception as exc:  # noqa: BLE001 — raised on every rank below
            error = exc
        self.ctx.sync("persist", None, error)

    def __repr__(self) -> str:
        return f"MeshStatePersister({self.inner!r}, rank {self.ctx.rank} of {self.ctx.world})"


def state_key(analyzer: Analyzer) -> str:
    """The file a state of ``analyzer`` is kept in."""
    digest = hashlib.sha1(repr(analyzer).encode()).hexdigest()[:16]
    return f"state-{digest}.npz"


class FileSystemStateProvider(StateLoader, StatePersister):
    """States as ``.npz`` files in a directory, or under a storage URI
    (``io/storage.py``: ``mem://`` in this package, other schemes once a
    deployment registers them). Loaded states are host tensors; the
    runner merges them with its own fetched states."""

    def __init__(self, path: str, allow_overwrite: bool = True):
        self._path = path
        self._allow_overwrite = allow_overwrite
        self._storage = storage_for(path)

    def _update_index(self, analyzer: Analyzer, key: str) -> None:
        index: Dict[str, str] = {}
        raw = self._storage.read_bytes("index.json")
        if raw is not None:
            index = json.loads(raw.decode())
        index[repr(analyzer)] = key
        self._storage.write_bytes("index.json", json.dumps(index, indent=2).encode())

    def persist(self, analyzer: Analyzer, state: Any) -> None:
        key = state_key(analyzer)
        if not self._allow_overwrite and self._storage.exists(key):
            raise FileExistsError(f"{self._path}/{key}")
        buf = io.BytesIO()
        np.savez(buf, **states_to_numpy(state))
        self._storage.write_bytes(key, buf.getvalue())
        self._update_index(analyzer, key)

    def load(self, analyzer: Analyzer) -> Optional[Any]:
        raw = self._storage.read_bytes(state_key(analyzer))
        if raw is None:
            return None
        with np.load(io.BytesIO(raw), allow_pickle=False) as data:
            return states_from_numpy(str(data["__type__"]), data)


@dataclass(frozen=True)
class EgressCursor:
    """The durable high-water mark of a run's row-level egress at one
    checkpoint (``egress/writer.py``). It is made only after the span
    segment it names was fsync'd and renamed into place (flush, then
    cursor), so a resume that trusts it replays no row and drops none.

    ``last_durably_flushed_span_seq`` is the sequence number of the
    newest ``spans/seg-*.parquet`` segment on disk (-1 when none, as in
    the scan phase of a spooled run); ``plane_spool_offset`` the
    fsync'd byte length of ``_scan_bits.spool`` (0 outside spool mode).
    The row and byte counters restore the writer's accounting, so a
    resumed run reports what an uninterrupted one does."""

    last_durably_flushed_span_seq: int
    rows_emitted_clean: int
    rows_emitted_quarantined: int
    plane_spool_offset: int
    bytes_raw: int = 0
    bytes_encoded: int = 0


@dataclass(frozen=True)
class ScanCursor:
    """Where a checkpoint sits in a scan: ``batch_index`` batches are
    folded into (or quarantined from) the saved states, so a resume
    starts there; ``row_offset`` is the source-row high-water mark; the
    fingerprint pins the SOURCE (a changed source invalidates the
    checkpoint); ``batch_size`` the nominal batch geometry. A run with a
    row-level sink also carries the sink's :class:`EgressCursor`, written
    only after the span segment it names is durable."""

    batch_index: int
    row_offset: int
    source_fingerprint: str
    batch_size: int
    egress: Optional[EgressCursor] = None


class _PortUnpickler(pickle.Unpickler):
    """Refuses every class of the JAX package, so that its checkpoint
    blob fails to load (and never imports it)."""

    def find_class(self, module: str, name: str):
        if module == "deequ_tpu" or module.startswith(("deequ_tpu.", "jax")):
            raise pickle.UnpicklingError(f"not a deequ_tpu_torch checkpoint: {module}.{name}")
        return super().find_class(module, name)


class ScanCheckpointer:
    """Periodic whole-scan checkpoints of the fused scan.

    Where :class:`FileSystemStateProvider` keeps one FINAL state an
    analyzer, the checkpointer keeps the engine's whole carried state
    tuple every ``every_batches`` batches (``config.checkpoint_every_
    batches`` when None), with a :class:`ScanCursor` and the scan's
    degradation record. Pending host folds are drained before each
    save, so a resumed run folds the rest in the same order and ends
    bit-equal to an uninterrupted one.

    Storage goes through ``io/storage.py`` (paths, ``file://``,
    ``mem://``, registered schemes); a local write is fsync'd and
    renamed into place, so a kill mid-save leaves the previous
    checkpoint whole. The payload is a pickle of host (numpy) trees,
    keyed by a PLAN TOKEN (a digest of the states' structure, shapes and
    dtypes, the batch size and the mode), so a checkpoint restores only
    into the plan that wrote it and plans can share a directory."""

    VERSION = 1
    PACKAGE = "deequ_tpu_torch"

    def __init__(self, path: str, every_batches: Optional[int] = None):
        self._path = path
        self._storage = storage_for(path)
        self.every_batches = every_batches

    def _key(self, plan_token: str) -> str:
        return f"scan-ckpt-{plan_token}.pkl"

    def interval(self) -> int:
        """Batches between checkpoints (<= 0 disables)."""
        if self.every_batches is not None:
            return int(self.every_batches)
        from deequ_tpu_torch import config

        return int(config.options().checkpoint_every_batches)

    def save(self, cursor: ScanCursor, plan_token: str, states: Any,
             host_accs: Dict[int, Any], degradation: Any) -> int:
        """Write one checkpoint durably; returns its bytes."""
        blob = pickle.dumps({
            "version": self.VERSION,
            "package": self.PACKAGE,
            "cursor": cursor,
            "plan_token": plan_token,
            "states": states,  # host (numpy) trees
            "host_accs": host_accs,
            "degradation": degradation,
        }, protocol=pickle.HIGHEST_PROTOCOL)
        key = self._key(plan_token)
        try:
            # a checkpoint exists to survive a crash: ask for an fsync
            self._storage.write_bytes(key, blob, durable=True)
        except TypeError:  # a custom Storage without ``durable=``
            self._storage.write_bytes(key, blob)
        return len(blob)

    def load(self, source_fingerprint: str, plan_token: str) -> Optional[Dict[str, Any]]:
        """The latest checkpoint of this (source, plan), or None: none
        there, another source or plan, a corrupt blob (a partial write
        of a crashed process), or a blob of another package."""
        raw = self._storage.read_bytes(self._key(plan_token))
        if raw is None:
            return None
        try:
            payload = _PortUnpickler(io.BytesIO(raw)).load()
        except Exception:  # noqa: BLE001 — a blob we cannot read is no checkpoint
            return None
        if (not isinstance(payload, dict) or payload.get("version") != self.VERSION
                or payload.get("package") != self.PACKAGE):
            return None
        cursor = payload.get("cursor")
        if (not isinstance(cursor, ScanCursor)
                or cursor.source_fingerprint != source_fingerprint
                or payload.get("plan_token") != plan_token):
            return None
        return payload

    def clear(self, plan_token: Optional[str] = None) -> None:
        """Drop the checkpoint of ``plan_token``, or every scan
        checkpoint under the path (a finished scan leaves no cursor to
        resume into)."""
        if plan_token is not None:
            self._storage.delete(self._key(plan_token))
            return
        for key in self._storage.list_keys("scan-ckpt-"):
            self._storage.delete(key)

    def __repr__(self) -> str:
        return f"ScanCheckpointer({self._path!r})"
