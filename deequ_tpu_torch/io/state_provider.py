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
"""

from __future__ import annotations

import hashlib
import io
import json
import threading
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
