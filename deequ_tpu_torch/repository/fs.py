"""Filesystem metrics repository: one JSON file of all results.

Counterpart of ``deequ_tpu/repository/fs.py``. A plain path is a local
file; a ``scheme://root/key`` URI goes through the storage registry
(``io/storage.py``). Writers in one process serialize on a lock, and
on local storage also across processes on an ``fcntl.flock`` of a
sidecar ``<file>.lock``, since a save is a read-modify-write of the
whole file; the file is replaced with atomic visibility. The JSON is
``repository/serde.py``'s, the JAX package's byte for byte, so either
package reads the other's file.
"""

from __future__ import annotations

import contextlib
import os
import threading
from typing import List, Optional

from deequ_tpu_torch.io.storage import LocalStorage, interprocess_lock, storage_for
from deequ_tpu_torch.repository import base, serde
from deequ_tpu_torch.repository.base import (
    AnalysisResult,
    MetricsRepository,
    MetricsRepositoryMultipleResultsLoader,
    ResultKey,
)


class FileSystemMetricsRepository(MetricsRepository):
    def __init__(self, path: str):
        self._path = path
        self._lock = threading.Lock()
        if "://" in path:
            # the final segment is the blob key, the rest the storage root
            root, _, self._key = path.rpartition("/")
            if "://" not in root or root.endswith("//") or not self._key:
                raise ValueError(
                    "a URI repository path needs at least scheme://root/key "
                    f"(the final segment is the blob name): got {path!r}"
                )
            self._storage = storage_for(root)
        else:
            parent = os.path.dirname(os.path.abspath(path)) or "."
            self._key = os.path.basename(path)
            if not self._key:
                raise ValueError(
                    f"a repository path must name a file, not a directory: got {path!r}"
                )
            self._storage = storage_for(parent)

    @contextlib.contextmanager
    def _process_lock(self):
        """The cross-process flock on local storage; a remote backend
        relies on its own consistency model."""
        if isinstance(self._storage, LocalStorage):
            with interprocess_lock(os.path.join(self._storage.root, self._key + ".lock")):
                yield
        else:
            yield

    def _read_all(self) -> List[AnalysisResult]:
        raw = self._storage.read_bytes(self._key)
        if raw is None:
            return []
        try:
            text = raw.decode()
            if not text.strip():
                return []
            return serde.deserialize(text)
        except Exception:  # noqa: BLE001 — a partial or corrupt file
            # (a kill mid-write on a backend without atomic replace)
            # reads as empty; the next save rewrites it
            from deequ_tpu_torch.telemetry import get_telemetry

            tm = get_telemetry()
            tm.counter("repository.corrupt_files").inc()
            tm.event("repository_corrupt_file", path=self._path)
            return []

    def _write_all(self, results: List[AnalysisResult]) -> None:
        self._storage.write_bytes(self._key, serde.serialize(results).encode())

    def save(self, result: AnalysisResult) -> None:
        base._bump("repository.saves")
        with self._lock, self._process_lock():
            results = [r for r in self._read_all() if r.result_key != result.result_key]
            results.append(result)
            self._write_all(results)

    def load_by_key(self, key: ResultKey) -> Optional[AnalysisResult]:
        base._bump("repository.loads")
        with self._lock, self._process_lock():
            for result in self._read_all():
                if result.result_key == key:
                    return result
        return None

    def load(self) -> MetricsRepositoryMultipleResultsLoader:
        base._bump("repository.loads")
        with self._lock, self._process_lock():
            return MetricsRepositoryMultipleResultsLoader(self._read_all())
