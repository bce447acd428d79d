"""Pluggable byte storage for state providers and metric repositories.

Counterpart of ``deequ_tpu/io/storage.py``: a minimal :class:`Storage`
protocol (writes with atomic visibility, reads, listing) and a registry
of URI schemes, so ``FileSystemStateProvider("s3://bucket/states")``
routes through whatever backend a deployment registers, while plain
local paths use the filesystem directly.

Backends in this package:

- ``LocalStorage`` — plain paths and ``file://``; a write goes to a
  temporary file and is published with ``os.replace``;
- ``MemoryStorage`` (``mem://``) — an in-process dict, one namespace a
  URI. Its namespaces are this package's own: a ``mem://`` name here and
  the same name in the JAX package are two stores.

A deployment registers a cloud backend in a few lines::

    from deequ_tpu_torch.io.storage import Storage, register_storage_scheme

    class S3Storage(Storage):
        def __init__(self, uri): ...  # boto3 client
        ...

    register_storage_scheme("s3", S3Storage)
"""

from __future__ import annotations

import contextlib
import os
import threading
from typing import Callable, Dict, Iterator, List, Optional


class Storage:
    """Byte blobs under a base location. Keys are '/'-relative names
    (no scheme). ``write_bytes`` must give atomic VISIBILITY: a
    concurrent ``read_bytes`` or ``list_keys`` sees the whole blob or
    nothing. ``durable=True`` also asks for crash DURABILITY (the blob
    survives power loss once the call returns: an fsync on local
    disks); a backend with no stronger guarantee may ignore it."""

    def read_bytes(self, key: str) -> Optional[bytes]:
        raise NotImplementedError

    def write_bytes(self, key: str, data: bytes, durable: bool = False) -> None:
        raise NotImplementedError

    def list_keys(self, prefix: str = "") -> List[str]:
        raise NotImplementedError

    def exists(self, key: str) -> bool:
        return self.read_bytes(key) is not None

    def delete(self, key: str) -> None:
        """Remove a blob; deleting a missing key is a no-op."""
        raise NotImplementedError


def _fsync_directory(path: str) -> None:
    """fsync a directory so that a rename inside it survives a crash.
    Some filesystems refuse to fsync a directory opened read-only: that
    is as durable as such a filesystem gets, not an error."""
    try:
        fd = os.open(path or ".", os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
    except OSError:
        pass


class LocalStorage(Storage):
    """A plain directory (the default)."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _full(self, key: str) -> str:
        return os.path.join(self.root, *key.split("/"))

    def read_bytes(self, key: str) -> Optional[bytes]:
        try:
            with open(self._full(key), "rb") as fh:
                return fh.read()
        except FileNotFoundError:
            return None

    def write_bytes(self, key: str, data: bytes, durable: bool = False) -> None:
        full = self._full(key)
        os.makedirs(os.path.dirname(full), exist_ok=True)
        tmp = f"{full}.tmp.{os.getpid()}.{threading.get_ident()}"
        try:
            with open(tmp, "wb") as fh:
                fh.write(data)
                if durable:
                    # the rename orders only metadata: without an fsync
                    # of the data first, a crash can leave the new name
                    # on an empty file
                    fh.flush()
                    os.fsync(fh.fileno())
            os.replace(tmp, full)  # atomic visibility
            if durable:
                _fsync_directory(os.path.dirname(full))
        finally:
            if os.path.exists(tmp):  # a failed write leaves no orphan
                os.unlink(tmp)

    def list_keys(self, prefix: str = "") -> List[str]:
        # walk only the subtree the prefix's directory part names
        base = self.root
        if "/" in prefix:
            base = os.path.join(self.root, *prefix.rsplit("/", 1)[0].split("/"))
            if not os.path.isdir(base):
                return []
        out = []
        for dirpath, _dirs, files in os.walk(base):
            for name in files:
                rel = os.path.relpath(os.path.join(dirpath, name), self.root).replace(os.sep, "/")
                # skip this class's in-flight temporaries
                if ".tmp." in rel or rel.endswith(".tmp"):
                    continue
                if rel.startswith(prefix):
                    out.append(rel)
        return sorted(out)

    def exists(self, key: str) -> bool:
        return os.path.exists(self._full(key))

    def delete(self, key: str) -> None:
        try:
            os.unlink(self._full(key))
        except FileNotFoundError:
            pass


def durable_replace(tmp_path: str, final_path: str) -> None:
    """Publish ``tmp_path`` (a fully written file) as ``final_path``,
    atomically and durably: fsync the data, rename, fsync the parent
    directory — ``LocalStorage.write_bytes(durable=True)``'s discipline
    for a caller that streams a file to disk."""
    with open(tmp_path, "rb+") as fh:
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp_path, final_path)
    _fsync_directory(os.path.dirname(final_path))


class MemoryStorage(Storage):
    """In-process storage (``mem://name``): one shared namespace a URI,
    thread-safe."""

    _spaces: Dict[str, Dict[str, bytes]] = {}
    _lock = threading.Lock()

    def __init__(self, uri: str):
        name = uri.split("://", 1)[1]
        with MemoryStorage._lock:
            self._blobs = MemoryStorage._spaces.setdefault(name, {})

    def read_bytes(self, key: str) -> Optional[bytes]:
        with MemoryStorage._lock:
            return self._blobs.get(key)

    def write_bytes(self, key: str, data: bytes, durable: bool = False) -> None:
        del durable  # process memory: no stronger guarantee exists
        with MemoryStorage._lock:
            self._blobs[key] = bytes(data)

    def list_keys(self, prefix: str = "") -> List[str]:
        with MemoryStorage._lock:
            return sorted(k for k in self._blobs if k.startswith(prefix))

    def exists(self, key: str) -> bool:
        with MemoryStorage._lock:
            return key in self._blobs

    def delete(self, key: str) -> None:
        with MemoryStorage._lock:
            self._blobs.pop(key, None)


_SCHEMES: Dict[str, Callable[[str], Storage]] = {}


def register_storage_scheme(scheme: str, factory: Callable[[str], Storage]) -> None:
    """Register ``factory(uri) -> Storage`` for ``scheme://`` URIs."""
    _SCHEMES[scheme.lower()] = factory


register_storage_scheme("mem", MemoryStorage)
register_storage_scheme("file", lambda uri: LocalStorage(uri.split("://", 1)[1]))


@contextlib.contextmanager
def interprocess_lock(path: str) -> Iterator[None]:
    """A cross-process advisory lock: ``fcntl.flock`` on a sidecar lock
    file, held until the block exits (the kernel drops it with the fd if
    the process dies). Without ``fcntl`` (Windows) it does nothing, and
    the caller's in-process lock is the only guarantee."""
    try:
        import fcntl
    except ImportError:  # pragma: no cover — non-POSIX
        yield
        return
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o644)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(fd, fcntl.LOCK_UN)
    finally:
        os.close(fd)


# serializes compare_and_swap on backends with no filesystem to flock
# (MemoryStorage): a process-wide lock is the scope a mem:// namespace has
_cas_memory_lock = threading.Lock()


def compare_and_swap(
    path_or_uri: str, key: str, expected: Optional[bytes], new: bytes
) -> bool:
    """Publish ``new`` under ``key`` only if the blob holds exactly
    ``expected`` now (``None``: the key must not exist); returns whether
    the swap won. Local storage serializes through an
    ``interprocess_lock`` on ``<root>/.cas.lock``, memory storage on a
    process-wide lock. The winning write is durable."""
    storage = storage_for(path_or_uri)
    if isinstance(storage, LocalStorage):
        lock_ctx = interprocess_lock(os.path.join(storage.root, ".cas.lock"))
    else:
        lock_ctx = _cas_memory_lock
    with lock_ctx:
        if storage.read_bytes(key) != expected:
            return False
        storage.write_bytes(key, new, durable=True)
        return True


def storage_for(path_or_uri: str) -> Storage:
    """The backend of a path or URI: plain paths are ``LocalStorage``;
    ``scheme://`` URIs go through the registry, and an unregistered
    scheme raises."""
    if "://" in path_or_uri:
        scheme = path_or_uri.split("://", 1)[0].lower()
        factory = _SCHEMES.get(scheme)
        if factory is None:
            raise ValueError(
                f"no storage backend registered for {scheme}://; register one "
                "with deequ_tpu_torch.io.storage.register_storage_scheme"
            )
        return factory(path_or_uri)
    return LocalStorage(path_or_uri)
