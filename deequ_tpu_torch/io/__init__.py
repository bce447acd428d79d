"""Byte storage and state providers (counterpart of ``deequ_tpu/io``)."""

from deequ_tpu_torch.io.state_provider import (
    FileSystemStateProvider,
    InMemoryStateProvider,
    StateLoader,
    StatePersister,
)
from deequ_tpu_torch.io.storage import (
    LocalStorage,
    MemoryStorage,
    Storage,
    register_storage_scheme,
    storage_for,
)

__all__ = [
    "FileSystemStateProvider",
    "InMemoryStateProvider",
    "LocalStorage",
    "MemoryStorage",
    "StateLoader",
    "StatePersister",
    "Storage",
    "register_storage_scheme",
    "storage_for",
]
