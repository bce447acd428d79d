"""Per-column wire codecs for the streamed scan.

Counterpart of ``deequ_tpu/engine/wire.py``, making the same decisions
and the same encoded bytes. A streamed scan copies every batch from the
host, so each byte not shipped is copy time saved. This module decides,
ONCE per run, a wire dtype narrower than a column's canonical dtype
wherever the data allows it:

- int64/int32/int16 values -> the narrowest signed int covering the
  column's range, from ``Dataset.integral_range`` where it has one, else
  from a probe of the first batch;
- float64 values -> float32 when the first batch shows that every value
  round-trips bit for bit (compared on integer views, so NaN payloads,
  signed zeros and subnormals count); lossy columns stay float64;
- dictionary codes and utf8 lengths -> the first batch's probe.

The engine casts each column back to its canonical dtype on the device
(``engine/scan.py``), so every update sees the dtypes a resident scan
sees, and the results are the same with codecs on or off.

Every non-identity codec is guarded on EVERY batch (a min/max, or the
bitwise round trip). A batch that does not fit raises
:class:`CodecViolation` on the packing thread; the packer widens the
table (:meth:`CodecTable.widen`, a version bump) and packs the SAME
batch again under the new widths, so a violation costs one re-pack,
never a wrong metric.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np

__all__ = [
    "CodecViolation",
    "ColumnCodec",
    "CodecTable",
    "narrowest_int_dtype",
    "resolve_codecs",
]

_SIGNED_STEPS = (np.dtype(np.int8), np.dtype(np.int16), np.dtype(np.int32), np.dtype(np.int64))


def narrowest_int_dtype(lo: int, hi: int) -> np.dtype:
    """The narrowest SIGNED integer dtype covering [lo, hi]."""
    for dt in _SIGNED_STEPS:
        info = np.iinfo(dt)
        if lo >= info.min and hi <= info.max:
            return dt
    return np.dtype(np.int64)


class CodecViolation(Exception):
    """A batch's values do not fit the resolved wire dtype; the packer
    answers with :meth:`CodecTable.widen` and a re-pack."""

    def __init__(self, key: str, required: np.dtype):
        super().__init__(
            f"wire codec for {key!r} violated: batch requires {np.dtype(required).name}"
        )
        self.key = key
        self.required = np.dtype(required)


@dataclass
class ColumnCodec:
    """One wire key's codec: ``canonical`` is the dtype the updates
    see, ``wire`` the dtype that ships (None until the first batch's
    probe decides); ``origin`` says how the width was chosen ("stats" or
    "probe")."""

    key: str
    canonical: np.dtype
    wire: Optional[np.dtype]
    origin: str

    @property
    def active(self) -> bool:
        return self.wire is not None and self.wire != self.canonical


@dataclass
class CodecTable:
    """The run's codecs, versioned: ``widen`` bumps ``version``, and a
    batch is unpacked with the layout of the version it was packed
    under."""

    codecs: Dict[str, ColumnCodec] = field(default_factory=dict)
    version: int = 0
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def codec(self, key: str) -> Optional[ColumnCodec]:
        return self.codecs.get(key)

    def token(self) -> tuple:
        """A hashable fingerprint of the table and its version."""
        return (
            self.version,
            tuple(
                (k, c.canonical.name, None if c.wire is None else c.wire.name)
                for k, c in sorted(self.codecs.items())
            ),
        )

    def encode(self, key: str, values: np.ndarray) -> np.ndarray:
        """One column's batch for the wire (itself when it has no
        codec). Resolves a deferred probe on first sight; raises
        :class:`CodecViolation` when a guarded batch does not fit."""
        codec = self.codecs.get(key)
        if codec is None:
            return values
        wire = codec.wire
        if wire is None:
            wire = self._resolve_probe(codec, values)
        if wire == codec.canonical:
            return values
        if wire.kind == "i":
            if values.size:
                lo, hi = int(values.min()), int(values.max())
                info = np.iinfo(wire)
                if lo < info.min or hi > info.max:
                    raise CodecViolation(key, narrowest_int_dtype(lo, hi))
            return values.astype(wire)
        # a float32 wire for a float64 column: every value must round-trip
        # bit for bit (integer views: NaN payloads and signed zeros count)
        enc = values.astype(wire)
        if not np.array_equal(enc.astype(codec.canonical).view(np.int64), values.view(np.int64)):
            raise CodecViolation(key, codec.canonical)
        return enc

    def _resolve_probe(self, codec: ColumnCodec, values: np.ndarray) -> np.dtype:
        """The first batch's probe: the wire dtype from its values (later
        batches are guarded, and a violation widens)."""
        if codec.canonical.kind == "i":
            if values.size:
                wire = narrowest_int_dtype(int(values.min()), int(values.max()))
            else:
                wire = np.dtype(np.int8)
            if wire.itemsize >= codec.canonical.itemsize:
                wire = codec.canonical
        else:
            enc = values.astype(np.float32)
            exact = np.array_equal(enc.astype(np.float64).view(np.int64), values.view(np.int64))
            wire = np.dtype(np.float32) if exact else codec.canonical
        with self._lock:
            if codec.wire is None:
                # resolution completes the table: no version bump
                codec.wire = wire
        return codec.wire

    def widen(self, key: str, required: np.dtype) -> None:
        """Widen a codec to cover ``required`` (and what it carried
        before), and bump the version."""
        with self._lock:
            codec = self.codecs[key]
            old = codec.wire
            new = np.dtype(required)
            if old is not None and old.kind == "i" and new.kind == "i":
                new = np.promote_types(old, new)
            if new.itemsize >= codec.canonical.itemsize:
                new = codec.canonical
            codec.wire = new
            self.version += 1
        from deequ_tpu_torch.telemetry import get_telemetry

        get_telemetry().event("wire_codec_widened", key=key,
                              wire_from=None if old is None else old.name, wire_to=new.name,
                              origin=codec.origin)

    def raw_bytes_of(self, key: str, encoded: np.ndarray) -> int:
        """What this column's batch would ship at its canonical width."""
        codec = self.codecs.get(key)
        if codec is None or codec.wire is None:
            return encoded.nbytes
        return encoded.size * codec.canonical.itemsize


def resolve_codecs(dataset, requests, enabled: bool) -> CodecTable:
    """The run's codec table from the dataset's metadata (integral
    ranges) and deferred first-batch probes; reads no batch. Disabled,
    or for columns that are no candidates, the table is empty and every
    column ships at its canonical width."""
    table = CodecTable()
    if not enabled:
        return table
    seen = set()
    for req in requests:
        key = req.key
        if key in seen or req.repr in ("mask", "bits"):
            continue
        seen.add(key)
        canonical = np.dtype(dataset.request_dtype(req))
        if canonical.kind == "i" and canonical.itemsize > 1:
            wire: Optional[np.dtype] = None
            origin = "probe"
            if req.repr == "values":
                rng = dataset.integral_range(req.column)
                if rng is not None:
                    wire = narrowest_int_dtype(int(rng[0]), int(rng[1]))
                    origin = "stats"
                    if wire.itemsize >= canonical.itemsize:
                        continue  # the range allows no narrowing: no codec
            table.codecs[key] = ColumnCodec(key, canonical, wire, origin)
        elif canonical == np.float64 and req.repr == "values":
            table.codecs[key] = ColumnCodec(key, canonical, None, "probe")
    return table
