"""Columnar dataset: numpy on the host, resident torch tensors on the device.

Counterpart of ``deequ_tpu/data/table.py``. A :class:`Dataset` holds one
host column per name and hands the engine *device representations* of
them:

- ``values`` — numeric payload (nulls zero-filled; see mask); booleans
               as int32, float16 widened to float32, unsigned ints up to
               32 bits widened to int64, uint64 as float64 (torch has no
               uint64 arithmetic; the JAX package converts the unsigned
               value to float64 for sums and extrema too); a null-typed
               column as all-masked int64 zeros
- ``bits``   — the int64 bit view of a uint64 column: what the HLL hash
               reads (its registers are those of the JAX package, which
               hashes the raw 64 bits); other columns have none
- ``mask``   — validity as bool (True = non-null)
- ``codes``  — int32 dictionary codes (-1 = null), with the dictionary
               kept on the host: strings never reach the device. A
               numeric, boolean or timestamp column gets codes too, built
               at first request for the grouping analyzers: its
               dictionary is its distinct values in first-seen order
               (float keys normalised first, as the JAX package's are),
               cached once a column
- ``lengths`` — int32 utf8 lengths of a string column (0 for null),
               gathered on the device from the resident codes through a
               per-dictionary-entry table, so no per-row bytes cross
               for them

A resident scan (``device_batches``) moves each requested
representation to the device ONCE and keeps it there; batches are views
(slices) of the resident columns, so a scan copies nothing per batch.
The mask of a column with no nulls is not copied: its batches use the
row mask. The last batch is simply shorter: PyTorch needs no fixed
shapes, so there is no zero padding, and ``ROW_MASK`` marks every row
of a batch as live. :meth:`Dataset.estimated_device_bytes` counts what
a resident scan keeps on the device, and the engine streams a scan that
does not fit its budget: ``host_batches`` then hands it host slices,
which ``engine/wire.py`` packs and the engine copies batch by batch.

The budget ``config.device_cache_bytes`` holds across datasets, as in
the JAX package (one card, one device memory): a process-wide ledger
keeps every dataset that holds resident columns, least recently scanned
first, by weak reference, with the bytes each holds (the port's own
widths, as ``estimated_device_bytes`` counts them). Before a resident
scan copies columns, ``device_batches`` evicts other datasets' device
caches in that order, then this one's, until the copy fits
(``Dataset.global_device_cache_bytes``, ``Dataset.clear_device_cache``).
A view (``select``, ``filter_rows``, ``slice_rows``, ``row_share``)
copies its own columns and keeps its own entry, so evicting it frees no
tensor its parent holds.

Column types are read as the JAX package reads them: decimals as
FRACTIONAL float64 values (each the double nearest its decimal), and
binary, string-view, list, struct, time and duration columns as Kind
UNKNOWN, carried with their masks (and, where their values are hashable,
a first-seen dictionary of them). A table read by ``from_arrow`` keeps
each column's source array and field, and its schema metadata: ``table``
and ``record_batches`` hand them back, as the JAX package hands back its
table. ``pyarrow`` is imported only inside the Arrow-boundary functions
(``_arrow_column``, ``from_pandas``, ``_arrow_table``) and by the parquet
source (``data/parquet.py``, ``Dataset.from_parquet``).
"""

from __future__ import annotations

import enum
import hashlib
import itertools
import threading
import weakref
from collections import OrderedDict, deque
from dataclasses import dataclass
from datetime import date, datetime, timedelta, timezone
from decimal import Decimal
from typing import Dict, Iterator, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

ROW_MASK = "__row_mask__"


# -- host -> device transfer accounting ---------------------------------
# The tally is the telemetry counter "transfer.bytes" (always on, as in
# the JAX package): the bytes a resident scan copies when a column first
# goes to the device, and each streamed batch's packed bytes. Looked up
# per call, so a registry reset never detaches it.
def add_transfer_bytes(n: int) -> None:
    from deequ_tpu_torch.telemetry import get_telemetry

    get_telemetry().counter("transfer.bytes").inc(int(n))


def transfer_bytes() -> int:
    """Total bytes copied host -> device by the data layer so far
    (monotonic: snapshot it around a run)."""
    from deequ_tpu_torch.telemetry import get_telemetry

    return get_telemetry().counter("transfer.bytes").value


class _DeviceCacheLedger:
    """The datasets holding resident device columns, least recently
    scanned first, by weak reference, with the bytes each holds: the
    process-wide account that ``config.device_cache_bytes`` bounds.

    A collected dataset's finalizer only queues its key (``forget``):
    the garbage collector may run it inside a locked section of this
    ledger, on the same thread, where taking the lock would deadlock and
    changing the maps would break an iteration. Every locked section
    first drops the queued keys."""

    def __init__(self):
        self._lock = threading.Lock()
        self._order: "OrderedDict[int, weakref.ref]" = OrderedDict()
        self._bytes: Dict[int, int] = {}
        self._collected: deque = deque()

    def forget(self, key: int) -> None:
        self._collected.append(key)

    def _reap(self) -> None:
        while self._collected:
            key = self._collected.popleft()
            self._order.pop(key, None)
            self._bytes.pop(key, None)

    def total(self) -> int:
        with self._lock:
            self._reap()
            return sum(self._bytes.values())

    def bytes_of(self, key: int) -> int:
        with self._lock:
            self._reap()
            return self._bytes.get(key, 0)

    def add(self, dataset: "Dataset", nbytes: int) -> None:
        key = dataset._cache_key
        with self._lock:
            self._reap()
            self._bytes[key] = self._bytes.get(key, 0) + int(nbytes)
            self._order.setdefault(key, weakref.ref(dataset))

    def touch(self, dataset: "Dataset") -> None:
        """``dataset`` becomes the most recently scanned."""
        key = dataset._cache_key
        with self._lock:
            self._reap()
            self._order.pop(key, None)
            self._order[key] = weakref.ref(dataset)

    def drop(self, key: int) -> None:
        with self._lock:
            self._reap()
            self._order.pop(key, None)
            self._bytes.pop(key, None)

    def lru(self) -> List[Tuple[int, "weakref.ref"]]:
        with self._lock:
            self._reap()
            return list(self._order.items())


_LEDGER = _DeviceCacheLedger()
_CACHE_KEYS = itertools.count()


# a streamed batch's host-only dictionary deltas (``data/parquet.py``):
# key DICT_DELTA_PREFIX + column -> {"start": int, "values": ndarray};
# never packed or copied, applied to the delta-carrying ops' states
DICT_DELTA_PREFIX = "__dict_delta__:"


class Kind(enum.Enum):
    """Logical column kinds (maps column types to analyzer preconditions)."""

    INTEGRAL = "Integral"
    FRACTIONAL = "Fractional"
    BOOLEAN = "Boolean"
    STRING = "String"
    TIMESTAMP = "Timestamp"
    UNKNOWN = "Unknown"

    @property
    def is_numeric(self) -> bool:
        return self in (Kind.INTEGRAL, Kind.FRACTIONAL, Kind.BOOLEAN)


@dataclass(frozen=True)
class Field:
    name: str
    kind: Kind


@dataclass(frozen=True)
class Schema:
    fields: Tuple[Field, ...]

    @property
    def column_names(self) -> List[str]:
        return [f.name for f in self.fields]

    def has_column(self, name: str) -> bool:
        return any(f.name == name for f in self.fields)

    def kind_of(self, name: str) -> Kind:
        for f in self.fields:
            if f.name == name:
                return f.kind
        raise KeyError(name)

    def __len__(self) -> int:
        return len(self.fields)


@dataclass(frozen=True)
class ColumnRequest:
    """A device representation request: (column, repr)."""

    column: str
    repr: str  # "values" | "mask" | "codes" | "lengths" | "bits"

    @property
    def key(self) -> str:
        return f"{self.column}::{self.repr}"


@dataclass(frozen=True)
class DictionaryColumn:
    """A dictionary-encoded string column: ``codes`` index ``dictionary``
    (unique strings, or None for Arrow's null entry), ``-1`` is null. Lets a caller hand over a column
    that is already encoded (a join against a dimension table, say)
    without building one Python string per row."""

    codes: np.ndarray
    dictionary: np.ndarray


@dataclass
class _Column:
    kind: Kind
    mask: np.ndarray  # bool, True = valid
    values: Optional[np.ndarray] = None  # numeric payload, nulls = 0
    codes: Optional[np.ndarray] = None  # int32, -1 = null (strings)
    bits: Optional[np.ndarray] = None  # int64 view of a uint64 column
    dictionary: Optional[np.ndarray] = None  # object array (strings)
    # storage unit of a timestamp/date column's int64 epochs: "s", "ms",
    # "us", "ns", "date32" (days) or "date64" (ms of a date)
    time_unit: Optional[str] = None
    # handed over dictionary-typed (an Arrow dictionary, or a
    # DictionaryColumn): the JAX package keeps such a column
    # dictionary-typed, so it probes no integral range of a decoded
    # numeric one, and a row filter keeps a string one's dictionary whole
    dictionary_encoded: bool = False
    # (min, max) of an integral column's valid values, once probed
    integral_range: Optional[Tuple[int, int]] = None
    range_probed: bool = False
    # no null row (None until asked)
    all_valid: Optional[bool] = None
    # the scale of a column read from decimals: its values are float64,
    # and its dictionary holds the decimals themselves, as the JAX
    # package's Arrow dictionary does
    decimal_scale: Optional[int] = None
    # the source's Arrow array and field, for a column read by
    # ``Dataset.from_arrow``: ``table`` and ``record_batches`` hand them
    # back (slices of them), as the JAX package hands back its table,
    # so that types numpy cannot hold (lists, structs, narrow and
    # unsigned integers, time zones, index widths) survive a split
    arrow: Optional[object] = None
    arrow_field: Optional[object] = None
    # an UNKNOWN-kind column of Arrow durations: the one such type whose
    # values the JAX package reads as numbers (float64), so its
    # row-level min/max and uniqueness answer (``check_row_level_repr``)
    duration: bool = False


def _writable(arr: np.ndarray) -> np.ndarray:
    arr = np.ascontiguousarray(arr)
    return arr if arr.flags.writeable else arr.copy()


_NUMPY_TIME_UNITS = {"D": "date32", "s": "s", "ms": "ms", "us": "us", "ns": "ns"}
# the numpy dtype of a timestamp dictionary, by storage unit (Arrow's
# ``to_numpy`` of the JAX package's dictionary)
_DATETIME = {
    "s": np.dtype("datetime64[s]"), "ms": np.dtype("datetime64[ms]"),
    "us": np.dtype("datetime64[us]"), "ns": np.dtype("datetime64[ns]"),
    "date32": np.dtype("datetime64[D]"), "date64": np.dtype("datetime64[ms]"),
}
_ENCODABLE = (Kind.INTEGRAL, Kind.FRACTIONAL, Kind.BOOLEAN, Kind.TIMESTAMP)
_EPOCH_ORDINAL = date(1970, 1, 1).toordinal()


def _time_unit(dtype: np.dtype) -> str:
    """The storage unit of a numpy datetime64 dtype, as Arrow names it
    (datetime64[D] converts to Arrow's date32)."""
    unit, count = np.datetime_data(dtype)
    if count != 1 or unit not in _NUMPY_TIME_UNITS:
        raise TypeError(f"unsupported datetime64 unit {dtype}")
    return _NUMPY_TIME_UNITS[unit]


def dictionary_utf8_lengths(dictionary: np.ndarray) -> np.ndarray:
    """utf8 lengths (code points) of dictionary entries, None -> 0,
    int32: computed once per DISTINCT value, not per row."""
    return np.array(
        [0 if v is None else len(v) for v in dictionary], dtype=np.int32
    )


def _lengths_table(dictionary: np.ndarray) -> np.ndarray:
    """The lengths gather table: slot 0 is the null slot (length 0),
    slot code + 1 the entry's length, so a gather at code + 1 serves
    null codes (-1) too."""
    return np.concatenate([[0], dictionary_utf8_lengths(dictionary)]).astype(np.int32)


def normalize_float_grouping_keys(values: np.ndarray) -> np.ndarray:
    """The grouping-key normalisation of float values (the JAX package's
    ``normalize_float_grouping_keys``, in numpy): every NaN payload
    becomes the one canonical NaN and -0.0 becomes +0.0; other dtypes
    pass through untouched."""
    if values.dtype.kind != "f":
        return values
    out = values + values.dtype.type(0.0)  # -0.0 + 0.0 == +0.0
    out[np.isnan(out)] = np.nan
    return out


def f64_canonical_u64_bits(values: np.ndarray) -> np.ndarray:
    """The u64 bits of float64 grouping keys: canonical NaN bits, -0.0
    as 0. The host twin of the float64 spill key
    (``analyzers/spill.py``), kept for the tests."""
    x = np.asarray(values, dtype=np.float64)
    bits = np.ascontiguousarray(x).view(np.uint64).copy()
    bits[np.isnan(x)] = np.uint64(0x7FF8000000000000)
    bits[bits == np.uint64(0x8000000000000000)] = np.uint64(0)
    return bits


def _first_seen_codes(values: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(int32 codes, distinct values in first-seen order) of a 1-D
    array of valid values: Arrow's ``dictionary_encode`` order."""
    n = len(values)
    if n == 0:
        return np.zeros(0, dtype=np.int32), values[:0]
    if values.dtype.kind in "iu":
        lo, hi = int(values.min()), int(values.max())
        span = hi - lo + 1
        if span <= max(2 * n, 1 << 16):
            return _first_seen_dense(values, lo, span)
    uniq, first, inverse = np.unique(
        values, return_index=True, return_inverse=True
    )
    order = np.argsort(first, kind="stable")
    rank = np.empty(len(uniq), dtype=np.int32)
    rank[order] = np.arange(len(uniq), dtype=np.int32)
    return rank[inverse.reshape(-1)], uniq[order]


def _first_seen_dense(values: np.ndarray, lo: int, span: int):
    """``_first_seen_codes`` of integers whose range is at most a few
    times their count: a direct-address table of first indices instead
    of a sort of every row."""
    n = len(values)
    off = (values.astype(np.int64) - lo).astype(np.intp)
    idx = np.arange(n, dtype=np.int64)
    first = np.full(span, n, dtype=np.int64)
    # written in reverse so the smallest index of a value is written
    # last; checked below, since numpy does not promise the order of
    # repeated writes
    first[off[::-1]] = idx[::-1]
    if not (first[off] <= idx).all():
        first = np.full(span, n, dtype=np.int64)
        np.minimum.at(first, off, idx)
    present = np.nonzero(first < n)[0]
    order = present[np.argsort(first[present], kind="stable")]
    lut = np.empty(span, dtype=np.int32)
    lut[order] = np.arange(len(order), dtype=np.int32)
    return lut[off], (order + lo).astype(values.dtype)


def _numeric_values(values: np.ndarray) -> Tuple[Kind, np.ndarray]:
    """(kind, device-ready values) for a numpy numeric/bool/datetime array."""
    dt = values.dtype
    if dt == np.bool_:
        return Kind.BOOLEAN, values.astype(np.int32)
    if dt.kind == "i":
        return Kind.INTEGRAL, values
    if dt.kind == "u":
        if dt.itemsize > 4:
            return Kind.INTEGRAL, values.astype(np.float64)
        return Kind.INTEGRAL, values.astype(np.int64)
    if dt.kind == "f":
        if dt == np.float16:
            return Kind.FRACTIONAL, values.astype(np.float32)
        return Kind.FRACTIONAL, values
    if dt.kind == "M":
        return Kind.TIMESTAMP, values.view(np.int64)
    raise TypeError(f"unsupported column dtype {dt}")


def _numeric_column(values: np.ndarray, mask: np.ndarray,
                    time_unit: Optional[str] = None) -> _Column:
    kind, data = _numeric_values(values)
    if time_unit is not None:
        kind = Kind.TIMESTAMP
    bits = values.view(np.int64) if values.dtype == np.uint64 else None
    return _Column(kind, mask, values=data, bits=bits, time_unit=time_unit)


def _null_column(mask: np.ndarray) -> _Column:
    """A column of Arrow's null type: no value is valid, so its
    ``values`` are all masked, and its codes all null over an empty
    dictionary (a Histogram's one ``NullValue`` bin, as in the JAX
    package)."""
    return _Column(Kind.UNKNOWN, mask, values=np.zeros(len(mask), dtype=np.int64),
                   codes=np.full(len(mask), -1, dtype=np.int32),
                   dictionary=np.empty(0, dtype=object))


def _decimal_dictionary(dictionary: np.ndarray, scale: int) -> np.ndarray:
    """The float64 distinct values of a decimal column as the decimals
    of that scale (the JAX package's dictionary holds Arrow's decimals,
    so a Histogram label reads "0.10"). Exact for every decimal of up to
    15 digits, which float64 round-trips."""
    from decimal import Decimal

    out = np.empty(len(dictionary), dtype=object)
    for i, v in enumerate(dictionary.tolist()):
        out[i] = Decimal(int(round(v * 10.0**scale))).scaleb(-scale)
    return out


def _encode_objects(values: Sequence) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """``_encode_strings`` for hashable Python values of any type (the
    values of an UNKNOWN-kind column); None when one is unhashable (a
    list or a struct), which then has no dictionary, as in the JAX
    package, whose Arrow cannot dictionary-encode it."""
    index: Dict[object, int] = {}
    codes = np.empty(len(values), dtype=np.int32)
    try:
        for i, v in enumerate(values):
            codes[i] = -1 if v is None else index.setdefault(v, len(index))
    except TypeError:
        return None
    dictionary = np.empty(len(index), dtype=object)
    for v, i in index.items():
        dictionary[i] = v
    return codes, dictionary


def _unknown_column(mask: np.ndarray, values: Optional[Sequence],
                    storage: Optional[np.ndarray] = None) -> _Column:
    """A column of a type no analyzer reads as numbers or strings (Kind
    UNKNOWN, as the JAX package maps binary, list, struct, time and
    duration types): its mask, its first-seen dictionary where the values
    are hashable (Histogram, and the HLL hash of its entries), and for a
    time or duration type its storage as float64 values, which the HLL
    hash reads as the JAX package reads a duration's."""
    col = _Column(Kind.UNKNOWN, mask, values=storage)
    encoded = None if values is None else _encode_objects(values)
    if encoded is not None:
        col.codes, col.dictionary = encoded
    return col


def _python_typed_column(items: List, present: List, mask: np.ndarray) -> Optional[_Column]:
    """``from_pydict``'s reading of datetime, date, Decimal and bytes
    values, as ``pyarrow.table`` types them for the JAX package:
    timestamp[us] (aware values as UTC), date32, a decimal of the
    largest scale present, binary (Kind UNKNOWN). None for other
    values."""
    if all(isinstance(v, datetime) for v in present):
        epoch = datetime(1970, 1, 1)
        micros = np.zeros(len(items), dtype=np.int64)
        for i, v in enumerate(items):
            if v is not None:
                if v.tzinfo is not None:
                    v = v.astimezone(timezone.utc).replace(tzinfo=None)
                micros[i] = (v - epoch) // timedelta(microseconds=1)
        return _numeric_column(micros, mask, "us")
    if all(isinstance(v, date) and not isinstance(v, datetime) for v in present):
        days = np.array([0 if v is None else v.toordinal() - _EPOCH_ORDINAL for v in items],
                        dtype=np.int64)
        return _numeric_column(days, mask, "date32")
    if all(isinstance(v, Decimal) for v in present):
        scale = max(max(0, -v.as_tuple().exponent) for v in present)
        values = np.array([0.0 if v is None else float(v) for v in items], dtype=np.float64)
        col = _numeric_column(values, mask)
        col.decimal_scale = scale
        return col
    if all(isinstance(v, bytes) for v in present):
        return _unknown_column(mask, items)
    return None


def _arrow_decimal_values(col, mask: np.ndarray) -> np.ndarray:
    """float64 values of a decimal128/decimal256 array, each the double
    nearest its decimal (as ``float(Decimal)``, the JAX package's cast),
    nulls 0. Units that fit 53 bits (every decimal of up to 15 digits,
    and any array whose units are checked to) at a scale of at most 22
    digits take one IEEE division of two exact doubles, which rounds
    once, to the same double; any other array takes the per-value
    cast."""
    typ = col.type
    n = len(col)
    words = typ.byte_width // 8
    storage = np.frombuffer(col.buffers()[1], dtype=np.int64, count=n * words,
                            offset=col.offset * typ.byte_width).reshape(n, words)
    units = storage[:, 0]
    exact = abs(typ.scale) <= 22 and (typ.precision <= 15 or bool(
        ((storage[:, 1:] == (units >> 63)[:, None]).all(axis=1)
         & (units >= -(1 << 53)) & (units <= 1 << 53))[mask].all()))
    if exact:
        out = units.astype(np.float64)
        if typ.scale >= 0:
            np.divide(out, 10.0**typ.scale, out=out)
        else:
            np.multiply(out, 10.0**-typ.scale, out=out)
    else:
        out = np.array([0.0 if v is None else float(v) for v in col.to_pylist()],
                       dtype=np.float64)
    if not mask.all():
        np.putmask(out, ~mask, 0.0)
    return out


def _arrow_column(col) -> _Column:
    """One (single-chunk) Arrow array as a column: the reading of
    ``Dataset.from_arrow`` and of a parquet file's columns."""
    import pyarrow as pa
    import pyarrow.compute as pc

    mask = ~np.asarray(col.is_null().to_numpy(zero_copy_only=False))
    typ = col.type
    numeric_dictionary = pa.types.is_dictionary(typ) and not (
        pa.types.is_string(typ.value_type) or pa.types.is_large_string(typ.value_type)
    )
    if numeric_dictionary:
        # a dictionary of numbers is a numeric column
        col = col.dictionary_decode()
        typ = col.type
    if pa.types.is_dictionary(typ) or pa.types.is_string(typ) or pa.types.is_large_string(typ):
        enc = col if pa.types.is_dictionary(typ) else pc.dictionary_encode(col)
        # unsigned indices are cast first: -1 fits no unsigned type
        indices = pc.cast(enc.indices, pa.int32())
        codes = pc.fill_null(indices, pa.scalar(-1, pa.int32())).to_numpy(zero_copy_only=False)
        out = _column_from_dictionary(
            DictionaryColumn(codes, np.asarray(enc.dictionary.to_pylist(), dtype=object))
        )
        out.dictionary_encoded = pa.types.is_dictionary(typ)
        return out
    if pa.types.is_null(typ):
        return _null_column(mask)
    if pa.types.is_decimal(typ):
        out = _Column(Kind.FRACTIONAL, mask, values=_arrow_decimal_values(col, mask),
                      decimal_scale=typ.scale)
        out.dictionary_encoded = numeric_dictionary
        return out
    unit = None
    if pa.types.is_timestamp(typ):
        unit = typ.unit
        col = pc.cast(col, pa.int64())
    elif pa.types.is_date(typ):
        # Arrow has no date32 -> int64 cast; hop through int32 (days
        # since the epoch, exact)
        if pa.types.is_date32(typ):
            unit = "date32"
            col = pc.cast(pc.cast(col, pa.int32()), pa.int64())
        else:
            unit = "date64"
            col = pc.cast(col, pa.int64())
    elif not (pa.types.is_boolean(typ) or pa.types.is_integer(typ)
              or pa.types.is_floating(typ)):
        storage = None
        # nested values (lists, structs, maps) are unhashable: no dictionary
        values = None if pa.types.is_nested(typ) else col.to_pylist()
        if pa.types.is_time(typ) or pa.types.is_duration(typ):
            ints = col.view(pa.int32() if typ.bit_width == 32 else pa.int64())
            # float64, as the JAX package casts a duration's numpy values
            storage = pc.fill_null(ints, 0).to_numpy(zero_copy_only=False).astype(np.float64)
        out = _unknown_column(mask, values, storage)
        out.duration = pa.types.is_duration(typ)
        return out
    if pa.types.is_boolean(typ):
        filled = pc.fill_null(col, pa.scalar(False))
    else:
        filled = pc.fill_null(col, pa.scalar(0, type=col.type))
    values = np.asarray(filled.to_numpy(zero_copy_only=False))
    out = _numeric_column(values, mask, unit)
    out.dictionary_encoded = numeric_dictionary
    return out


def _is_coded(col: _Column) -> bool:
    return col.kind == Kind.STRING or (col.values is None and col.codes is not None)


def _arrow_dictionary(col: _Column):
    """A coded column's dictionary as an Arrow array."""
    import pyarrow as pa

    return pa.array(col.dictionary.tolist(), type=pa.string() if col.kind == Kind.STRING
                    else None)


def _column_to_arrow(col: _Column, rows: slice = slice(None), dictionary=None):
    """One column's ``rows`` (all by default) as an Arrow array
    (``Dataset.table``, ``Dataset.record_batches``); ``dictionary`` is a
    coded column's ``_arrow_dictionary``, when the caller made it once."""
    import pyarrow as pa

    if col.arrow is not None:
        start, stop, _ = rows.indices(len(col.arrow))
        return col.arrow.slice(start, stop - start)
    nulls = ~col.mask[rows]
    if _is_coded(col):
        codes = col.codes[rows]
        values = dictionary if dictionary is not None else _arrow_dictionary(col)
        out = pa.DictionaryArray.from_arrays(pa.array(codes, mask=codes < 0), values)
        return out if col.dictionary_encoded else out.dictionary_decode()
    if col.values is None or (col.kind == Kind.UNKNOWN and not col.mask.any()):
        return pa.nulls(len(nulls))
    if col.bits is not None:
        return pa.array(col.bits[rows].view(np.uint64), mask=nulls)
    values = col.values[rows]
    if col.kind == Kind.BOOLEAN:
        return pa.array(values.astype(bool), mask=nulls)
    if col.kind == Kind.TIMESTAMP:
        unit = col.time_unit
        if unit in ("date32", "date64"):
            days = values if unit == "date32" else values // 86_400_000
            return pa.array(days.astype(np.int32), mask=nulls).cast(
                pa.date32() if unit == "date32" else pa.date64())
        return pa.array(values, mask=nulls).cast(pa.timestamp(unit))
    if col.decimal_scale is not None:
        return pa.array(values, mask=nulls).cast(pa.decimal128(38, col.decimal_scale))
    return pa.array(values, mask=nulls)


def _keep_validity(arr):
    """``arr`` with a validity bitmap (all valid, its null count left to
    be counted) where it has none: the rows of a column that has a null
    elsewhere, which a slice of the whole column's array would carry."""
    import pyarrow as pa

    if pa.types.is_null(arr.type) or arr.buffers()[0] is not None:
        return arr
    if pa.types.is_dictionary(arr.type):
        return pa.DictionaryArray.from_arrays(_keep_validity(arr.indices), arr.dictionary)
    bitmap = pa.py_buffer(np.packbits(np.ones(len(arr), dtype=bool), bitorder="little"))
    return pa.Array.from_buffers(arr.type, len(arr), [bitmap] + arr.buffers()[1:],
                                 null_count=-1, offset=arr.offset)


def _encode_strings(values: Sequence) -> Tuple[np.ndarray, np.ndarray]:
    """First-appearance dictionary encoding (Arrow's dictionary_encode
    order); None -> code -1."""
    index: Dict[object, int] = {}
    codes = np.empty(len(values), dtype=np.int32)
    for i, v in enumerate(values):
        codes[i] = -1 if v is None else index.setdefault(v, len(index))
    dictionary = np.empty(len(index), dtype=object)
    for v, i in index.items():
        dictionary[i] = v
    return codes, dictionary


def _column_from_dictionary(col: DictionaryColumn) -> _Column:
    codes = np.asarray(col.codes)
    dictionary = np.asarray(col.dictionary, dtype=object)
    if codes.ndim != 1 or codes.dtype.kind not in "iu":
        raise TypeError("DictionaryColumn codes must be a 1-D integer array")
    if len(codes) and (codes.min() < -1 or codes.max() >= len(dictionary)):
        raise ValueError("DictionaryColumn codes out of range")
    if len(set(dictionary.tolist())) != len(dictionary):
        raise ValueError("DictionaryColumn dictionary values must be unique")
    # an Arrow dictionary may hold a null entry: a row coding it is valid
    # (Arrow's nulls are the indices'), and its value is None, as the JAX
    # package reads it
    if not all(v is None or isinstance(v, str) for v in dictionary):
        raise TypeError("DictionaryColumn dictionaries must hold strings (or None)")
    codes = codes.astype(np.int32)
    return _Column(Kind.STRING, codes >= 0, codes=codes, dictionary=dictionary)


def _column_from_sequence(values) -> _Column:
    if isinstance(values, DictionaryColumn):
        col = _column_from_dictionary(values)
        col.dictionary_encoded = True
        return col
    if isinstance(values, np.ma.MaskedArray):
        mask = ~np.ma.getmaskarray(values)
        fill = False if values.dtype == np.bool_ else 0
        unit = _time_unit(values.dtype) if values.dtype.kind == "M" else None
        return _numeric_column(np.asarray(values.filled(fill)), mask, unit)
    if isinstance(values, np.ndarray) and values.dtype.kind in "biufM":
        if values.dtype.kind == "M":
            return _numeric_column(values, ~np.isnat(values), _time_unit(values.dtype))
        return _numeric_column(values, np.ones(len(values), dtype=bool))
    if isinstance(values, np.ndarray) and values.dtype.kind in "US":
        values = values.astype(str).tolist()
    items = list(values)
    present = [v for v in items if v is not None]
    mask = np.array([v is not None for v in items], dtype=bool)
    if not present:
        return _null_column(mask)
    if all(isinstance(v, str) for v in present):
        codes, dictionary = _encode_strings(items)
        return _Column(Kind.STRING, mask, codes=codes, dictionary=dictionary)
    column = _python_typed_column(items, present, mask)
    if column is not None:
        return column
    if all(isinstance(v, (bool, np.bool_)) for v in present):
        dtype = np.bool_
    elif all(
        isinstance(v, (int, np.integer)) and not isinstance(v, bool)
        for v in present
    ):
        dtype = np.int64
    elif all(isinstance(v, (int, float, np.integer, np.floating)) for v in present):
        dtype = np.float64
    else:
        raise TypeError("column mixes value types that have no common kind")
    filled = np.array(
        [v if v is not None else 0 for v in items], dtype=dtype
    )
    return _numeric_column(filled, mask)


def _filter_column(col: _Column, rows: np.ndarray, keep: np.ndarray) -> _Column:
    """The column at the row indices ``rows`` (where ``keep`` is True;
    the source's Arrow array is filtered by ``keep``, as the JAX package
    filters its table: Arrow has no take of every type)."""
    def take(arr):
        return None if arr is None else arr.take(rows)

    out = _Column(
        col.kind, take(col.mask), values=take(col.values), bits=take(col.bits),
        time_unit=col.time_unit, dictionary_encoded=col.dictionary_encoded,
        decimal_scale=col.decimal_scale, arrow_field=col.arrow_field,
        arrow=None if col.arrow is None else col.arrow.filter(keep),
        duration=col.duration,
    )
    if col.kind in (Kind.STRING, Kind.UNKNOWN) and col.codes is not None:
        out.codes, out.dictionary = take(col.codes), col.dictionary
        if not col.dictionary_encoded:
            out.codes, out.dictionary = _compact_dictionary(out.codes, col.dictionary)
    return out


def _slice_column(col: _Column, start: int, stop: int) -> _Column:
    """The column's rows [start, stop), as views of its arrays."""
    def view(arr):
        return None if arr is None else arr[start:stop]

    out = _Column(
        col.kind, view(col.mask), values=view(col.values), bits=view(col.bits),
        time_unit=col.time_unit, dictionary_encoded=col.dictionary_encoded,
        decimal_scale=col.decimal_scale, arrow_field=col.arrow_field,
        arrow=None if col.arrow is None else col.arrow.slice(start, stop - start),
        duration=col.duration,
    )
    if col.kind in (Kind.STRING, Kind.UNKNOWN) and col.codes is not None:
        out.codes, out.dictionary = view(col.codes), col.dictionary
        if not col.dictionary_encoded:
            out.codes, out.dictionary = _compact_dictionary(out.codes, col.dictionary)
    return out


def _compact_dictionary(codes: np.ndarray, dictionary: np.ndarray):
    """(codes, dictionary) of the entries ``codes`` still use, numbered
    in the order the rows first use them."""
    valid = codes >= 0
    new, used = _first_seen_dense(codes[valid], 0, max(len(dictionary), 1))
    out = np.full(len(codes), -1, dtype=np.int32)
    out[valid] = new
    return out, dictionary[used.astype(np.intp)]


class Dataset:
    """In-memory columnar dataset over numpy columns.

    Construction helpers accept plain dicts of Python/numpy sequences
    (``None`` = null, or ``numpy.ma.MaskedArray`` masks),
    :class:`DictionaryColumn` for pre-encoded strings, or an Arrow table.
    """

    # passes over the data made outside a scan (a parquet source's
    # dictionary pre-pass); the runner adds them to its engine's count
    prepasses = 0
    # a mesh rank's part of a table (``row_share``, or a parquet
    # ``shard_view`` through ``engine/ingest.py::process_sharded_feed``):
    # (kind, rank, world), None for a whole table
    mesh_share: Optional[Tuple[str, int, int]] = None
    # whether every rank's part codes its columns against the same
    # dictionaries, so that states keyed by codes add across ranks
    shared_dictionaries = True

    # the schema metadata of the Arrow table a dataset was read from
    # (``from_arrow``; pandas' among others), kept by ``table``,
    # ``record_batches`` and the datasets made from this one
    arrow_metadata: Optional[Mapping[bytes, bytes]] = None

    def __init__(self, columns: Mapping[str, _Column], arrow_metadata=None):
        self.arrow_metadata = arrow_metadata
        lengths = {len(c.mask) for c in columns.values()}
        if len(lengths) > 1:
            raise ValueError(f"columns differ in length: {sorted(lengths)}")
        self._columns: Dict[str, _Column] = dict(columns)
        self._num_rows = lengths.pop() if lengths else 0
        self._schema = Schema(
            tuple(Field(name, c.kind) for name, c in self._columns.items())
        )
        # resident device copies, keyed (repr key, device)
        self._device_cache: Dict[Tuple[str, str], torch.Tensor] = {}
        # compiled where/Compliance predicates, by expression
        # (sql/predicate.py: planning compiles each one several times)
        self._predicate_cache: Dict[str, object] = {}

    # -- construction ---------------------------------------------------

    @staticmethod
    def from_pydict(data: Mapping[str, Sequence]) -> "Dataset":
        return Dataset(
            {name: _column_from_sequence(v) for name, v in data.items()}
        )

    @staticmethod
    def from_arrow(table) -> "Dataset":
        """From a ``pyarrow.Table`` (pyarrow is imported only by the
        Arrow-boundary methods)."""
        columns = {}
        for field in table.schema:
            arr = table.column(field.name).combine_chunks()
            col = _arrow_column(arr)
            col.arrow, col.arrow_field = arr, field
            columns[field.name] = col
        return Dataset(columns, table.schema.metadata)

    @staticmethod
    def from_pandas(df) -> "Dataset":
        """From a ``pandas.DataFrame``, through Arrow as the JAX package
        reads one (its index dropped)."""
        import pyarrow as pa

        return Dataset.from_arrow(pa.Table.from_pandas(df, preserve_index=False))

    @staticmethod
    def from_parquet(source, read_batch_rows: int = 1 << 20) -> "Dataset":
        """A parquet file or directory, read lazily: a scan that does not
        fit the device budget streams it batch by batch, and whole
        columns are read only for a resident scan
        (``data/parquet.py``)."""
        from deequ_tpu_torch.data.parquet import ParquetDataset

        return ParquetDataset(source, read_batch_rows)

    @property
    def table(self):
        """The columns as a ``pyarrow.Table``: a table read by
        ``from_arrow`` is its source (arrays, fields, schema metadata);
        other columns are numbers in their values' dtypes (booleans as
        bool, uint64 as uint64, timestamps and dates in their units,
        decimals as decimal128(38, scale)), strings as strings
        (dictionary-typed where they were handed over so), and other
        columns as Arrow infers their values."""
        return self._arrow_table(list(self._columns), [_column_to_arrow(c)
                                                       for c in self._columns.values()])

    def _arrow_table(self, names: Sequence[str], arrays):
        """``arrays`` as a table under the source's fields, where the
        columns were read from Arrow, and its schema metadata."""
        import pyarrow as pa

        fields = [self._columns[n].arrow_field or pa.field(n, a.type)
                  for n, a in zip(names, arrays)]
        return pa.Table.from_arrays(arrays, schema=pa.schema(fields, self.arrow_metadata))

    def record_batches(self, columns: Sequence[str], batch_rows: int = 1 << 20):
        """The named columns as Arrow record batches of ``batch_rows``
        rows, converted a chunk of rows at a time (a multiple of
        ``batch_rows``, at least 2^20), so that a large table is never
        converted whole: the batches hold what slices of ``table`` hold,
        a validity bitmap included wherever the column has a null."""
        names = list(columns)
        cols = [self._columns[c] for c in names]
        dictionaries = [_arrow_dictionary(c) if _is_coded(c) else None for c in cols]
        gappy = [not bool(c.mask.all()) for c in cols]
        step = batch_rows * -(-(1 << 20) // batch_rows)
        for start in range(0, self._num_rows, step):
            rows = slice(start, min(start + step, self._num_rows))
            arrays = [_column_to_arrow(c, rows, d) for c, d in zip(cols, dictionaries)]
            arrays = [_keep_validity(a) if g else a for a, g in zip(arrays, gappy)]
            yield from self._arrow_table(names, arrays).to_batches(batch_rows)

    # -- metadata -------------------------------------------------------

    @property
    def num_rows(self) -> int:
        return self._num_rows

    @property
    def num_columns(self) -> int:
        return len(self._columns)

    @property
    def schema(self) -> Schema:
        return self._schema

    def filter_rows(self, mask: np.ndarray) -> "Dataset":
        """The rows where ``mask`` is True, as a new host-only dataset
        (train/test splits, schema validation; not the metric engine).
        A string column keeps its codes' rows; its dictionary stays whole
        when it was handed over dictionary-typed, and is otherwise the
        kept rows' values in first-seen order, as the JAX package's
        filtered Arrow table encodes it. Numeric dictionaries and
        integral ranges are built anew at first use."""
        keep = np.asarray(mask, dtype=bool)
        if keep.shape != (self._num_rows,):
            raise ValueError(
                f"filter mask has shape {keep.shape}, the dataset {self._num_rows} rows"
            )
        # a gather by the kept rows' indices: several times faster than a
        # boolean index of each array under a random mask
        rows = np.flatnonzero(keep)
        return Dataset({name: _filter_column(c, rows, keep) for name, c in self._columns.items()},
                       self.arrow_metadata)

    def slice_rows(self, start: int, stop: int) -> "Dataset":
        """Rows [start, stop) as a new dataset whose columns are views of
        this one's host arrays (a partition of a table already in
        memory, with no copy of its numbers). String columns follow
        ``filter_rows``' rule for their dictionaries."""
        start, stop, _ = slice(start, stop).indices(self._num_rows)
        stop = max(start, stop)
        return Dataset({name: _slice_column(c, start, stop) for name, c in self._columns.items()},
                       self.arrow_metadata)

    def row_share(self, index: int, count: int) -> "Dataset":
        """Rank ``index`` of ``count``'s rows of this table, ``[index * n //
        count, (index + 1) * n // count)``: a mesh rank's part, whose
        columns are views of this table's and whose codes index THIS
        table's dictionaries (:class:`RowShare`), so that every rank
        plans the same scan and count states keyed by codes add up."""
        return RowShare(self, index, count)

    def with_columns(self, columns: Mapping[str, object]) -> "Dataset":
        """This dataset with the named columns replaced, in their place,
        by ``from_pydict``'s reading of the given values. A
        ``DictionaryColumn`` given here is read as plain strings: its
        dictionary shrinks to the entries its codes use, in first-seen
        order (the JAX package builds such a column as a plain string
        array)."""
        out = dict(self._columns)
        for name, values in columns.items():
            if isinstance(values, DictionaryColumn):
                col = _column_from_dictionary(values)
                col.codes, col.dictionary = _compact_dictionary(col.codes, col.dictionary)
            else:
                col = _column_from_sequence(values)
            out[name] = col
        return Dataset(out)

    def select(self, columns: Sequence[str]) -> "Dataset":
        """The named columns, in that order (their host columns shared)."""
        return Dataset({name: self._columns[name] for name in columns}, self.arrow_metadata)

    # -- dictionaries ---------------------------------------------------

    def dictionary(self, column: str) -> np.ndarray:
        """Host-side dictionary (unique values) of a column; its codes
        index into it. A string column's is its own; a numeric, boolean
        or timestamp column's is built at first use (``_encode``) in
        the JAX package's dtype: booleans as bool, timestamps as
        datetime64 in the column's unit, uint64 as uint64, float32 as
        float32 (``str`` of a key is a Histogram label)."""
        col = self._columns[column]
        if col.dictionary is None:
            self._encode(column)
        return col.dictionary

    def _encode(self, column: str) -> None:
        """First-seen codes and dictionary of a non-string column, with
        float keys normalised (``normalize_float_grouping_keys``)."""
        col = self._columns[column]
        if col.kind not in _ENCODABLE:
            raise TypeError(f"column {column!r} ({col.kind.value}) has no dictionary")
        values = col.values if col.bits is None else col.bits.view(np.uint64)
        valid = normalize_float_grouping_keys(values[col.mask])
        codes, dictionary = _first_seen_codes(valid)
        if col.kind == Kind.BOOLEAN:
            dictionary = dictionary.astype(bool)
        elif col.kind == Kind.TIMESTAMP:
            dictionary = dictionary.astype(np.int64).view(_DATETIME[col.time_unit])
        elif col.decimal_scale is not None:
            dictionary = _decimal_dictionary(dictionary, col.decimal_scale)
        full = np.full(len(col.mask), -1, dtype=np.int32)
        full[col.mask] = codes
        col.codes, col.dictionary = full, dictionary

    def dictionary_size_within(self, column: str, cap: int) -> Optional[int]:
        """The column's distinct count if it is at most ``cap``, else
        None (the dictionary is built either way, as the JAX package's
        in-memory dataset builds it)."""
        d = self.dictionary(column)
        return len(d) if len(d) <= cap else None

    def integral_range(self, column: str) -> Optional[Tuple[int, int]]:
        """(min, max) of an INTEGRAL column's valid values, no distinct
        set built; None for other kinds, for all-null columns and for a
        column decoded from an Arrow dictionary (the JAX package keeps
        that one dictionary-typed and probes no range). Cached."""
        col = self._columns[column]
        if col.kind != Kind.INTEGRAL or col.dictionary_encoded:
            return None
        if not col.range_probed:
            values = col.values if col.bits is None else col.bits.view(np.uint64)
            valid = values[col.mask]
            col.integral_range = (
                (int(valid.min()), int(valid.max())) if len(valid) else None
            )
            col.range_probed = True
        return col.integral_range

    def _meta(self, column: str) -> _Column:
        """The column whose kind, dtypes and units answer for it (a
        parquet source answers with its zero-row reading)."""
        return self._columns[column]

    def hll_repr(self, column: str) -> str:
        """The representation the HLL hash of a column reads: ``codes``
        of a string column (or of an UNKNOWN one with a dictionary),
        ``bits`` of a uint64 column, else ``values``."""
        col = self._meta(column)
        if col.kind == Kind.STRING or (col.values is None and col.codes is not None):
            return "codes"
        if col.values is None:
            raise TypeError(
                f"column {column!r} ({col.kind.value}) has neither values nor a dictionary"
            )
        return "values" if col.bits is None else "bits"

    def check_row_level_repr(self, column: str, repr_name: str) -> None:
        """Raise TypeError where the JAX package's dataset cannot
        materialize ``repr_name`` of the column for a row-level column:
        ``lengths`` of anything but a string, ``values`` of a string or
        of an UNKNOWN-kind column but a duration. The port drops that
        constraint's column as the JAX package does, though it could
        answer it."""
        col = self._meta(column)
        kind = col.kind
        if (repr_name == "lengths" and kind != Kind.STRING) or (
                repr_name == "values" and (kind == Kind.STRING
                                           or (kind == Kind.UNKNOWN and not col.duration))):
            raise TypeError(
                f"column {column!r} ({kind.value}) has no {repr_name!r} repr "
                "for row-level results"
            )

    def timestamp_unit(self, column: str) -> str:
        """Storage unit of a timestamp/date column's int64 ``values``:
        "s", "ms", "us", "ns", "date32" or "date64"."""
        unit = self._meta(column).time_unit
        if unit is None:
            raise TypeError(f"column {column!r} is not a timestamp/date column")
        return unit

    # -- representations ------------------------------------------------

    def materialize(self, req: ColumnRequest) -> np.ndarray:
        """The host array of a representation (no copy). ``lengths``
        has none: it is made on the device (``device_column``)."""
        col = self._columns[req.column]
        if req.repr == "mask":
            return col.mask
        if req.repr == "values":
            if col.values is None:
                raise TypeError(
                    f"column {req.column!r} ({col.kind.value}) has no "
                    "'values' repr; string columns ship 'codes'"
                )
            return col.values
        if req.repr == "codes":
            if col.codes is None:
                self._encode(req.column)
            return col.codes
        if req.repr == "bits":
            if col.bits is None:
                raise TypeError(f"column {req.column!r} has no 'bits' repr")
            return col.bits
        raise ValueError(f"unknown column repr: {req.repr!r}")

    def request_dtype(self, req: ColumnRequest) -> np.dtype:
        """Dtype a device batch of this request will have (the planner
        groups stackable columns by it)."""
        if req.repr in ("lengths", "codes"):
            return np.dtype(np.int32)
        return np.dtype(self.materialize(req).dtype)

    # -- the device cache ------------------------------------------------

    @property
    def _cache_key(self) -> int:
        """This dataset's key in the process-wide ledger (made at first
        use; dropped from the ledger when the dataset is collected)."""
        key = self.__dict__.get("_ledger_key")
        if key is None:
            key = next(_CACHE_KEYS)
            self.__dict__["_ledger_key"] = key
            weakref.finalize(self, _LEDGER.forget, key)
        return key

    @staticmethod
    def global_device_cache_bytes() -> int:
        """Bytes of resident device columns over every dataset of the
        process."""
        return _LEDGER.total()

    def _device_cache_bytes(self) -> int:
        return _LEDGER.bytes_of(self._cache_key)

    def clear_device_cache(self) -> None:
        """Drop this dataset's resident device columns; the tensors are
        freed once no running scan holds a batch of them."""
        self._device_cache.clear()
        _LEDGER.drop(self._cache_key)

    def _cache(self, key: Tuple[str, str], tensor: torch.Tensor) -> torch.Tensor:
        self._device_cache[key] = tensor
        _LEDGER.add(self, tensor.numel() * tensor.element_size())
        return tensor

    def _ensure_cache_budget(self, needed: int, budget: int) -> None:
        """Evict device caches (other datasets first, least recently
        scanned first, then this one) until ``needed`` more bytes fit in
        ``budget``: the JAX package's rule."""
        if _LEDGER.total() + needed <= budget:
            return
        own = self._cache_key
        for key, ref in _LEDGER.lru():
            if key == own:
                continue
            other = ref()
            if other is not None:
                other.clear_device_cache()
            else:
                _LEDGER.drop(key)
            if _LEDGER.total() + needed <= budget:
                return
        self.clear_device_cache()

    def device_column(
        self, req: ColumnRequest, device: torch.device
    ) -> torch.Tensor:
        """The whole column's representation on ``device``: copied once,
        then resident for every later scan of this dataset (until the
        budget evicts it, ``device_batches``)."""
        key = (req.key, str(device))
        out = self._device_cache.get(key)
        if out is None:
            if req.repr == "lengths":
                out = self._device_lengths(req.column, device)
            else:
                host = self.materialize(req)
                add_transfer_bytes(host.nbytes)
                out = torch.from_numpy(_writable(host)).to(device)
            self._cache(key, out)
        return out

    def _device_lengths(self, column: str, device: torch.device) -> torch.Tensor:
        """A string column's lengths, gathered on the device from its
        resident codes: the dictionary's lengths cross, not the rows'."""
        col = self._columns[column]
        if col.kind != Kind.STRING:
            raise TypeError(f"column {column!r} has no 'lengths' repr")
        codes = self.device_column(ColumnRequest(column, "codes"), device)
        table = torch.from_numpy(_lengths_table(col.dictionary)).to(device)
        return table[codes.to(torch.int64) + 1]

    @staticmethod
    def _dedup_requests(
        requests: Sequence[ColumnRequest],
    ) -> Dict[str, ColumnRequest]:
        """Dedup requests and add a validity-mask request per column."""
        keys: Dict[str, ColumnRequest] = {}
        for r in requests:
            keys.setdefault(r.key, r)
            mask_req = ColumnRequest(r.column, "mask")
            keys.setdefault(mask_req.key, mask_req)
        return keys

    def _is_all_valid(self, column: str) -> bool:
        """Whether the column has no null row (cached)."""
        col = self._columns[column]
        if col.all_valid is None:
            col.all_valid = bool(col.mask.all())
        return col.all_valid

    def num_batches(self, batch_size: int) -> int:
        return -(-self._num_rows // max(int(batch_size), 1))

    def fingerprint(self) -> str:
        """The source's identity for checkpoints (a resume against a
        CHANGED source would fold two datasets into one metric). An
        in-memory table has no storage identity, so this is a WEAK one,
        as in the JAX package: the schema, the row count and the first
        1,024 rows of the first column. A parquet source names its
        files instead."""
        h = hashlib.sha1()
        h.update(repr([(f.name, f.kind.value) for f in self._schema.fields]).encode())
        h.update(str(self._num_rows).encode())
        if self._num_rows and len(self._schema):
            col = self._columns[self._schema.fields[0].name]
            head = min(self._num_rows, 1024)
            h.update(np.ascontiguousarray(col.mask[:head]).tobytes())
            for arr in (col.values, col.bits, col.codes):
                if arr is None:
                    continue
                part = arr[:head]
                h.update(repr(part.tolist()).encode() if part.dtype == object
                         else np.ascontiguousarray(part).tobytes())
            if col.dictionary is not None and col.codes is not None:
                h.update(repr([None if c < 0 else col.dictionary[c]
                               for c in col.codes[:head].tolist()]).encode())
        return f"mem-{h.hexdigest()[:20]}"

    def _request_row_bytes(self, req: ColumnRequest) -> int:
        """Device bytes a row of one request holds on a resident scan:
        none for the mask of a column without nulls (its batches use the
        row mask), the host array's width otherwise."""
        if req.repr == "mask":
            return 0 if self._is_all_valid(req.column) else 1
        if req.repr in ("codes", "lengths"):
            return 4
        return self.materialize(req).dtype.itemsize

    def estimated_device_bytes(self, requests: Sequence[ColumnRequest]) -> int:
        """The device bytes a resident scan of ``requests`` keeps: every
        row of each deduplicated request, the row mask, and the codes
        that a ``lengths`` request is gathered from. The engine streams a
        scan whose estimate exceeds ``config.device_cache_bytes``. The
        JAX package counts the same bytes over rows padded to whole
        batches; the port pads no batch."""
        return self._device_bytes(requests)

    def _device_bytes(self, requests: Sequence[ColumnRequest], resident=frozenset()) -> int:
        """``estimated_device_bytes`` less the cache keys in ``resident``."""
        keys = self._dedup_requests(requests)
        per_row = 0 if ROW_MASK in resident else 1  # the row mask
        for k, r in keys.items():
            if k not in resident:
                per_row += self._request_row_bytes(r)
            codes = f"{r.column}::codes"
            if r.repr == "lengths" and codes not in keys and codes not in resident:
                per_row += 4
        return self._num_rows * per_row

    def device_batches(
        self,
        requests: Sequence[ColumnRequest],
        batch_size: int,
        device: torch.device,
        start_batch: int = 0,
    ) -> Iterator[Dict[str, torch.Tensor]]:
        """Make the requested columns resident on ``device`` now, then
        iterate batches as dicts of views into them, ``batch_size`` rows
        each (the last one shorter), plus ``ROW_MASK``. An empty dataset
        yields no batch: every state then stays at its identity, which
        is what one all-masked batch gives. ``start_batch`` skips the
        first batches (a retry or a resume): batch ``i`` of a restarted
        stream is batch ``i`` of a whole one. Before it copies, other
        datasets' resident columns are evicted, least recently scanned
        first, until the copy fits ``config.device_cache_bytes``."""
        from deequ_tpu_torch import config

        budget = config.options().device_cache_bytes
        if budget:
            resident = {k for k, d in self._device_cache if d == str(device)}
            self._ensure_cache_budget(self._device_bytes(requests, resident), budget)
        _LEDGER.touch(self)
        row_key = (ROW_MASK, str(device))
        row = self._device_cache.get(row_key)
        if row is None:
            row = self._cache(row_key, torch.ones(self._num_rows, dtype=torch.bool,
                                                  device=device))
        full = {ROW_MASK: row}
        for k, r in self._dedup_requests(requests).items():
            alias = r.repr == "mask" and self._is_all_valid(r.column)
            full[k] = row if alias else self.device_column(r, device)
        return self._batches(full, batch_size, start_batch)

    def _batches(
        self, full: Dict[str, torch.Tensor], batch_size: int, start_batch: int = 0
    ) -> Iterator[Dict[str, torch.Tensor]]:
        n = self._num_rows
        for start in range(start_batch * batch_size, n, batch_size):
            yield {k: v[start:start + batch_size] for k, v in full.items()}

    def host_batches(
        self, requests: Sequence[ColumnRequest], batch_size: int, start_batch: int = 0
    ) -> Iterator[Dict[str, np.ndarray]]:
        """The host rows of a streamed scan: every deduplicated request
        (masks included) as numpy slices of ``batch_size`` rows, the last
        one shorter; a ``lengths`` request is gathered here from the
        codes through its dictionary's lengths. No batch for an empty
        dataset, and nothing is copied to a device. ``start_batch`` skips
        the first batches, as ``device_batches`` does."""
        full: Dict[str, np.ndarray] = {}
        lengths: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
        for k, r in self._dedup_requests(requests).items():
            if r.repr == "lengths":
                col = self._columns[r.column]
                if col.kind != Kind.STRING:
                    raise TypeError(f"column {r.column!r} has no 'lengths' repr")
                lengths[k] = (_lengths_table(col.dictionary), col.codes)
            else:
                full[k] = self.materialize(r)
        for start in range(start_batch * batch_size, self._num_rows, batch_size):
            stop = start + batch_size
            batch = {k: v[start:stop] for k, v in full.items()}
            for k, (table, codes) in lengths.items():
                batch[k] = table[codes[start:stop].astype(np.intp) + 1]
            yield batch


def _share_column(col: _Column, start: int, stop: int) -> _Column:
    """Rows [start, stop) of a column, as views, keeping its codes'
    numbering and its whole dictionary."""
    def view(arr):
        return None if arr is None else arr[start:stop]

    return _Column(
        col.kind, view(col.mask), values=view(col.values), codes=view(col.codes),
        bits=view(col.bits), dictionary=col.dictionary, time_unit=col.time_unit,
        dictionary_encoded=col.dictionary_encoded, decimal_scale=col.decimal_scale,
        arrow_field=col.arrow_field,
        arrow=None if col.arrow is None else col.arrow.slice(start, stop - start),
        duration=col.duration,
    )


class _ShareColumns(dict):
    """A row share's columns, each cut from the parent's at first use
    (a parquet parent reads a column whole only when it is asked for)."""

    def __init__(self, share: "RowShare"):
        super().__init__()
        self._share = share

    def __missing__(self, column: str) -> _Column:
        share = self._share
        col = _share_column(share._parent._columns[column], share._start, share._stop)
        self[column] = col
        return col


class RowShare(Dataset):
    """A mesh rank's contiguous share of a table's rows (``Dataset.
    row_share``). Its codes and dictionaries are the parent's, and the
    planner's other whole-table answers (integral ranges) come from the
    parent too, so every rank makes the same plan as a one-device run of
    the whole table; only the rows it scans are its own."""

    mesh_share: Optional[Tuple[str, int, int]] = None

    def __init__(self, parent: Dataset, index: int, count: int):
        if count <= 0 or not 0 <= index < count:
            raise ValueError(f"rank {index} outside [0, {count})")
        n = parent.num_rows
        self._parent = parent
        self._start, self._stop = index * n // count, (index + 1) * n // count
        self._num_rows = self._stop - self._start
        self._schema = parent.schema
        self.arrow_metadata = parent.arrow_metadata
        self._columns = _ShareColumns(self)
        if type(parent._columns) is dict:
            for name in parent.schema.column_names:
                self._columns[name]  # cut every column of an in-memory table now
        self._device_cache = {}
        self._predicate_cache = {}
        self.mesh_share = ("rows", int(index), int(count))
        self.global_num_rows = n

    @property
    def prepasses(self) -> int:
        return self._parent.prepasses

    @property
    def num_columns(self) -> int:
        return self._parent.num_columns

    def _encode(self, column: str) -> None:
        """The parent's codes (built there at first use) and dictionary."""
        parent_col = self._parent._columns[column]
        if parent_col.codes is None:
            self._parent._encode(column)
        col = self._columns[column]
        col.codes = parent_col.codes[self._start:self._stop]
        col.dictionary = parent_col.dictionary

    def dictionary(self, column: str) -> np.ndarray:
        col = self._columns[column]
        if col.dictionary is None:
            self._encode(column)
        return col.dictionary

    def integral_range(self, column: str) -> Optional[Tuple[int, int]]:
        return self._parent.integral_range(column)

    def _meta(self, column: str) -> _Column:
        return self._parent._meta(column)

    def fingerprint(self) -> str:
        h = hashlib.sha1(self._parent.fingerprint().encode())
        h.update(f"share:{self.mesh_share[1]}/{self.mesh_share[2]}".encode())
        return f"share-{h.hexdigest()[:20]}"
