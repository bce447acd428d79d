"""Row-level schema validation: split a dataset into valid and invalid rows.

Counterpart of ``deequ_tpu/schema/validator.py``: ``RowLevelSchema``
column definitions (string, int, fractional, decimal and timestamp, with
nullability, length bounds, a regex, value bounds, a date mask) and
``RowLevelSchemaValidator.validate(data, schema)``, which returns the
valid rows with the declared types and the invalid rows as they were.

The JAX package runs Arrow compute kernels over every row. Here every
test runs once per DISTINCT value: a column's dictionary entries (a
numeric, boolean or timestamp column is read through its dictionary of
distinct values, formatted as Arrow casts them to strings) are checked
with ``re`` and ``datetime.strptime`` on the host, and the per-entry
result is gathered by the rows' codes. The row split uses
``Dataset.filter_rows``.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from datetime import datetime
from typing import Callable, List, Optional, Tuple

import numpy as np

from deequ_tpu_torch.data.table import ColumnRequest, Dataset, DictionaryColumn, Kind


@dataclass(frozen=True)
class ColumnDefinition:
    name: str
    is_nullable: bool = True


@dataclass(frozen=True)
class StringColumnDefinition(ColumnDefinition):
    min_length: Optional[int] = None
    max_length: Optional[int] = None
    matches: Optional[str] = None  # regex


@dataclass(frozen=True)
class IntColumnDefinition(ColumnDefinition):
    min_value: Optional[int] = None
    max_value: Optional[int] = None


@dataclass(frozen=True)
class FractionalColumnDefinition(ColumnDefinition):
    pass


@dataclass(frozen=True)
class DecimalColumnDefinition(ColumnDefinition):
    precision: int = 38
    scale: int = 0


@dataclass(frozen=True)
class TimestampColumnDefinition(ColumnDefinition):
    mask: str = "yyyy-MM-dd HH:mm:ss"  # Java SimpleDateFormat style


class RowLevelSchema:
    """Fluent schema builder."""

    def __init__(self, definitions: Optional[List[ColumnDefinition]] = None):
        self.definitions: List[ColumnDefinition] = list(definitions or [])

    def _add(self, definition: ColumnDefinition) -> "RowLevelSchema":
        return RowLevelSchema(self.definitions + [definition])

    def with_string_column(
        self,
        name: str,
        is_nullable: bool = True,
        min_length: Optional[int] = None,
        max_length: Optional[int] = None,
        matches: Optional[str] = None,
    ) -> "RowLevelSchema":
        return self._add(
            StringColumnDefinition(name, is_nullable, min_length, max_length, matches)
        )

    def with_int_column(
        self,
        name: str,
        is_nullable: bool = True,
        min_value: Optional[int] = None,
        max_value: Optional[int] = None,
    ) -> "RowLevelSchema":
        return self._add(IntColumnDefinition(name, is_nullable, min_value, max_value))

    def with_fractional_column(self, name: str, is_nullable: bool = True) -> "RowLevelSchema":
        return self._add(FractionalColumnDefinition(name, is_nullable))

    def with_decimal_column(
        self, name: str, precision: int = 38, scale: int = 0, is_nullable: bool = True
    ) -> "RowLevelSchema":
        return self._add(DecimalColumnDefinition(name, is_nullable, precision, scale))

    def with_timestamp_column(
        self, name: str, mask: str = "yyyy-MM-dd HH:mm:ss", is_nullable: bool = True
    ) -> "RowLevelSchema":
        return self._add(TimestampColumnDefinition(name, is_nullable, mask))


@dataclass
class RowLevelSchemaValidationResult:
    valid_rows: Dataset
    num_valid_rows: int
    invalid_rows: Dataset
    num_invalid_rows: int


# at most 18 digits: every 18-digit decimal fits int64 (19-digit strings,
# even the few inside int64's range, classify as invalid)
_INT_RE = re.compile(r"^\s*[+-]?\d{1,18}\s*$")
_FRACTIONAL_RE = re.compile(r"^\s*[+-]?(\d+(\.\d*)?|\.\d+)([eE][+-]?\d+)?\s*$")

_JAVA_TO_STRPTIME = [
    ("yyyy", "%Y"),
    ("yy", "%y"),
    ("MM", "%m"),
    ("dd", "%d"),
    ("HH", "%H"),
    ("mm", "%M"),
    ("ss", "%S"),
    ("SSS", "%f"),
]
_EPOCH = datetime(1970, 1, 1)
# the fraction digits of Arrow's timestamp-to-string cast, by unit
_FRACTION_DIGITS = {"s": 0, "ms": 3, "us": 6, "ns": 9}


def java_mask_to_strptime(mask: str) -> str:
    out = mask
    for java, c in _JAVA_TO_STRPTIME:
        out = out.replace(java, c)
    return out


def _decimal_regex(precision: int, scale: int) -> "re.Pattern":
    int_digits = max(precision - scale, 1)
    if scale > 0:
        return re.compile(rf"^\s*[+-]?\d{{1,{int_digits}}}(\.\d{{0,{scale}}})?\s*$")
    return re.compile(rf"^\s*[+-]?\d{{1,{int_digits}}}\s*$")


def _float_str(x) -> str:
    """A float as Arrow casts it to a string: the shortest digits that
    round-trip in its own width, positional for decimal exponents -6 to
    9, else ``<digits>e<sign><exponent>``."""
    if np.isnan(x):
        return "nan"
    if np.isinf(x):
        return "inf" if x > 0 else "-inf"
    sci = np.format_float_scientific(x, unique=True, trim="-")
    mantissa, exp = sci.split("e")
    e = int(exp)
    if -6 <= e <= 9:
        return np.format_float_positional(x, unique=True, trim="-")
    return f"{mantissa}e{'+' if e > 0 else '-'}{abs(e)}"


def _timestamp_strs(values: np.ndarray, unit: str) -> List[str]:
    if unit in ("date32", "date64"):
        return list(np.datetime_as_string(values.astype("datetime64[D]")))
    digits = _FRACTION_DIGITS[unit]
    text = np.datetime_as_string(values, unit=unit if digits else "s")
    return [t.replace("T", " ") for t in text]


def _string_view(data: Dataset, name: str) -> Tuple[np.ndarray, List[Optional[str]]]:
    """(int32 codes, -1 = null; the entries as strings, None for a null
    entry) of a column: a string column's own dictionary, another
    column's distinct values as Arrow casts them to strings."""
    kind = data.schema.kind_of(name)
    if kind == Kind.UNKNOWN:  # a null-typed column: every row is null
        return np.full(data.num_rows, -1, dtype=np.int32), []
    codes = data.materialize(ColumnRequest(name, "codes"))
    dictionary = data.dictionary(name)
    if kind == Kind.STRING:
        return codes, list(dictionary)
    if kind == Kind.BOOLEAN:
        return codes, ["true" if v else "false" for v in dictionary]
    if kind == Kind.TIMESTAMP:
        return codes, _timestamp_strs(dictionary, data.timestamp_unit(name))
    if dictionary.dtype.kind == "f":
        return codes, [_float_str(v) for v in dictionary]
    return codes, [str(int(v)) for v in dictionary]


def _per_entry(entries: List[Optional[str]], test: Callable[[str], object]) -> np.ndarray:
    """``test`` of each non-null entry, with a False slot appended for
    the null code, so ``out[codes]`` reads every row's result."""
    out = np.zeros(len(entries) + 1, dtype=bool)
    for i, v in enumerate(entries):
        out[i] = v is not None and bool(test(v))
    return out


def _gather(table: np.ndarray, codes: np.ndarray) -> np.ndarray:
    return table[np.where(codes < 0, len(table) - 1, codes)]


def _parse_int(v: str) -> Optional[int]:
    return int(v.strip()) if _INT_RE.search(v) else None


def _parse_timestamp_ms(v: str, fmt: str) -> Optional[int]:
    try:
        delta = datetime.strptime(v, fmt) - _EPOCH
    except ValueError:
        return None
    return (delta.days * 86_400 + delta.seconds) * 1000 + delta.microseconds // 1000


def _parsed(entries, parse) -> Tuple[list, np.ndarray]:
    """Each entry's parsed value (None where it does not parse), and
    whether it parsed, with the null slot appended."""
    values = [None if v is None else parse(v) for v in entries] + [None]
    return values, np.array([v is not None for v in values], dtype=bool)


def _check_column(definition: ColumnDefinition, data: Dataset) -> np.ndarray:
    """Each row's validity under one definition."""
    name = definition.name
    kind = data.schema.kind_of(name)
    is_null = ~data.materialize(ColumnRequest(name, "mask"))
    if isinstance(definition, IntColumnDefinition):
        if kind == Kind.INTEGRAL:
            valid = ~is_null
            numeric = data.materialize(ColumnRequest(name, "values"))
            in_range = np.ones(data.num_rows, dtype=bool)
            if definition.min_value is not None:
                in_range &= numeric >= definition.min_value
            if definition.max_value is not None:
                in_range &= numeric <= definition.max_value
            valid = valid & in_range
        else:
            codes, entries = _string_view(data, name)
            parsed, ok = _parsed(entries, _parse_int)
            for i, v in enumerate(parsed):
                if v is not None and (
                    (definition.min_value is not None and v < definition.min_value)
                    or (definition.max_value is not None and v > definition.max_value)
                ):
                    ok[i] = False
            valid = _gather(ok, codes)
    elif isinstance(definition, FractionalColumnDefinition) and kind in (
        Kind.INTEGRAL, Kind.FRACTIONAL,
    ):
        valid = ~is_null
    elif isinstance(definition, TimestampColumnDefinition) and kind == Kind.TIMESTAMP:
        valid = ~is_null
    else:
        codes, entries = _string_view(data, name)
        if isinstance(definition, StringColumnDefinition):
            lo, hi, pattern = definition.min_length, definition.max_length, definition.matches
            regex = None if pattern is None else re.compile(pattern)

            def test(v):
                return (
                    (lo is None or len(v) >= lo)
                    and (hi is None or len(v) <= hi)
                    and (regex is None or regex.search(v))
                )

            ok = _per_entry(entries, test)
        elif isinstance(definition, FractionalColumnDefinition):
            ok = _per_entry(entries, _FRACTIONAL_RE.search)
        elif isinstance(definition, DecimalColumnDefinition):
            ok = _per_entry(
                entries, _decimal_regex(definition.precision, definition.scale).search
            )
        elif isinstance(definition, TimestampColumnDefinition):
            fmt = java_mask_to_strptime(definition.mask)
            ok = _parsed(entries, lambda v: _parse_timestamp_ms(v, fmt))[1]
        else:
            raise TypeError(f"unknown column definition {type(definition)}")
        valid = _gather(ok, codes) & ~is_null
    if definition.is_nullable:
        return valid | is_null
    return valid & ~is_null


def _typed_column(definition: ColumnDefinition, data: Dataset):
    """The declared type of a column of the valid rows, as
    ``Dataset.with_columns`` reads it."""
    name = definition.name
    kind = data.schema.kind_of(name)
    mask = data.materialize(ColumnRequest(name, "mask"))
    if isinstance(definition, IntColumnDefinition) and kind == Kind.INTEGRAL:
        values = data.materialize(ColumnRequest(name, "values")).astype(np.int64)
        return np.ma.array(values, mask=~mask)
    if isinstance(definition, (FractionalColumnDefinition, DecimalColumnDefinition)) and (
        kind in (Kind.INTEGRAL, Kind.FRACTIONAL)
    ):
        values = data.materialize(ColumnRequest(name, "values")).astype(np.float64)
        return np.ma.array(values, mask=~mask)
    if isinstance(definition, TimestampColumnDefinition) and kind == Kind.TIMESTAMP:
        return None  # kept as it is
    codes, entries = _string_view(data, name)
    if isinstance(definition, IntColumnDefinition):
        parsed, ok = _parsed(entries, _parse_int)
        table = np.array([0 if v is None else v for v in parsed], dtype=np.int64)
        return np.ma.array(_gather(table, codes), mask=~_gather(ok, codes))
    if isinstance(definition, (FractionalColumnDefinition, DecimalColumnDefinition)):
        parsed, ok = _parsed(entries, lambda v: float(v.strip()))
        table = np.array([0.0 if v is None else v for v in parsed], dtype=np.float64)
        return np.ma.array(_gather(table, codes), mask=~_gather(ok, codes))
    if isinstance(definition, TimestampColumnDefinition):
        fmt = java_mask_to_strptime(definition.mask)
        parsed, ok = _parsed(entries, lambda v: _parse_timestamp_ms(v, fmt))
        table = np.array([0 if v is None else v for v in parsed], dtype=np.int64)
        return np.ma.array(
            _gather(table, codes).astype("datetime64[ms]"), mask=~_gather(ok, codes)
        )
    return DictionaryColumn(codes, np.asarray(entries, dtype=object))


class RowLevelSchemaValidator:
    @staticmethod
    def validate(data: Dataset, schema: RowLevelSchema) -> RowLevelSchemaValidationResult:
        row_valid = np.ones(data.num_rows, dtype=bool)
        for definition in schema.definitions:
            if not data.schema.has_column(definition.name):
                raise KeyError(f"schema references unknown column {definition.name!r}")
            row_valid &= _check_column(definition, data)

        valid = data.filter_rows(row_valid)
        typed = {}
        for definition in schema.definitions:
            column = _typed_column(definition, valid)
            if column is not None:
                typed[definition.name] = column
        valid_typed = valid.with_columns(typed)
        invalid = data.filter_rows(~row_valid)
        return RowLevelSchemaValidationResult(
            valid_rows=valid_typed,
            num_valid_rows=valid_typed.num_rows,
            invalid_rows=invalid,
            num_invalid_rows=invalid.num_rows,
        )
