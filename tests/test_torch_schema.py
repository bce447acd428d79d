"""The row-level schema validator of deequ_tpu_torch against the JAX package.

The same columns (the cases of ``tests/test_schema.py``, and typed,
dictionary-typed and timestamp inputs) go through
``RowLevelSchemaValidator.validate`` of both packages. Held exactly: the
valid and invalid row counts, and both splits row for row in every
column, with each column's kind (the valid split carries the declared
types; the invalid split the raw values). Timestamps compare as epoch
milliseconds, parsed floats exactly.

Two divergences are held apart, each by a test of its own: the JAX
package raises on an int column value with a plus sign inside the
bounds check (Arrow's cast refuses "+8"), where the port reads 8; and
Arrow's strptime reads a day past the end of its month as a day of the
next month (2023-02-29 as 2023-03-01), a year of fewer than four digits
and leading blanks, all of which ``datetime.strptime`` in the port
refuses.
"""

import numpy as np
import pyarrow as pa
import pytest

import deequ_tpu as R
from deequ_tpu.schema import RowLevelSchema as RSchema
from deequ_tpu.schema import RowLevelSchemaValidator as RValidator

import deequ_tpu_torch as T
from deequ_tpu_torch.data.table import ColumnRequest, Kind
from deequ_tpu_torch.schema import RowLevelSchema as TSchema
from deequ_tpu_torch.schema import RowLevelSchemaValidator as TValidator
from deequ_tpu_torch.schema.validator import _float_str


def _arrow_kind(typ):
    if pa.types.is_dictionary(typ):
        typ = typ.value_type
    if pa.types.is_boolean(typ):
        return Kind.BOOLEAN
    if pa.types.is_integer(typ):
        return Kind.INTEGRAL
    if pa.types.is_floating(typ):
        return Kind.FRACTIONAL
    if pa.types.is_timestamp(typ) or pa.types.is_date(typ):
        return Kind.TIMESTAMP
    if pa.types.is_null(typ):
        return Kind.UNKNOWN
    return Kind.STRING


def _reference_rows(column):
    if pa.types.is_timestamp(column.type):
        column = column.cast(pa.int64())
    return column.to_pylist()


def _port_rows(ds, name):
    mask = ds.materialize(ColumnRequest(name, "mask"))
    if ds.schema.kind_of(name) == Kind.STRING:
        codes, dictionary = ds.materialize(ColumnRequest(name, "codes")), ds.dictionary(name)
        return [dictionary[k] if k >= 0 else None for k in codes]
    values = ds.materialize(ColumnRequest(name, "values"))
    if ds.schema.kind_of(name) == Kind.BOOLEAN:
        values = values.astype(bool)
    return [v.item() if m else None for v, m in zip(values, mask)]


def assert_split_equal(rds, tds):
    table = rds.table
    assert tds.num_rows == table.num_rows
    assert tds.schema.column_names == table.schema.names
    for name in table.schema.names:
        assert tds.schema.kind_of(name) == _arrow_kind(table.column(name).type), name
        assert _port_rows(tds, name) == _reference_rows(table.column(name)), name


def _validate_both(data, define):
    if isinstance(data, pa.Table):
        rds, tds = R.Dataset.from_arrow(data), T.Dataset.from_arrow(data)
    else:
        rds, tds = R.Dataset.from_pydict(data), T.Dataset.from_pydict(data)
    ref = RValidator.validate(rds, define(RSchema()))
    port = TValidator.validate(tds, define(TSchema()))
    assert (port.num_valid_rows, port.num_invalid_rows) == (ref.num_valid_rows, ref.num_invalid_rows)
    assert_split_equal(ref.valid_rows, port.valid_rows)
    assert_split_equal(ref.invalid_rows, port.invalid_rows)
    return ref, port


CSV = {
    "id": ["1", "2", "three", "4", None],
    "name": ["a", "bb", "ccc", None, "e"],
    "ts": ["2024-01-01 00:00:00", "2024-06-15 12:30:00", "2024-01-01 00:00:00",
           "not a date", "2024-01-01 00:00:00"],
}

CASES = {
    "mixed_csv_style": (CSV, lambda s: s.with_int_column("id", is_nullable=False)
                        .with_string_column("name", is_nullable=True, max_length=2)
                        .with_timestamp_column("ts", mask="yyyy-MM-dd HH:mm:ss")),
    "int_bounds": ({"x": ["5", "15", "-3", "7", " 8 ", "1234567890123456789"]},
                   lambda s: s.with_int_column("x", min_value=0, max_value=10)),
    "string_regex_and_lengths": (
        {"code": ["AB-1", "XY-2", "bad", "AB-33", None, "AB-1"]},
        lambda s: s.with_string_column("code", is_nullable=False, min_length=4, max_length=5,
                                       matches=r"^[A-Z]{2}-\d+$")),
    "nullable": ({"x": ["1", None, "2"]}, lambda s: s.with_int_column("x", is_nullable=True)),
    "not_nullable": ({"x": ["1", None, "2"]}, lambda s: s.with_int_column("x", is_nullable=False)),
    "decimal_precision_scale": ({"d": ["12.34", "1.2", "123.45", "1.234", "x", "-0.5", ".5"]},
                                lambda s: s.with_decimal_column("d", precision=4, scale=2)),
    "decimal_scale_0": ({"d": ["12", "12.0", "123456", None]},
                        lambda s: s.with_decimal_column("d", precision=5, scale=0,
                                                        is_nullable=False)),
    "fractional": ({"f": ["1.5", "2", "abc", "1e3", " -.25 ", "1.", "e5"]},
                   lambda s: s.with_fractional_column("f", is_nullable=False)),
    "typed_int_passthrough": ({"x": [1, 2, None]},
                              lambda s: s.with_int_column("x", is_nullable=False)),
    "typed_int_bounds": ({"x": [1, 20, None, -4]},
                         lambda s: s.with_int_column("x", min_value=0, max_value=10)),
    "undeclared_columns": ({"x": ["1", "2", "z"], "extra": ["p", "q", "r"]},
                           lambda s: s.with_int_column("x")),
    "typed_as_strings": (
        {"n": [1, 22, None, 4], "f": [1.5, 2.0, 1e20, None], "b": [True, False, None, True]},
        lambda s: s.with_string_column("n", max_length=1).with_string_column("f", min_length=2)
        .with_string_column("b", matches="^t")),
    "typed_floats_as_decimal": ({"f": [1.5, 2.0, 123.456, -0.25, None]},
                                lambda s: s.with_decimal_column("f", precision=5, scale=2)),
    "fractional_over_numbers": ({"i": [1, None, 3], "f": [0.5, 1.5, None]},
                                lambda s: s.with_fractional_column("i")
                                .with_fractional_column("f", is_nullable=False)),
    "bool_as_int": ({"b": [True, False, None]}, lambda s: s.with_int_column("b")),
    "date_mask": ({"d": ["2024-02-29", "2024-1-5", "2024-13-01", "2024-01-01x", None]},
                  lambda s: s.with_timestamp_column("d", mask="yyyy-MM-dd")),
    "millisecond_mask": (
        {"t": ["2024-01-01 10:00:00.123", "2024-01-01 10:00:00", "2024-01-01 10:00:00.5"]},
        lambda s: s.with_timestamp_column("t", mask="yyyy-MM-dd HH:mm:ss.SSS")),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_validation_matches_reference(case):
    data, define = CASES[case]
    _validate_both(data, define)


def test_arrow_inputs_match_reference():
    table = pa.table({
        "cat": pa.DictionaryArray.from_arrays(
            pa.array([0, 1, 2, None, 1], pa.int32()), pa.array(["ok", "also ok", "too long!"])),
        "ts": pa.array([0, 1_700_000_000_123, None, 5, 6], pa.timestamp("ms")),
        "q": pa.array([1, 2, 3, 4, 5], pa.int32()),
    })
    _validate_both(table, lambda s: s.with_string_column("cat", max_length=7)
                   .with_timestamp_column("ts", is_nullable=False).with_int_column("q", max_value=4))


def test_plus_signed_int_under_bounds_diverges():
    data = {"x": ["5", " +8 ", "+11"]}
    with pytest.raises(pa.ArrowInvalid):
        RValidator.validate(R.Dataset.from_pydict(data), RSchema().with_int_column("x", max_value=10))
    port = TValidator.validate(T.Dataset.from_pydict(data), TSchema().with_int_column("x", max_value=10))
    assert _port_rows(port.valid_rows, "x") == [5, 8]
    assert _port_rows(port.invalid_rows, "x") == ["+11"]


def test_lenient_arrow_dates_diverge():
    data = {"d": ["2023-02-29", "2024-04-31", "24-01-01", " 2024-01-01", "2024-01-01"]}
    ref = RValidator.validate(R.Dataset.from_pydict(data), RSchema().with_timestamp_column(
        "d", mask="yyyy-MM-dd"))
    port = TValidator.validate(T.Dataset.from_pydict(data), TSchema().with_timestamp_column(
        "d", mask="yyyy-MM-dd"))
    assert (ref.num_valid_rows, port.num_valid_rows) == (5, 1)
    assert _reference_rows(ref.valid_rows.table.column("d"))[0] == 1677628800000  # 2023-03-01
    assert _port_rows(port.invalid_rows, "d") == data["d"][:4]


def test_examples_of_test_schema_hold():
    """The assertions of tests/test_schema.py, on the port's result."""
    result = TValidator.validate(T.Dataset.from_pydict(CSV), CASES["mixed_csv_style"][1](TSchema()))
    assert (result.num_valid_rows, result.num_invalid_rows) == (2, 3)
    assert result.valid_rows.schema.kind_of("id") == Kind.INTEGRAL
    assert result.valid_rows.schema.kind_of("ts") == Kind.TIMESTAMP
    assert _port_rows(result.valid_rows, "id") == [1, 2]
    assert _port_rows(result.invalid_rows, "id") == ["three", "4", None]


def test_unknown_column_raises():
    with pytest.raises(KeyError):
        TValidator.validate(T.Dataset.from_pydict({"x": [1]}), TSchema().with_int_column("nope"))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_float_strings_match_arrow(dtype):
    rng = np.random.default_rng(1)
    values = np.concatenate([
        rng.standard_normal(200) * 10.0 ** rng.integers(-12, 14, 200),
        [0.0, -0.0, 1e-6, 1e-7, 1.5e-6, 1e9, 1e10, 1234567.0, 123456789.125, np.nan, np.inf,
         -np.inf, 1e20, 3e-300 if dtype == np.float64 else 3e-30],
    ]).astype(dtype)
    want = pa.array(values).cast(pa.string()).to_pylist()
    assert [_float_str(v) for v in values] == want
