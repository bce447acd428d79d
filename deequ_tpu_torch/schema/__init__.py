"""Row-level schema validation."""

from deequ_tpu_torch.schema.validator import (
    ColumnDefinition,
    DecimalColumnDefinition,
    FractionalColumnDefinition,
    IntColumnDefinition,
    RowLevelSchema,
    RowLevelSchemaValidationResult,
    RowLevelSchemaValidator,
    StringColumnDefinition,
    TimestampColumnDefinition,
)

__all__ = [
    "ColumnDefinition",
    "DecimalColumnDefinition",
    "FractionalColumnDefinition",
    "IntColumnDefinition",
    "RowLevelSchema",
    "RowLevelSchemaValidationResult",
    "RowLevelSchemaValidator",
    "StringColumnDefinition",
    "TimestampColumnDefinition",
]
