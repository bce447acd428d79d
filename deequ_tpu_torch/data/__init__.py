from deequ_tpu_torch.data.table import (
    ROW_MASK,
    ColumnRequest,
    Dataset,
    DictionaryColumn,
    Kind,
    Schema,
)

__all__ = ["ROW_MASK", "ColumnRequest", "Dataset", "DictionaryColumn", "Kind", "Schema"]
