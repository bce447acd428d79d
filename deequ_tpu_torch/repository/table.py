"""Table metrics repository: a directory of parquet files, one a save.

Counterpart of ``deequ_tpu/repository/table.py`` (the reference's Spark
table repository). Each ``save`` appends ONE parquet file of one row,
written under a dotted temporary name and renamed into place, so
concurrent writers never conflict and a reader never opens a half
written file. ``load_by_key`` filters the scan on the ``result_key``
column; ``load`` reads every row. The last write of a key wins, by a
write sequence (wall-clock nanoseconds, strictly increasing within one
writer), not by the order the files are listed in.

Row schema, the JAX module's, so either package reads the other's
directory (the ``serialized_context`` is ``repository/serde.py``'s JSON,
the JAX package's byte for byte):

- ``result_key`` — string, the canonical JSON of the key's date and tags
- ``dataset_date`` — int64, the key's date
- ``tags`` — string, the tags as a JSON object
- ``seq`` — int64, the write sequence
- ``serialized_context`` — string, the whole result
"""

from __future__ import annotations

import json
import os
import time
import uuid
from typing import List, Optional

import pyarrow as pa
import pyarrow.compute as pc
import pyarrow.dataset as pads
import pyarrow.parquet as pq

from deequ_tpu_torch.repository import serde
from deequ_tpu_torch.repository.base import (
    AnalysisResult,
    MetricsRepository,
    MetricsRepositoryMultipleResultsLoader,
    ResultKey,
)

_SCHEMA = pa.schema([
    ("result_key", pa.string()),
    ("dataset_date", pa.int64()),
    ("tags", pa.string()),
    ("seq", pa.int64()),
    ("serialized_context", pa.string()),
])
# a temporary file older than this is a crashed writer's, never a live one
_STALE_TMP_S = 3600


def _key_json(key: ResultKey) -> str:
    return json.dumps({"dataset_date": key.dataset_date, "tags": key.tags_dict}, sort_keys=True)


class TableMetricsRepository(MetricsRepository):
    """An append-only parquet-table repository (one file a save).

    Last-write-wins uses wall-clock nanoseconds made strictly increasing
    within this writer; across hosts the order is the clocks', as in any
    timestamp-ordered warehouse append."""

    def __init__(self, path: str):
        self._path = path
        self._last_seq = 0
        os.makedirs(path, exist_ok=True)
        # sweep the temporary files of crashed writers (reads ignore them)
        cutoff = time.time() - _STALE_TMP_S
        for name in os.listdir(path):
            if name.startswith(".") and name.endswith(".tmp"):
                full = os.path.join(path, name)
                try:
                    if os.path.getmtime(full) < cutoff:
                        os.remove(full)
                except OSError:
                    pass  # another writer removed it first

    def _next_seq(self) -> int:
        self._last_seq = max(time.time_ns(), self._last_seq + 1)
        return self._last_seq

    def save(self, result: AnalysisResult) -> None:
        key = result.result_key
        table = pa.table({
            "result_key": [_key_json(key)],
            "dataset_date": [int(key.dataset_date)],
            "tags": [json.dumps(key.tags_dict, sort_keys=True)],
            "seq": [self._next_seq()],
            "serialized_context": [serde.serialize([result])],
        }, schema=_SCHEMA)
        name = f"{key.dataset_date}-{uuid.uuid4().hex}.parquet"
        tmp = os.path.join(self._path, f".{name}.tmp")
        pq.write_table(table, tmp)
        os.rename(tmp, os.path.join(self._path, name))

    def _scan(self, filter_expr=None) -> List[AnalysisResult]:
        files = sorted(os.path.join(self._path, f) for f in os.listdir(self._path)
                       if f.endswith(".parquet"))
        if not files:
            return []
        table = pads.dataset(files, format="parquet").to_table(
            columns=["result_key", "seq", "serialized_context"], filter=filter_expr)
        latest: dict = {}
        for key_json, seq, payload in zip(table.column("result_key").to_pylist(),
                                          table.column("seq").to_pylist(),
                                          table.column("serialized_context").to_pylist()):
            prior = latest.get(key_json)
            if prior is None or seq > prior[0]:
                latest[key_json] = (seq, payload)
        out: List[AnalysisResult] = []
        for _, payload in latest.values():
            out.extend(serde.deserialize(payload))
        # the same order whatever order the files are listed in
        out.sort(key=lambda r: (r.result_key.dataset_date, _key_json(r.result_key)))
        return out

    def load_by_key(self, key: ResultKey) -> Optional[AnalysisResult]:
        for result in self._scan(pc.field("result_key") == _key_json(key)):
            if result.result_key == key:
                return result
        return None

    def load(self) -> MetricsRepositoryMultipleResultsLoader:
        return MetricsRepositoryMultipleResultsLoader(self._scan())
