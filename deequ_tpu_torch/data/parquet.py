"""Parquet sources: a Dataset over parquet files, streamed without
holding whole columns.

Counterpart of ``deequ_tpu/data/parquet.py``. :class:`ParquetDataset`
answers the :class:`~deequ_tpu_torch.data.table.Dataset` contract over
a parquet file or a directory of them:

- **Streamed** (``host_batches``, and the ordered ingest pool's
  ``ingest_work_items``): Arrow record batches are read column-pruned,
  cut at engine-batch boundaries, and converted to host representations
  batch by batch (``_IngestItem.decode``, order-free, on any thread).
  Host memory stays a few batches of the requested columns.
- **One-pass dictionary deltas** (``config.dict_deltas``, the default):
  a string column's codes index a dictionary that grows inside the same
  pass. ``decode`` encodes the batch against its OWN first-seen
  dictionary; ``commit``, run in batch order, appends that dictionary's
  new values to the column's accumulator (:class:`_IncrementalDict`),
  maps the local codes to the accumulator's, and cuts the new values as
  a delta ``{"start", "values"}`` that rides the batch
  (``DICT_DELTA_PREFIX``) to the delta-carrying ops' states. The
  accumulator's values and order equal those of the dictionary
  pre-pass (``_collect_uniques``), whatever the batch cuts. With the
  flag off, or for a column whose dictionary is known to exceed
  ``dict_delta_capacity``, the pre-pass builds the dictionary first;
  each pre-pass counts a data pass (``Dataset.prepasses``).
- **Resident** (``device_batches``): a requested column is read whole
  at first use (``_columns`` fills lazily), and the in-memory path runs.
- **Statistics**: null counts (no mask ships for a column without
  nulls) and integral ranges come from the row groups' statistics,
  without reading the data.

- **Restarts** (``start_batch``, a retry or a checkpoint's resume):
  the stream skips the rows of the earlier batches, so batch ``i`` of a
  restarted stream is batch ``i`` of a whole one. Each delta column's
  accumulator remembers how many rows it has absorbed; a restart past
  them (a resume in a fresh ``Dataset``) first absorbs the skipped rows
  of the delta columns alone, so the codes and the dictionaries equal
  an uninterrupted scan's. Deltas ship from 0 again after a restart, as
  the JAX package ships them; writing a table's entries again changes
  none of them. ``fingerprint`` names the files, their sizes and times.

- **Shards** (``shard_row_groups``, ``shard_view``): a mesh rank's
  part of the source is a ``ParquetDataset`` of its own over the row
  groups assigned to it, with its own dictionaries; every rank computes
  the same assignment from the files' metadata, and a shard's
  fingerprint carries its ``(index, count)`` tag.
"""

from __future__ import annotations

import hashlib
import os
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pyarrow.dataset as pads

from deequ_tpu_torch import config
from deequ_tpu_torch.data.table import (
    DICT_DELTA_PREFIX,
    ColumnRequest,
    Dataset,
    Field,
    Kind,
    Schema,
    _arrow_column,
    _Column,
)


def dictionary_to_numpy(dictionary: pa.Array) -> np.ndarray:
    """A dictionary's values as numpy: an object array of strings, the
    native dtype otherwise (datetime64 for timestamps, Decimal objects
    for decimals), as the JAX package reads it."""
    if pa.types.is_string(dictionary.type) or pa.types.is_large_string(dictionary.type):
        return np.asarray(dictionary.to_pylist(), dtype=object)
    return dictionary.to_numpy(zero_copy_only=False)


def _plain(column: pa.Array) -> pa.Array:
    """A dictionary-typed array as its values' type (chunks may carry
    different local dictionaries)."""
    if pa.types.is_dictionary(column.type):
        return pc.cast(column, column.type.value_type)
    return column


def _int32_codes(indices: pa.Array) -> np.ndarray:
    """Arrow indices (nulls for missing) as writable int32 codes, -1 null."""
    filled = pc.fill_null(pc.cast(indices, pa.int32()), pa.scalar(-1, pa.int32()))
    return np.array(filled.to_numpy(zero_copy_only=False), dtype=np.int32)


class _IncrementalDict:
    """One column's dictionary, grown batch by batch inside the pass:
    ``absorb`` appends a batch's new values in first-seen order, so the
    accumulator equals the pre-pass's dictionary (values and order)
    over the same rows, however the batches are cut. ``rows`` is how
    far into the stream it has absorbed."""

    __slots__ = ("values", "n", "rows")

    def __init__(self) -> None:
        self.values: Optional[pa.Array] = None
        self.n = 0
        self.rows = 0

    def absorb(self, uniques: pa.Array) -> np.ndarray:
        """Append the values of ``uniques`` (distinct, first-seen order)
        that the accumulator does not hold yet; returns the accumulator's
        int32 code of each value of ``uniques`` (one hash of the
        accumulator serves both)."""
        if self.values is None or self.n == 0:
            if len(uniques):
                self.values, self.n = uniques, len(uniques)
            return np.arange(len(uniques), dtype=np.int32)
        idx = pc.index_in(uniques, value_set=self.values)
        missing = np.asarray(pc.is_null(idx).to_numpy(zero_copy_only=False))
        codes = _int32_codes(idx)
        if missing.any():
            codes[missing] = self.n + np.arange(int(missing.sum()), dtype=np.int32)
            self.values = pa.concat_arrays([self.values, uniques.filter(pa.array(missing))])
            self.n = len(self.values)
        return codes

    def slice_values(self, start: int) -> np.ndarray:
        """Values [start, n): one delta payload's ``values``."""
        return dictionary_to_numpy(self.values.slice(start, self.n - start))


def _local_encode(column: pa.Array):
    """(int32 codes, dictionary) of one batch against its own first-seen
    dictionary: the order-free half of a delta column's encode."""
    enc = pc.dictionary_encode(_plain(column))
    return _int32_codes(enc.indices), enc.dictionary


def _column_batch_to_reprs(column: pa.Array, kind: Kind, reprs: Sequence[str],
                           value_set: Optional[pa.Array]) -> Dict[str, np.ndarray]:
    """One batch of one column as the requested host representations,
    by ``Dataset.from_arrow``'s rules (``_arrow_column``): ``values``,
    ``bits`` and ``mask``; a string column's ``lengths`` (utf8 code
    points, null 0) and ``codes`` against ``value_set`` (the column's
    whole dictionary; a delta column's codes are cut in ``commit``)."""
    out: Dict[str, np.ndarray] = {}
    column = _plain(column) if kind == Kind.STRING else column
    if "values" in reprs or "bits" in reprs:
        col = _arrow_column(column)
        for r in ("values", "bits"):
            if r in reprs:
                arr = getattr(col, r)
                if arr is None:
                    raise TypeError(f"a {kind.value} column has no {r!r} repr")
                out[r] = arr
        mask = col.mask
    elif column.null_count == 0:
        mask = np.ones(len(column), dtype=bool)
    else:
        mask = ~np.asarray(column.is_null().to_numpy(zero_copy_only=False))
    if "mask" in reprs:
        out["mask"] = mask
    if "lengths" in reprs:
        lengths = pc.fill_null(pc.utf8_length(column), pa.scalar(0, pa.int32()))
        out["lengths"] = np.array(lengths.to_numpy(zero_copy_only=False), dtype=np.int32)
    if "codes" in reprs and value_set is not None:
        out["codes"] = _int32_codes(pc.index_in(column, value_set=value_set))
    return out


class ParquetDataset(Dataset):
    """A Dataset over parquet file(s) or a directory, read lazily."""

    # the engine spreads a streamed scan of this class over the ordered
    # ingest pool (``ingest_work_items``)
    supports_parallel_ingest = True

    def __init__(self, source, read_batch_rows: int = 1 << 20):
        # no Dataset.__init__: there is no table in memory
        self._source = (source if isinstance(source, pads.Dataset)
                        else pads.dataset(source, format="parquet"))
        self._read_batch_rows = int(read_batch_rows)
        schema = self._source.schema
        self._schema = Schema(tuple(
            Field(name, _arrow_column(pa.array([], type=typ)).kind)
            for name, typ in zip(schema.names, schema.types)
        ))
        self._num_rows = self._source.count_rows()
        # whole columns read for a resident scan, at first use
        self._columns = _LazyColumns(self._load_column)
        self._device_cache = {}
        self._predicate_cache = {}
        # the columns' whole dictionaries (numpy) and value sets (Arrow)
        self._dictionaries: Dict[str, np.ndarray] = {}
        self._value_sets: Dict[str, pa.Array] = {}
        # one-pass deltas: each column's accumulator (kept across calls,
        # so a later pass continues the grown dictionary) and the columns
        # a plan committed to delta mode (``dict_delta_capacity``)
        self._delta_dicts: Dict[str, _IncrementalDict] = {}
        self._delta_columns: set = set()
        self._null_counts: Dict[str, int] = {}
        self._ranges: Dict[str, Optional[tuple]] = {}
        self.prepasses = 0
        # (index, count) of a shard view, None for the whole source
        self._shard_tag: Optional[tuple] = None

    # -- metadata -------------------------------------------------------

    def fingerprint(self) -> str:
        """The source's identity for checkpoints: the sorted files, each
        with its size and modification time (a rewritten, appended or
        touched file changes it), and the row count."""
        h = hashlib.sha1()
        for path in sorted(self._source.files):
            h.update(path.encode())
            try:
                st = os.stat(path)
                h.update(f":{st.st_size}:{st.st_mtime_ns}".encode())
            except OSError:
                pass
        if self._shard_tag is not None:
            # two shards of the same files never share a checkpoint
            h.update(f"shard:{self._shard_tag[0]}/{self._shard_tag[1]}".encode())
        h.update(str(self._num_rows).encode())
        return f"parquet-{h.hexdigest()[:20]}"

    @property
    def table(self) -> pa.Table:
        """Every row of every column (reads the whole source)."""
        return self._source.to_table()

    @property
    def num_columns(self) -> int:
        return len(self._schema)

    def record_batches(self, columns: Sequence[str],
                       batch_rows: int = 1 << 20) -> Iterator[pa.RecordBatch]:
        scanner = self._source.scanner(columns=list(columns), batch_size=batch_rows)
        return iter(scanner.to_batches())

    def _in_memory(self, columns: Optional[Sequence[str]] = None) -> Dataset:
        table = self._source.to_table(columns=None if columns is None else list(columns))
        return Dataset.from_arrow(table)

    def filter_rows(self, mask: np.ndarray) -> Dataset:
        return self._in_memory().filter_rows(mask)

    def slice_rows(self, start: int, stop: int) -> Dataset:
        return self._in_memory().slice_rows(start, stop)

    def with_columns(self, columns) -> Dataset:
        return self._in_memory().with_columns(columns)

    def select(self, columns: Sequence[str]) -> Dataset:
        return self._in_memory(columns)

    # -- shards of a mesh run ---------------------------------------------

    def shard_row_groups(self, process_index: int, process_count: int) -> list:
        """This rank's row-group fragments, in source order: every row
        group of the path-sorted files, largest first (ties in source
        order), goes to the least-loaded rank by rows (ties to the lower
        index), as the JAX package assigns them. Every rank computes the
        same whole assignment from the metadata, so the shards cover the
        source disjointly with no coordination."""
        if process_count <= 0:
            raise ValueError("process_count must be positive")
        if not 0 <= process_index < process_count:
            raise ValueError(f"process_index {process_index} outside [0, {process_count})")
        groups = []  # (rows, file order, row-group order, fragment)
        fragments = sorted(self._source.get_fragments(), key=lambda f: f.path)
        for fi, fragment in enumerate(fragments):
            meta = fragment.metadata
            for gi, sub in enumerate(fragment.split_by_row_group()):
                groups.append((int(meta.row_group(gi).num_rows), fi, gi, sub))
        loads = [0] * process_count
        assign: list = [[] for _ in range(process_count)]
        for rows, fi, gi, sub in sorted(groups, key=lambda g: (-g[0], g[1], g[2])):
            p = min(range(process_count), key=lambda i: (loads[i], i))
            loads[p] += rows
            assign[p].append((fi, gi, sub))
        return [sub for _, _, sub in sorted(assign[process_index], key=lambda a: (a[0], a[1]))]

    def shard_view(self, process_index: int, process_count: int) -> "ParquetDataset":
        """This rank's shard as a ``ParquetDataset`` of its own: reads
        touch only its row groups, its dictionaries are its own, its row
        count comes from the row groups' metadata (pyarrow counts a
        row-group fragment's whole file), and its fingerprint carries
        ``(process_index, process_count)``."""
        fragments = self.shard_row_groups(process_index, process_count)
        view = ParquetDataset(
            pads.FileSystemDataset(fragments, self._source.schema, self._source.format,
                                   self._source.filesystem),
            self._read_batch_rows,
        )
        view._shard_tag = (int(process_index), int(process_count))
        view._num_rows = sum(int(rg.num_rows) for f in fragments for rg in f.row_groups)
        return view

    def _arrow_type(self, column: str) -> pa.DataType:
        return self._source.schema.field(column).type

    def _meta(self, column: str) -> _Column:
        """The column's reading at zero rows: its kind, dtypes and units,
        with no data read."""
        return _arrow_column(pa.array([], type=self._arrow_type(column)))

    def request_dtype(self, req: ColumnRequest) -> np.dtype:
        if req.repr in ("codes", "lengths"):
            return np.dtype(np.int32)
        if req.repr == "mask":
            return np.dtype(bool)
        arr = getattr(self._meta(req.column), req.repr)
        if arr is None:
            raise TypeError(f"column {req.column!r} has no {req.repr!r} repr")
        return arr.dtype

    def _request_row_bytes(self, req: ColumnRequest) -> int:
        if req.repr == "mask":
            return 0 if self._is_all_valid(req.column) else 1
        if req.repr in ("codes", "lengths"):
            return 4
        return self.request_dtype(req).itemsize

    # -- row-group statistics ---------------------------------------------

    def _row_group_stats(self, column: str):
        """Each row group's statistics of the column (None where a group
        has none)."""
        idx = self._source.schema.get_field_index(column)
        for fragment in self._source.get_fragments():
            meta = fragment.metadata
            # a shard's fragments hold only their assigned row groups
            for rg in fragment.row_groups:
                yield meta.row_group(rg.id).column(idx).statistics

    def _is_all_valid(self, column: str) -> bool:
        """No null row, by the statistics' null counts (a row group
        without them counts as having nulls)."""
        if column not in self._null_counts:
            total = 0
            for stats in self._row_group_stats(column):
                if stats is None or stats.null_count is None:
                    total = 1
                    break
                total += stats.null_count
            self._null_counts[column] = total
        return self._null_counts[column] == 0

    def _stats_min_max(self, column: str):
        """(min, max) over every row group's statistics, or None when a
        group lacks them."""
        lo = hi = None
        for stats in self._row_group_stats(column):
            if stats is None or not stats.has_min_max or stats.min is None or stats.max is None:
                return None
            lo = stats.min if lo is None else min(lo, stats.min)
            hi = stats.max if hi is None else max(hi, stats.max)
        return None if lo is None else (lo, hi)

    def integral_range(self, column: str):
        """(min, max) of an INTEGRAL column from the statistics, with no
        data read; None without them (unbounded)."""
        if self._schema.kind_of(column) != Kind.INTEGRAL:
            return None
        if column not in self._ranges:
            rng = self._stats_min_max(column)
            self._ranges[column] = (
                (int(rng[0]), int(rng[1])) if rng is not None and isinstance(rng[0], int) else None
            )
        return self._ranges[column]

    # -- dictionaries -----------------------------------------------------

    def _dict_delta_mode(self, column: str) -> bool:
        """Whether the column's codes ship as deltas inside the pass: a
        column committed by ``dict_delta_capacity`` stays so; otherwise
        the flag and the kind decide, unless the dictionary is already
        known to exceed the capacity."""
        if column in self._delta_columns:
            return True
        opts = config.options()
        if not opts.dict_deltas or self._schema.kind_of(column) != Kind.STRING:
            return False
        d = self._dictionaries.get(column)
        return d is None or len(d) <= opts.dict_delta_capacity

    def dict_delta_capacity(self, column: str) -> Optional[int]:
        """The delta lookup tables' width for the planner (None: the
        column's codes ship no deltas, so build the consts form). Asking
        COMMITS the column to delta mode."""
        if not self._dict_delta_mode(column):
            return None
        self._delta_columns.add(column)
        return int(config.options().dict_delta_capacity)

    def _collect_uniques(self, column: str, cap: Optional[int]) -> Optional[pa.Array]:
        """The pre-pass: the column's distinct non-null values in
        first-seen order, staying in Arrow; None once they provably
        exceed ``cap``. Counts one data pass."""
        self.prepasses += 1
        base: Optional[pa.Array] = None
        fresh: List[pa.Array] = []
        fresh_n = 0

        def compact() -> None:
            nonlocal base, fresh, fresh_n
            base = pc.unique(pa.concat_arrays(([base] if base is not None else []) + fresh))
            fresh, fresh_n = [], 0

        scanner = self._source.scanner(columns=[column], batch_size=self._read_batch_rows)
        for batch in scanner.to_batches():
            u = pc.drop_null(pc.unique(_plain(batch.column(0))))
            if len(u):
                fresh.append(u)
                fresh_n += len(u)
            over_cap_maybe = cap is not None and (0 if base is None else len(base)) + fresh_n > cap
            if fresh_n > 4 * self._read_batch_rows or over_cap_maybe:
                compact()
                if cap is not None and len(base) > cap:
                    return None
        if fresh_n:
            compact()
        if base is None:
            typ = self._arrow_type(column)
            return pa.array([], typ.value_type if pa.types.is_dictionary(typ) else typ)
        return None if cap is not None and len(base) > cap else base

    def _store_dictionary(self, column: str, uniques: pa.Array) -> None:
        self._value_sets[column] = uniques
        self._dictionaries[column] = dictionary_to_numpy(uniques)

    def dictionary(self, column: str) -> np.ndarray:
        if column not in self._dictionaries:
            self._store_dictionary(column, self._collect_uniques(column, None))
        return self._dictionaries[column]

    def dictionary_size_within(self, column: str, cap: int) -> Optional[int]:
        """The distinct count if it is at most ``cap``, else None, from a
        pre-pass that stops once the cap is passed."""
        if column not in self._dictionaries:
            uniques = self._collect_uniques(column, cap)
            if uniques is None:
                return None
            self._store_dictionary(column, uniques)
        n = len(self._dictionaries[column])
        return n if n <= cap else None

    def _dict_value_set(self, column: str) -> pa.Array:
        self.dictionary(column)
        return self._value_sets[column]

    # -- whole columns (the resident path) --------------------------------

    def _read_column(self, column: str) -> pa.Array:
        table = self._source.to_table(columns=[column])
        chunks = [_plain(c) for c in table.column(0).chunks]
        if not chunks:
            return pa.array([], type=_plain(pa.array([], type=self._arrow_type(column))).type)
        return pa.concat_arrays(chunks)

    def _load_column(self, column: str) -> _Column:
        """The whole column, read once for a resident scan; a string
        column's codes index its whole dictionary."""
        arr = self._read_column(column)
        if self._schema.kind_of(column) == Kind.STRING:
            mask = ~np.asarray(arr.is_null().to_numpy(zero_copy_only=False))
            return _Column(Kind.STRING, mask, codes=self._codes_of(column, arr),
                           dictionary=self._dictionaries[column])
        col = _arrow_column(arr)
        # codes index the source's dictionary, built at first request
        col.codes = col.dictionary = None
        return col

    def _codes_of(self, column: str, arr: pa.Array) -> np.ndarray:
        return _int32_codes(pc.index_in(arr, value_set=self._dict_value_set(column)))

    def _encode(self, column: str) -> None:
        col = self._columns[column]
        col.codes = self._codes_of(column, self._read_column(column))
        col.dictionary = self._dictionaries[column]

    # -- streamed batches -------------------------------------------------

    def host_batches(self, requests: Sequence[ColumnRequest], batch_size: int,
                     start_batch: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        """The streamed scan's host batches on one thread: each work
        item decoded and committed in order (what the ingest pool does
        across threads)."""
        for item in self.ingest_work_items(requests, batch_size, start_batch):
            yield item.commit(item.decode())

    def _catch_up(self, columns: Sequence[str], rows: int) -> None:
        """Absorb rows [absorbed, rows) of each delta column into its
        accumulator, in stream order: a restart past what the
        accumulators saw (a resume in a fresh ``Dataset``) then codes
        its batches as an uninterrupted scan does. Reads the columns'
        prefix outside the scan, so it counts a pass (``prepasses``)."""
        behind = [c for c in columns if self._delta_dicts[c].rows < rows]
        if not behind:
            return
        self.prepasses += 1
        seen = 0
        scanner = self._source.scanner(columns=list(behind), batch_size=self._read_batch_rows)
        for record_batch in scanner.to_batches():
            lo, hi = seen, min(seen + record_batch.num_rows, rows)
            seen += record_batch.num_rows
            for ci, c in enumerate(behind):
                acc = self._delta_dicts[c]
                start = max(lo, acc.rows)
                if start < hi:
                    acc.absorb(_local_encode(record_batch.column(ci).slice(start - lo, hi - start))[1])
                    acc.rows = hi
            if seen >= rows:
                return

    def ingest_work_items(self, requests: Sequence[ColumnRequest], batch_size: int,
                          start_batch: int = 0):
        """The streamed scan as work items in batch order, for the ordered
        ingest pool: this generator only reads record batches and cuts
        Arrow slices at batch boundaries; ``item.decode()`` converts one
        batch (order-free, on any thread) and ``item.commit(decoded)``
        cuts its dictionary deltas (in batch order, on one thread).
        ``start_batch`` skips the rows of the earlier batches."""
        n = self._num_rows
        batch_size = max(1, int(batch_size))
        skip_rows = start_batch * batch_size
        keys = self._dedup_requests(requests)
        by_column: Dict[str, List[str]] = {}
        for r in keys.values():
            by_column.setdefault(r.column, []).append(r.repr)
        columns = sorted(by_column)
        if n == 0:
            return
        if not columns:
            for start in range(skip_rows, n, batch_size):
                yield _PrecomputedIngestItem(start // batch_size, min(batch_size, n - start), {})
            return
        delta_cols = sorted(c for c, reprs in by_column.items()
                            if "codes" in reprs and self._dict_delta_mode(c))
        plan = _IngestPlan(
            dataset=self, columns=columns, by_column=by_column,
            kinds={c: self._schema.kind_of(c) for c in columns},
            delta_cols=delta_cols,
            accs={c: self._delta_dicts.setdefault(c, _IncrementalDict()) for c in delta_cols},
            shipped_n={c: 0 for c in delta_cols},
            value_sets={c: self._dict_value_set(c) for c, reprs in by_column.items()
                        if "codes" in reprs and c not in delta_cols},
            start_batch=start_batch, batch_size=batch_size,
        )
        self._catch_up(delta_cols, skip_rows)
        pending: Dict[str, List[pa.Array]] = {c: [] for c in columns}
        pending_rows = 0
        index = start_batch
        # one item held back, so that the last one can carry final=True
        held: Optional[_IngestItem] = None

        def cut(force: bool):
            nonlocal pending_rows, index, held
            while pending_rows >= batch_size or (force and pending_rows > 0):
                width = min(pending_rows, batch_size)
                chunks: Dict[str, List[pa.Array]] = {}
                for c in columns:
                    taken: List[pa.Array] = []
                    rest: List[pa.Array] = []
                    got = 0
                    for arr in pending[c]:
                        if got >= width:
                            rest.append(arr)
                            continue
                        take = min(len(arr), width - got)
                        taken.append(arr if take == len(arr) else arr.slice(0, take))
                        if take < len(arr):
                            rest.append(arr.slice(take))
                        got += take
                    chunks[c] = taken
                    pending[c] = rest
                pending_rows -= width
                item = _IngestItem(index, width, plan, chunks)
                index += 1
                if held is not None:
                    yield held
                held = item

        scanner = self._source.scanner(columns=columns, batch_size=self._read_batch_rows)
        for record_batch in scanner.to_batches():
            if skip_rows > 0:
                if record_batch.num_rows <= skip_rows:
                    skip_rows -= record_batch.num_rows
                    continue
                record_batch = record_batch.slice(skip_rows)
                skip_rows = 0
            if record_batch.num_rows == 0:
                continue
            for ci, c in enumerate(columns):
                pending[c].append(record_batch.column(ci))
            pending_rows += record_batch.num_rows
            yield from cut(False)
        yield from cut(True)
        if held is not None:
            held.final = True
            yield held


class _LazyColumns(dict):
    """A dict of columns that reads a missing one on first access."""

    def __init__(self, load):
        super().__init__()
        self._load = load

    def __missing__(self, column: str) -> _Column:
        col = self[column] = self._load(column)
        return col


class _IngestPlan:
    """One ``ingest_work_items`` call's shared state: the conversion
    settings every item reads, and the accumulators and delta cursors
    that only ``commit`` touches, in batch order."""

    __slots__ = ("dataset", "columns", "by_column", "kinds", "delta_cols", "accs",
                 "shipped_n", "value_sets", "start_batch", "batch_size")

    def __init__(self, **kw):
        for k in self.__slots__:
            setattr(self, k, kw[k])


class _IngestItem:
    """One engine batch's ingest, in two stages:

    - ``decode()`` (any thread, order-free): concatenate the batch's Arrow
      slices, convert every requested repr, and encode each delta column
      against the batch's own dictionary;
    - ``commit(decoded)`` (one thread, in batch order): absorb each delta
      column's batch dictionary into its accumulator, map the batch's
      codes to the accumulator's, cut the delta payload, and after the
      last batch cache the completed dictionaries.

    ``deferred`` names the keys ``commit`` adds (the delta columns'
    int32 codes), so a packer can lay out the batch before them."""

    __slots__ = ("index", "width", "final", "_plan", "_chunks", "_local")

    def __init__(self, index: int, width: int, plan: _IngestPlan, chunks):
        self.index = index
        self.width = width
        self.final = False
        self._plan = plan
        self._chunks = chunks
        self._local = None

    @property
    def deferred(self) -> List[str]:
        return [f"{c}::codes" for c in self._plan.delta_cols]

    def decode(self) -> Dict[str, np.ndarray]:
        plan = self._plan
        batch: Dict[str, np.ndarray] = {}
        local = {}
        for c in plan.columns:
            chunks = [_plain(a) if plan.kinds[c] == Kind.STRING else a for a in self._chunks[c]]
            col = chunks[0] if len(chunks) == 1 else pa.concat_arrays(chunks)
            wanted = plan.by_column[c]
            if c in plan.accs:
                local[c] = _local_encode(col)
                wanted = [r for r in wanted if r != "codes"]
            for r, arr in _column_batch_to_reprs(col, plan.kinds[c], wanted,
                                                 plan.value_sets.get(c)).items():
                batch[f"{c}::{r}"] = arr
        self._local = local
        return batch

    def commit(self, decoded: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        plan = self._plan
        row_end = self.index * plan.batch_size + self.width
        for c, (codes, uniques) in (self._local or {}).items():
            acc = plan.accs[c]
            # the batch's dictionary -> the accumulator's codes; -1 stays -1
            to_global = np.append(acc.absorb(uniques), np.int32(-1))
            acc.rows = max(acc.rows, row_end)
            decoded[f"{c}::codes"] = to_global[codes]
            if acc.n > plan.shipped_n[c]:
                decoded[DICT_DELTA_PREFIX + c] = {
                    "start": plan.shipped_n[c], "values": acc.slice_values(plan.shipped_n[c]),
                }
                plan.shipped_n[c] = acc.n
        self._local = self._chunks = None
        if self.final and plan.start_batch == 0:
            # a whole stream saw every row: the accumulators ARE the
            # dictionaries, so no later read pays a pre-pass for them
            ds = plan.dataset
            for c in plan.delta_cols:
                if c not in ds._dictionaries and plan.accs[c].values is not None:
                    ds._store_dictionary(c, plan.accs[c].values)
        return decoded


class _PrecomputedIngestItem:
    """A batch that needs no conversion (no column requested: only its
    row count matters)."""

    __slots__ = ("index", "width", "final", "_batch")
    deferred: List[str] = []

    def __init__(self, index: int, width: int, batch):
        self.index = index
        self.width = width
        self.final = False
        self._batch = batch

    def decode(self):
        return self._batch

    def commit(self, decoded):
        return decoded
