"""Grouping (frequency-based) analyzers: CountDistinct, Distinctness,
Uniqueness, UniqueValueRatio, Entropy, MutualInformation, Histogram.

Counterpart of ``deequ_tpu/analyzers/grouping.py``. Analyzers over value
frequencies share one frequency table per distinct (grouping columns,
filter, null policy): the ``FrequenciesAndNumRows`` state. A plan takes
one of three paths (``plan_frequency_passes``):

- **dense**: the columns' dictionary codes (``Dataset.dictionary``,
  first-seen order) form a mixed-radix joint code, and a scatter-add
  counts it into a device vector that rides the shared fused scan;
- **spill** (``analyzers/spill.py``): a device sort and segment count,
  for high-cardinality numeric keys and joint keys past the dense
  budget; its keys are collected through the shared scan (one pass);
- **host**: a numpy group-by over the host columns, for key spaces that
  neither the dense budget nor two sort lanes hold, or plans the gates
  refuse.

Group order is part of the result (MutualInformation sums in key order,
Histogram's capped bins take ties in stored order): the dense path
decodes in dictionary order, and the host group-by and ``merge`` give
groups in first-seen order, the order of Arrow's ``dictionary_encode``.

Row semantics follow the reference: rows where ALL grouping columns are
null are excluded; Histogram keeps nulls as a ``NullValue`` bin.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from deequ_tpu_torch.analyzers.base import (
    Analyzer,
    EmptyStateException,
    GroupingAnalyzer,
    Precondition,
    ScanOps,
    exactly_n_columns,
    has_column,
)
from deequ_tpu_torch.data.table import ROW_MASK, ColumnRequest, Dataset
from deequ_tpu_torch.engine.pack import packed_device_get
from deequ_tpu_torch.engine.scan import AnalysisEngine
from deequ_tpu_torch.metrics.distribution import Distribution, HistogramMetric
from deequ_tpu_torch.metrics.metric import DoubleMetric, Entity, Metric

NULL_VALUE = "NullValue"  # reference: Histogram's bin name for nulls
MAX_DENSE_JOINT = 1 << 24  # dense cap when no budget is configured
# a dense plan up to this many slots spreads its per-batch scatter over
# _LANES counters a slot (row r adds into lane r % _LANES): on sorted or
# skewed codes a few slots take most rows, and their atomics contend
# (2^21 rows into 6 slots took 1.41 ms a batch on an H100, spread over
# 256 lanes 0.055 ms; PERF.md). Past it, one plain scatter_add_.
SPREAD_MAX_SLOTS = 1024
_LANES = 256


def _padded_dense_len(joint: int) -> int:
    """Pow2 length of the dense count vector: 1 << bit_length(joint) is
    strictly greater than joint, so the overflow slot always fits."""
    return 1 << max(1, int(joint).bit_length())


def _dense_joint_cap(num_rows: int) -> Tuple[int, torch.dtype]:
    """(max combined joint key space, count dtype) of the dense path:
    the configured budget over the count width, int32 counts when every
    count provably fits (num_rows < 2^31)."""
    from deequ_tpu_torch import config

    budget = config.options().dense_grouping_budget_bytes
    dtype = torch.int32 if num_rows < 2**31 else torch.int64
    if not budget:
        return MAX_DENSE_JOINT, dtype
    itemsize = 4 if dtype == torch.int32 else 8
    return max(1, budget // itemsize), dtype


# --------------------------------------------------------------------------
# Shared state
# --------------------------------------------------------------------------


class FrequenciesAndNumRows:
    """(value combination -> count) plus the number of contributing rows.

    Host-side object: ``keys`` is an object ndarray of shape (K, n_cols)
    whose entries are Python values (None encodes SQL NULL), ``counts``
    an int64 (K,). ``keys`` may be None with ``lazy_codes=(observed
    joint codes, dictionaries, sizes)``: count-only metrics never touch
    key values, so decoding waits for the first ``.keys``."""

    def __init__(
        self,
        columns: Tuple[str, ...],
        keys: Optional[np.ndarray],
        counts: np.ndarray,
        num_rows: int,
        lazy_codes: Optional[Tuple] = None,
    ):
        self.columns = tuple(columns)
        self._keys = keys
        self._lazy = lazy_codes
        self.counts = np.asarray(counts, dtype=np.int64)
        self.num_rows = int(num_rows)

    @property
    def keys(self) -> np.ndarray:
        if self._keys is None:
            observed, dictionaries, sizes = self._lazy
            self._keys = _decode_joint_codes(
                len(self.columns), observed, dictionaries, sizes
            )
        return self._keys

    def non_null_group_mask(self) -> np.ndarray:
        """True where NO key column is null, from the joint codes (slot 0
        is null) when they are at hand."""
        if self._lazy is not None:
            observed, _, sizes = self._lazy
            remaining = observed.copy()
            mask = np.ones(len(observed), dtype=bool)
            for j in range(len(self.columns) - 1, -1, -1):
                slot = remaining % sizes[j]
                remaining = remaining // sizes[j]
                mask &= slot > 0
            return mask
        return ~np.equal(self.keys, None).any(axis=1)

    @property
    def num_groups(self) -> int:
        return len(self.counts)

    def count_unique_groups(self) -> int:
        """#groups occurring exactly once (Uniqueness/UniqueValueRatio)."""
        return int(np.sum(self.counts == 1))

    def entropy_nats(self) -> float:
        """Shannon entropy of the non-null group distribution."""
        counts = self.counts[self.non_null_group_mask()].astype(np.float64)
        total = counts.sum()
        if total == 0:
            raise EmptyStateException("Entropy over empty distribution.")
        p = counts / total
        return float(-(p * np.log(p)).sum())

    def top_groups(self, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """(first-column key values, counts) of the k most frequent
        groups, count-descending, ties in stored order (Histogram's
        detail bins; the spill path's ties go in key order)."""
        order = np.argsort(-self.counts, kind="stable")[:k]
        return self.keys[order, 0], self.counts[order]

    @staticmethod
    def merge(a: "FrequenciesAndNumRows", b: "FrequenciesAndNumRows") -> "FrequenciesAndNumRows":
        """Union with summed counts: the groups of ``a`` first, then the
        new groups of ``b``, in first-seen order (the reference's Arrow
        group-by over ``concat(a, b)``, in numpy)."""
        if a.columns != b.columns:
            raise ValueError(f"cannot merge frequencies over {a.columns} with {b.columns}")
        keys = np.concatenate([a.keys, b.keys])
        counts = np.concatenate([a.counts, b.counts])
        codes = [_object_codes(keys[:, j]) for j in range(keys.shape[1])]
        first, inverse = _first_seen_groups(codes)
        summed = np.zeros(len(first), dtype=np.int64)
        np.add.at(summed, inverse, counts)
        return FrequenciesAndNumRows(
            a.columns, keys[first], summed, a.num_rows + b.num_rows
        )


def _key_identity(value):
    """The grouping identity of one key value: floats by value with the
    two zeros apart and every NaN as one (Arrow's group-by over
    normalised keys, which carry canonical NaN only)."""
    if isinstance(value, float):
        if value != value:
            return ("nan",)
        if value == 0.0:
            return ("zero", math.copysign(1.0, value))
    return value


def _object_codes(column: np.ndarray) -> Tuple[np.ndarray, int]:
    """(first-seen int64 codes of an object key column, None as 0, the
    number of slots)."""
    index: Dict[object, int] = {None: 0}
    codes = np.fromiter(
        (index.setdefault(_key_identity(v), len(index)) for v in column),
        dtype=np.int64, count=len(column),
    )
    return codes, len(index)


def _first_seen_groups(codes: List[Tuple[np.ndarray, int]]) -> Tuple[np.ndarray, np.ndarray]:
    """(first row of each group in first-seen order, each row's group)
    of per-column (codes, slots)."""
    n = len(codes[0][0]) if codes else 0
    if n == 0:
        return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int64)
    product = 1
    for _, slots in codes:
        product *= slots
    if product < 2**63:
        joint = np.zeros(n, dtype=np.int64)
        for c, slots in codes:
            joint = joint * slots + c
        _, first, inverse = np.unique(joint, return_index=True, return_inverse=True)
    else:
        stacked = np.stack([c for c, _ in codes], axis=1)
        _, first, inverse = np.unique(stacked, axis=0, return_index=True, return_inverse=True)
    order = np.argsort(first, kind="stable")
    rank = np.empty(len(order), dtype=np.int64)
    rank[order] = np.arange(len(order))
    return first[order], rank[inverse.reshape(-1)]


# --------------------------------------------------------------------------
# Frequency computation (the "groupBy" pass)
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class FrequencyPlan:
    """Identity of one shared frequency pass."""

    columns: Tuple[str, ...]
    where: Optional[str]
    include_nulls: bool  # Histogram keeps nulls as their own bin


@dataclass
class DenseSpec:
    """A dense plan riding the shared scan: its dictionaries and radix
    sizes (for the decode), its requests and its ops."""

    plan: FrequencyPlan
    dictionaries: List[np.ndarray]
    sizes: List[int]
    requests: List[ColumnRequest]
    ops: ScanOps


def plan_frequency_passes(
    dataset: Dataset,
    plans: Sequence[FrequencyPlan],
    engine: Optional[AnalysisEngine] = None,
    events: Optional[List[dict]] = None,
):
    """Split frequency plans into execution strategies WITHOUT running
    anything yet, so dense and collector plans can ride the caller's
    shared scan. Returns ``(dense_specs, collectors, deferred)``:

    - ``dense_specs``: :class:`DenseSpec` list, finalized by
      :func:`finalize_dense_states`;
    - ``collectors``: :class:`spill.CollectorSpec` list (empty when
      ``one_pass_spill`` is off), finalized by
      :func:`finalize_collector_states`;
    - ``deferred``: plan -> zero-argument callable running the deferred
      device spill or the host group-by.

    Each path taken is recorded in ``events`` as a ``grouping_spill``
    record, so a slow host pass is visible in the run."""
    from deequ_tpu_torch import config
    from deequ_tpu_torch.analyzers import spill as spill_mod

    engine = engine or AnalysisEngine()
    use_collectors = config.options().one_pass_spill
    collectors: List = []
    cap, count_dtype = _dense_joint_cap(dataset.num_rows)
    dense: List[DenseSpec] = []
    deferred: Dict[FrequencyPlan, object] = {}
    # the cap bounds the COMBINED key space: all dense plans ride one
    # fused scan, so their count vectors live on the device together
    remaining = cap

    def note(plan, path):
        if events is not None:
            events.append(
                {"event": "grouping_spill", "columns": list(plan.columns), "path": path}
            )

    def host(plan, path="host"):
        def run():
            note(plan, path)
            return _host_frequencies(dataset, plan, engine)

        return run

    def device_run(plan, path, compute):
        def run():
            try:
                result = compute()
            except spill_mod.SpillOverflow:
                return host(plan, "host-overflow")()
            note(plan, path)
            return result

        return run

    def make_collector(plan, build_spec, deferred_thunk):
        """Route a spill plan onto the shared scan; a spec that fails to
        build keeps its deferred device twin."""
        try:
            spec = build_spec()
        except Exception:  # noqa: BLE001
            deferred[plan] = deferred_thunk
            return
        spec.on_success = lambda: note(plan, spec.path)
        spec.overflow_fallback = host(plan, "host-overflow")
        spec.scan_fallback = deferred_thunk
        collectors.append(spec)

    for plan in plans:
        # a plan eligible for the device sort never builds a dictionary:
        # no host distinct set of a high-cardinality numeric key column
        if spill_mod.device_spill_eligible(dataset, plan):
            thunk = device_run(
                plan, "device-sort",
                lambda p=plan: spill_mod.device_spill_frequencies(dataset, p, engine),
            )
            if use_collectors:
                make_collector(
                    plan,
                    lambda p=plan: spill_mod.single_collector_spec(dataset, p, engine),
                    thunk,
                )
            else:
                deferred[plan] = thunk
            continue
        # capped distinct counts first, probed with the REMAINING budget
        sizes_maybe = [dataset.dictionary_size_within(c, remaining) for c in plan.columns]
        joint: Optional[int] = 1
        for s in sizes_maybe:
            if s is None:
                joint = None
                break
            joint *= s + 1  # +1: the null slot
        # debit what _make_dense_ops allocates (the pow2-padded vector)
        padded = _padded_dense_len(joint) if joint is not None else None
        if padded is not None and padded <= remaining:
            dictionaries = [dataset.dictionary(c) for c in plan.columns]
            sizes = [len(d) + 1 for d in dictionaries]
            requests, ops = _make_dense_ops(dataset, plan, sizes, count_dtype, engine.device)
            dense.append(DenseSpec(plan, dictionaries, sizes, requests, ops))
            remaining -= padded
        elif (
            len(plan.columns) > 1
            # the size-independent gates FIRST: the full re-probe below
            # builds whole distinct sets on the host
            and spill_mod.joint_spill_config_ok(dataset, plan)
            and spill_mod.joint_spill_eligible(
                dataset, plan, [len(dataset.dictionary(c)) + 1 for c in plan.columns]
            )
        ):
            # known per-column cardinalities whose JOINT space exceeds
            # the dense budget but fits the sort lanes
            dictionaries = [dataset.dictionary(c) for c in plan.columns]
            sizes = [len(d) + 1 for d in dictionaries]
            thunk = device_run(
                plan, "device-sort-joint",
                lambda p=plan, d=dictionaries, s=sizes: (
                    spill_mod.device_spill_joint_frequencies(dataset, p, engine, d, s)
                ),
            )
            if use_collectors:
                make_collector(
                    plan,
                    lambda p=plan, d=dictionaries, s=sizes: (
                        spill_mod.joint_collector_spec(dataset, p, engine, d, s)
                    ),
                    thunk,
                )
            else:
                deferred[plan] = thunk
        else:
            deferred[plan] = host(plan)
    return dense, collectors, deferred


def finalize_dense_states(dense_specs, states) -> Dict[FrequencyPlan, FrequenciesAndNumRows]:
    """Decode the shared scan's final (counts, num_rows) states into
    FrequenciesAndNumRows, one a dense plan."""
    out: Dict[FrequencyPlan, FrequenciesAndNumRows] = {}
    for spec, (counts, num_rows) in zip(dense_specs, states):
        joint = 1
        for s in spec.sizes:
            joint *= s
        counts = np.asarray(counts.cpu())[:joint]  # drop padding + overflow
        observed = np.nonzero(counts)[0]
        out[spec.plan] = FrequenciesAndNumRows(
            spec.plan.columns, None, counts[observed], int(num_rows),
            lazy_codes=(observed, list(spec.dictionaries), list(spec.sizes)),
        )
    return out


def finalize_collector_states(
    collectors, states, engine: AnalysisEngine, isolate: bool = False
) -> Dict[FrequencyPlan, object]:
    """Finish every one-pass spill plan from its collector state: EVERY
    plan's sort and segment count is dispatched before any result is
    fetched, then ONE packed transfer (counted in
    ``engine.device_fetches``) brings back every plan's scalars, and each
    state builds on the host. A plan whose dispatch fails re-reads its
    columns through its deferred twin; ``SpillOverflow`` takes the host
    group-by. With ``isolate``, other exceptions become the plan's
    value (the runner's per-plan failure contract)."""
    from deequ_tpu_torch.analyzers.spill import SpillOverflow

    out: Dict[FrequencyPlan, object] = {}
    launched = []
    pendings = []
    for spec, state in zip(collectors, states):
        try:
            pending, build = spec.dispatch(state)
        except Exception:  # noqa: BLE001 — re-read via the deferred twin
            try:
                out[spec.plan] = spec.scan_fallback()
            except Exception as exc:  # noqa: BLE001
                if not isolate:
                    raise
                out[spec.plan] = exc
            continue
        launched.append((spec, build))
        pendings.append(pending)
    if not launched:
        return out
    engine.device_fetches += 1
    fetched = packed_device_get(tuple(pendings))
    for (spec, build), got in zip(launched, fetched):
        try:
            out[spec.plan] = build(got)
            spec.on_success()
        except SpillOverflow:
            try:
                out[spec.plan] = spec.overflow_fallback()
            except Exception as exc:  # noqa: BLE001
                if not isolate:
                    raise
                out[spec.plan] = exc
        except Exception as exc:  # noqa: BLE001
            if not isolate:
                raise
            out[spec.plan] = exc
    return out


def compute_many_frequencies(
    dataset: Dataset,
    plans: Sequence[FrequencyPlan],
    engine: Optional[AnalysisEngine] = None,
    events: Optional[List[dict]] = None,
) -> Dict[FrequencyPlan, FrequenciesAndNumRows]:
    """Every dense and collector plan rides ONE fused scan; deferred
    plans run on their own. (The AnalysisRunner fuses these plans into
    its main scan instead; this entry point runs them standalone.)"""
    engine = engine or AnalysisEngine()
    dense, collectors, deferred = plan_frequency_passes(dataset, plans, engine, events)
    results: Dict[FrequencyPlan, FrequenciesAndNumRows] = {
        plan: run() for plan, run in deferred.items()
    }
    if dense or collectors:
        states = engine.run_scan(
            dataset,
            [(FrequencyScanAdapter(s.requests), s.ops) for s in dense]
            + [(FrequencyScanAdapter(spec.requests), spec.ops) for spec in collectors],
        )
        if events is not None and engine.phase_times is not None:
            events.append({"event": "scan_phases", **engine.phase_times})
        results.update(finalize_dense_states(dense, states[: len(dense)]))
        results.update(finalize_collector_states(collectors, states[len(dense):], engine))
    return results


def _make_dense_ops(
    dataset: Dataset,
    plan: FrequencyPlan,
    sizes: List[int],
    count_dtype: torch.dtype,
    device: torch.device,
):
    """(requests, ScanOps) of one dense frequency plan; the state is
    (dense count vector, kept-row count)."""
    from deequ_tpu_torch.sql.predicate import compile_predicate

    columns = list(plan.columns)
    where_fn = None
    requests = [ColumnRequest(c, "codes") for c in columns] + [
        ColumnRequest(c, "mask") for c in columns
    ]
    if plan.where is not None:
        pred = compile_predicate(plan.where, dataset)
        where_fn = pred.complies
        requests += list(pred.requests)

    joint = 1
    for s in sizes:
        joint *= s
    # joint codes need int64 once the key space reaches 2^31
    code_dtype = torch.int64 if joint >= 2**31 else torch.int32
    # padded to pow2 (always > joint, so the overflow slot fits), as
    # the JAX package pads it
    padded_len = _padded_dense_len(joint)

    def init():
        return (
            torch.zeros(padded_len, dtype=count_dtype, device=device),
            torch.zeros((), dtype=torch.int64, device=device),
        )

    def update(state, batch):
        counts, num_rows = state
        rows = batch[ROW_MASK]
        if where_fn is not None:
            rows = rows & where_fn(batch)
        if plan.include_nulls:
            keep = rows
        else:
            any_non_null = batch[f"{columns[0]}::mask"]
            for c in columns[1:]:
                any_non_null = any_non_null | batch[f"{c}::mask"]
            keep = rows & any_non_null
        code = torch.zeros(keep.shape, dtype=code_dtype, device=keep.device)
        for j, c in enumerate(columns):
            code = code * sizes[j] + (batch[f"{c}::codes"] + 1).to(code_dtype)
        # rejected rows go to the overflow slot; per-batch counts are
        # int32 (a batch is far below 2^31 rows), carried in count_dtype
        code = torch.where(keep, code, padded_len - 1)
        counts = counts + dense_counts(code, padded_len).to(count_dtype)
        return counts, num_rows + keep.sum(dtype=torch.int64)

    ops = ScanOps(init, update, lambda a, b: (a[0] + b[0], a[1] + b[1]))
    return requests, ops


def dense_counts(code: torch.Tensor, padded_len: int) -> torch.Tensor:
    """(padded_len,) int32 counts of one batch's slot codes: spread over
    ``_LANES`` counters a slot up to SPREAD_MAX_SLOTS slots, one plain
    ``scatter_add_`` past it."""
    code = code.to(torch.int64)
    ones = torch.ones((), dtype=torch.int32, device=code.device).expand(code.shape)
    if padded_len > SPREAD_MAX_SLOTS:
        counts = torch.zeros(padded_len, dtype=torch.int32, device=code.device)
        return counts.scatter_add_(0, code, ones)
    lane = torch.arange(code.shape[0], dtype=torch.int64, device=code.device) & (_LANES - 1)
    spread = torch.zeros(padded_len * _LANES, dtype=torch.int32, device=code.device)
    spread.scatter_add_(0, code * _LANES + lane, ones)
    return spread.view(padded_len, _LANES).sum(dim=1, dtype=torch.int32)


def _decode_joint_codes(
    n_columns: int,
    observed: np.ndarray,
    dictionaries: List[np.ndarray],
    sizes: List[int],
) -> np.ndarray:
    key_arr = np.empty((len(observed), n_columns), dtype=object)
    remaining = observed.copy()
    for j in range(n_columns - 1, -1, -1):
        slot = remaining % sizes[j]
        remaining = remaining // sizes[j]
        decoded = np.empty(len(slot), dtype=object)
        non_null = slot > 0
        if non_null.any():
            decoded[non_null] = dictionaries[j][slot[non_null] - 1]
        decoded[~non_null] = None
        key_arr[:, j] = decoded
    return key_arr


class FrequencyScanAdapter:
    """A fixed request list standing in for an analyzer's
    ``device_requests``, so frequency ops ride the shared scan."""

    def __init__(self, requests):
        self._requests = requests

    def device_requests(self, ds):
        return self._requests


def _where_mask_full(dataset: Dataset, where: Optional[str],
                     engine: AnalysisEngine) -> Optional[np.ndarray]:
    """A where-filter over the whole table (the host group-by's rows),
    evaluated batch by batch on the engine's device."""
    if where is None:
        return None
    from deequ_tpu_torch.sql.predicate import compile_predicate

    pred = compile_predicate(where, dataset)
    batch_size = engine._resolve_batch_size(dataset.num_rows)
    parts = [
        pred.complies(batch)
        for batch in dataset.device_batches(pred.requests, batch_size, engine.device)
    ]
    if not parts:
        return np.zeros(0, dtype=bool)
    engine.device_fetches += 1
    return packed_device_get(torch.cat(parts)).numpy().astype(bool)


def _host_frequencies(
    dataset: Dataset, plan: FrequencyPlan, engine: AnalysisEngine
) -> FrequenciesAndNumRows:
    """The host fallback for key spaces that neither the dense budget
    nor the sort lanes hold (the JAX package's Arrow group-by): a numpy
    group-by over the host columns' dictionary codes (float keys
    normalised, nulls as their own digit), groups in first-seen order.
    Reads the source once (a data pass)."""
    engine.data_passes += 1
    columns = list(plan.columns)
    keep = np.ones(dataset.num_rows, dtype=bool)
    mask = _where_mask_full(dataset, plan.where, engine)
    if mask is not None:
        keep &= mask
    if not plan.include_nulls:
        non_null = np.zeros(dataset.num_rows, dtype=bool)
        for c in columns:
            non_null |= dataset.materialize(ColumnRequest(c, "mask"))
        keep &= non_null
    dictionaries = [dataset.dictionary(c) for c in columns]
    codes = [
        (dataset.materialize(ColumnRequest(c, "codes"))[keep].astype(np.int64) + 1, len(d) + 1)
        for c, d in zip(columns, dictionaries)
    ]
    first, inverse = _first_seen_groups(codes)
    counts = np.bincount(inverse, minlength=len(first)).astype(np.int64)
    keys = np.empty((len(first), len(columns)), dtype=object)
    for j, ((col_codes, _), dictionary) in enumerate(zip(codes, dictionaries)):
        slot = col_codes[first]
        decoded = np.empty(len(slot), dtype=object)
        non_null = slot > 0
        if non_null.any():
            decoded[non_null] = dictionary[slot[non_null] - 1]
        decoded[~non_null] = None
        keys[:, j] = decoded
    return FrequenciesAndNumRows(tuple(columns), keys, counts, int(keep.sum()))


def plans_for(
    analyzers: Sequence[GroupingAnalyzer],
) -> Dict[FrequencyPlan, List[GroupingAnalyzer]]:
    """Group analyzers by their shared frequency plan (one pass per
    (grouping columns, filter, null policy))."""
    by_plan: Dict[FrequencyPlan, List[GroupingAnalyzer]] = {}
    for analyzer in analyzers:
        plan = FrequencyPlan(
            tuple(analyzer.grouping_columns()),
            analyzer.filter_condition,
            getattr(analyzer, "include_nulls", False),
        )
        by_plan.setdefault(plan, []).append(analyzer)
    return by_plan


def finalize_grouping_metrics(
    by_plan: Dict[FrequencyPlan, List[GroupingAnalyzer]],
    frequencies: Dict[FrequencyPlan, object],
    aggregate_with,
    save_states_with,
) -> Dict[Analyzer, Metric]:
    """Per-analyzer metrics over computed frequency states; a plan may
    map to an EXCEPTION, which fails exactly that plan's analyzers."""
    metrics: Dict[Analyzer, Metric] = {}
    for plan, group in by_plan.items():
        result = frequencies.get(plan)
        for analyzer in group:
            try:
                if isinstance(result, BaseException):
                    raise result
                state = result
                if aggregate_with is not None:
                    prior = aggregate_with.load(analyzer)
                    if prior is not None:
                        state = FrequenciesAndNumRows.merge(state, prior)
                if save_states_with is not None:
                    save_states_with.persist(analyzer, state)
                metrics[analyzer] = analyzer.compute_metric_from_state(state)
            except Exception as exc:  # noqa: BLE001
                metrics[analyzer] = analyzer.to_failure_metric(exc)
    return metrics


def run_grouping_analyzers(
    dataset: Dataset,
    analyzers: Sequence[GroupingAnalyzer],
    engine: Optional[AnalysisEngine],
    aggregate_with,
    save_states_with,
    events: Optional[List[dict]] = None,
) -> Dict[Analyzer, Metric]:
    """Standalone grouping execution (the AnalysisRunner fuses these
    plans into its main scan instead)."""
    by_plan = plans_for(analyzers)
    try:
        frequencies = compute_many_frequencies(dataset, list(by_plan), engine, events)
    except Exception as exc:  # noqa: BLE001
        return {
            analyzer: analyzer.to_failure_metric(exc)
            for group in by_plan.values()
            for analyzer in group
        }
    return finalize_grouping_metrics(by_plan, frequencies, aggregate_with, save_states_with)


# --------------------------------------------------------------------------
# Concrete grouping analyzers
# --------------------------------------------------------------------------


def _normalize_columns(columns: Union[str, Sequence[str]]) -> Tuple[str, ...]:
    if isinstance(columns, str):
        return (columns,)
    return tuple(columns)


@dataclass(frozen=True)
class _FrequencyAnalyzer(GroupingAnalyzer):
    columns: Tuple[str, ...] = ()
    where: Optional[str] = None

    def __init__(self, columns: Union[str, Sequence[str]], where: Optional[str] = None):
        object.__setattr__(self, "columns", _normalize_columns(columns))
        object.__setattr__(self, "where", where)

    def grouping_columns(self) -> List[str]:
        return list(self.columns)

    @property
    def filter_condition(self) -> Optional[str]:
        return self.where

    @property
    def entity(self) -> Entity:
        return Entity.COLUMN if len(self.columns) == 1 else Entity.MULTICOLUMN

    @property
    def instance(self) -> str:
        return ",".join(self.columns)

    def compute_metric_from_state(self, state) -> Metric:
        if state is None or state.num_rows == 0:
            return self.to_failure_metric(
                EmptyStateException(f"Empty state for analyzer {self.name}.")
            )
        return DoubleMetric.success(self.entity, self.name, self.instance, self._value(state))

    def _value(self, state: FrequenciesAndNumRows) -> float:
        raise NotImplementedError


class CountDistinct(_FrequencyAnalyzer):
    """Exact distinct count (reference: analyzers/CountDistinct.scala)."""

    def _value(self, state: FrequenciesAndNumRows) -> float:
        return float(state.num_groups)


class Distinctness(_FrequencyAnalyzer):
    """#distinct / #rows (reference: analyzers/Distinctness.scala)."""

    def _value(self, state: FrequenciesAndNumRows) -> float:
        return state.num_groups / state.num_rows


class Uniqueness(_FrequencyAnalyzer):
    """Fraction of values occurring exactly once (reference:
    analyzers/Uniqueness.scala)."""

    def _value(self, state: FrequenciesAndNumRows) -> float:
        return float(state.count_unique_groups()) / state.num_rows


class UniqueValueRatio(_FrequencyAnalyzer):
    """#unique / #distinct (reference: analyzers/UniqueValueRatio.scala)."""

    def _value(self, state: FrequenciesAndNumRows) -> float:
        return float(state.count_unique_groups()) / state.num_groups


class Entropy(_FrequencyAnalyzer):
    """Shannon entropy of the value distribution (reference:
    analyzers/Entropy.scala); computed over non-null groups."""

    def _value(self, state: FrequenciesAndNumRows) -> float:
        return state.entropy_nats()


class MutualInformation(_FrequencyAnalyzer):
    """Mutual information of two columns (reference:
    analyzers/MutualInformation.scala), from the joint frequency table;
    rows with any null in the pair are excluded. Sums Python floats in
    key order, so the key order decides the last bits."""

    def preconditions(self) -> List[Precondition]:
        return [exactly_n_columns(self.columns, 2)] + super().preconditions()

    @property
    def entity(self) -> Entity:
        return Entity.MULTICOLUMN

    def _value(self, state: FrequenciesAndNumRows) -> float:
        keep = state.non_null_group_mask()
        keys = state.keys[keep]
        counts = state.counts[keep].astype(np.float64)
        total = counts.sum()
        if total == 0:
            raise EmptyStateException("MutualInformation over empty state.")
        p_joint = counts / total
        left: Dict[object, float] = {}
        right: Dict[object, float] = {}
        for row, p in zip(keys, p_joint):
            left[row[0]] = left.get(row[0], 0.0) + p
            right[row[1]] = right.get(row[1], 0.0) + p
        mi = 0.0
        for row, p in zip(keys, p_joint):
            mi += p * math.log(p / (left[row[0]] * right[row[1]]))
        return float(mi)


@dataclass(frozen=True)
class Histogram(GroupingAnalyzer):
    """Full value distribution, null values kept as a ``NullValue`` bin,
    detail capped at ``max_detail_bins`` (reference:
    analyzers/Histogram.scala)."""

    column: str = ""
    max_detail_bins: int = 1000
    where: Optional[str] = None

    def __init__(self, column: str, max_detail_bins: int = 1000, where: Optional[str] = None):
        object.__setattr__(self, "column", column)
        object.__setattr__(self, "max_detail_bins", max_detail_bins)
        object.__setattr__(self, "where", where)

    include_nulls = True

    def grouping_columns(self) -> List[str]:
        return [self.column]

    @property
    def filter_condition(self) -> Optional[str]:
        return self.where

    @property
    def instance(self) -> str:
        return self.column

    def preconditions(self) -> List[Precondition]:
        return [has_column(self.column)]

    def compute_metric_from_state(self, state) -> Metric:
        if state is None:
            return self.to_failure_metric(
                EmptyStateException("Empty state for analyzer Histogram.")
            )
        top_keys, top_counts = state.top_groups(self.max_detail_bins)
        counts: Dict[str, int] = {}
        for value, count in zip(top_keys, top_counts):
            label = NULL_VALUE if value is None else str(value)
            counts[label] = int(count)
        metric = HistogramMetric.from_counts("Histogram", self.instance, counts, state.num_rows)
        # number_of_bins is the FULL distinct count even when the detail
        # is capped (reference behavior)
        full = Distribution(metric.value.get().values, state.num_groups)
        return HistogramMetric(Entity.COLUMN, "Histogram", self.instance, type(metric.value)(full))
