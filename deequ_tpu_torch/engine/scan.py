"""The fused resident scan: every analyzer's update on each batch, in one
pass over device-resident columns.

Counterpart of the resident half of ``deequ_tpu/engine/scan.py``. Each
requested column representation is copied to the device once and stays
there (``Dataset.device_column``); a scan is a Python loop over batches,
each a set of views into the resident columns, that runs every unit's
``update`` on the same batch and keeps the states on the device. At the
end ONE packed transfer (``engine/pack.py``) brings every final state to
the host.

Host-folded ops (``ScanOps.host_fold``: the KLL sketches) emit a
per-batch output instead of carrying a state. The engine keeps each
batch's output on the device and stacks them; the same packed transfer
that fetches the states fetches them, and the host folds them into the
op's accumulator in batch order. Retained outputs are drained (one more
fetch) only when ``DRAIN_EVERY`` batches are pending, which bounds their
device memory; a scan of up to ``DRAIN_EVERY`` batches fetches once.

Device-result ops (``ScanOps.device_result``: the spill collectors'
key buffers) keep their final state on the device: it stays out of the
packed transfer and is returned as device tensors, for a finalize that
the caller dispatches after the scan.

Counters on the engine:

- ``data_passes``    — traversals of the data, one per scan however many
                       analyzers ride it;
- ``device_fetches`` — synchronising device -> host transfers: the final
                       one, plus one a drain.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils import _pytree as pytree

from deequ_tpu_torch import config
from deequ_tpu_torch.analyzers.base import ScanOps
from deequ_tpu_torch.data.table import ColumnRequest, Dataset
from deequ_tpu_torch.engine.pack import packed_device_get

DEFAULT_MAX_BATCH = 1 << 21  # rows per fused-scan step, as the JAX package
# batches of host-folded outputs retained on the device before a drain:
# about 10 KB a KLL column a batch (k = 2048), so 64 batches of 40
# columns hold 26 MB
DRAIN_EVERY = 64


def _to_device(tree: Any, device: torch.device) -> Any:
    return pytree.tree_map(
        lambda x: x.to(device) if isinstance(x, torch.Tensor) else x, tree
    )


@dataclass
class ScanPlan:
    """The static half of a fused scan: ops, the column requests they
    read, the batch geometry and the device."""

    ops: Tuple[ScanOps, ...]
    requests: Tuple[ColumnRequest, ...]
    batch_size: int
    device: torch.device


class AnalysisEngine:
    """Executes fused analyzer scans on one device.

    ``device`` — ``"cuda"`` (the default, from ``config.options().device``
    when not given) or ``"cpu"``; a CUDA default without a GPU raises
    here, never later. ``batch_size`` — rows per fused step
    (``config.options().batch_size``, else ``min(rows, 2**21)``).
    """

    def __init__(self, device=None, batch_size: Optional[int] = None):
        self.device = config.resolve_device(device)
        self.batch_size = batch_size
        self.data_passes = 0
        self.device_fetches = 0
        # wall seconds of the last scan, by phase (host clock; the
        # "scan_s" phase ends in the synchronising fetch, "fold_s" is the
        # host folds of the per-batch outputs, drains' folds included)
        self.phase_times: Optional[Dict[str, float]] = None

    def _resolve_batch_size(self, num_rows: int) -> int:
        size = self.batch_size
        if size is None:
            size = config.options().batch_size
        if size is None:
            size = min(max(num_rows, 1), DEFAULT_MAX_BATCH)
        return max(int(size), 1)

    def scan_row_capacity(self, dataset: Dataset) -> int:
        """Rows a scan feeds through the ops for this dataset: a spill
        collector sizes its key buffer by it, so no batch's append can
        overrun it. The port pads no batch, so it is the row count (at
        least 1, the JAX package's capacity of an empty dataset)."""
        return max(dataset.num_rows, 1)

    def run_scan(
        self, dataset: Dataset, analyzers_and_ops: Sequence[Tuple[Any, ScanOps]]
    ) -> List[Any]:
        """Run every unit's update in one fused pass; returns the final
        states on the host, index-aligned with the input."""
        plan = self.prepare_scan(dataset, analyzers_and_ops)
        if plan is None:
            return []
        return self.execute_plan(plan, dataset)

    def prepare_scan(
        self, dataset: Dataset, analyzers_and_ops: Sequence[Tuple[Any, ScanOps]]
    ) -> Optional[ScanPlan]:
        if not analyzers_and_ops:
            return None
        requests: List[ColumnRequest] = []
        for analyzer, _ in analyzers_and_ops:
            requests.extend(analyzer.device_requests(dataset))
        return ScanPlan(
            ops=tuple(o for _, o in analyzers_and_ops),
            requests=tuple(requests),
            batch_size=self._resolve_batch_size(dataset.num_rows),
            device=self.device,
        )

    def execute_plan(self, plan: ScanPlan, dataset: Dataset) -> List[Any]:
        self.data_passes += 1
        return self._run_scan_resident(
            dataset, plan.ops, plan.requests, plan.batch_size, plan.device
        )

    def _run_scan_resident(
        self,
        dataset: Dataset,
        ops: Sequence[ScanOps],
        requests: Sequence[ColumnRequest],
        batch_size: int,
        device: torch.device,
    ) -> List[Any]:
        t0 = time.perf_counter()
        batches = dataset.device_batches(requests, batch_size, device)
        consts = [_to_device(op.consts, device) for op in ops]
        states = [_to_device(op.init(), device) for op in ops]
        host_slots = [i for i, op in enumerate(ops) if op.host_fold is not None]
        accs = {i: ops[i].host_init() for i in host_slots}
        pending: List[List[Any]] = []  # per batch: the host slots' outputs
        fold_s = 0.0
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t1 = time.perf_counter()
        for batch in batches:
            if len(pending) == DRAIN_EVERY:
                self.device_fetches += 1
                fold_s += self._fold(ops, host_slots, accs, packed_device_get(
                    _stack_outputs(pending)))
                pending = []
            states = [
                op.apply_update(s, batch, c) for op, s, c in zip(ops, states, consts)
            ]
            if host_slots:
                pending.append([states[i] for i in host_slots])
        self.device_fetches += 1
        # device results are shielded from the fetch: they stay where
        # they are (the JAX package's _shield_device_results)
        fetch_slots = [
            i for i, op in enumerate(ops) if i not in accs and not op.device_result
        ]
        host_carried, fetched = packed_device_get(
            ([states[i] for i in fetch_slots], _stack_outputs(pending))
        )
        t2 = time.perf_counter()
        fold_s += self._fold(ops, host_slots, accs, fetched)
        host_states = list(states)
        for i, state in zip(fetch_slots, host_carried):
            host_states[i] = state
        for i, acc in accs.items():
            host_states[i] = acc
        self.phase_times = {"resident_s": t1 - t0, "scan_s": t2 - t1, "fold_s": fold_s}
        return host_states

    @staticmethod
    def _fold(ops, host_slots, accs, fetched) -> float:
        """Fold fetched stacked outputs into the host accumulators, batch
        by batch in order; returns the seconds it took."""
        t0 = time.perf_counter()
        for i, stacked in zip(host_slots, fetched or []):
            leaves, spec = pytree.tree_flatten(stacked)
            leaves = [leaf.numpy() for leaf in leaves]
            acc = accs[i]
            for b in range(leaves[0].shape[0]):
                acc = ops[i].host_fold(
                    acc, pytree.tree_unflatten([leaf[b] for leaf in leaves], spec)
                )
            accs[i] = acc
        return time.perf_counter() - t0


def _stack_outputs(pending: List[List[Any]]) -> Optional[List[Any]]:
    """The retained per-batch outputs, one tree a host slot whose leaves
    stack the batches on a new leading axis (None when nothing is
    pending)."""
    if not pending:
        return None
    out = []
    for slot in zip(*pending):
        leaves = [pytree.tree_flatten(tree) for tree in slot]
        spec = leaves[0][1]
        out.append(pytree.tree_unflatten(
            [torch.stack(parts) for parts in zip(*(lv for lv, _ in leaves))], spec
        ))
    return out
