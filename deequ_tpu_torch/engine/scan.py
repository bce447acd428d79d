"""The fused resident scan: every analyzer's update on each batch, in one
pass over device-resident columns.

Counterpart of the resident half of ``deequ_tpu/engine/scan.py``. Each
requested column representation is copied to the device once and stays
there (``Dataset.device_column``); a scan is a Python loop over batches,
each a set of views into the resident columns, that runs every unit's
``update`` on the same batch and keeps the states on the device. At the
end ONE packed transfer (``engine/pack.py``) brings every final state to
the host.

Counters on the engine:

- ``data_passes``    — traversals of the data, one per scan however many
                       analyzers ride it;
- ``device_fetches`` — synchronising device -> host state transfers.
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
        # "scan_s" phase ends in the synchronising fetch)
        self.phase_times: Optional[Dict[str, float]] = None

    def _resolve_batch_size(self, num_rows: int) -> int:
        size = self.batch_size
        if size is None:
            size = config.options().batch_size
        if size is None:
            size = min(max(num_rows, 1), DEFAULT_MAX_BATCH)
        return max(int(size), 1)

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
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t1 = time.perf_counter()
        for batch in batches:
            states = [
                op.apply_update(s, batch, c) for op, s, c in zip(ops, states, consts)
            ]
        self.device_fetches += 1
        host_states = packed_device_get(states)
        t2 = time.perf_counter()
        self.phase_times = {"resident_s": t1 - t0, "scan_s": t2 - t1}
        return host_states
