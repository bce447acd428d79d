"""ApproxCountDistinct: HLL cardinality estimate.

Counterpart of ``deequ_tpu/analyzers/hll.py``. State = int8[2^14]
registers; update = hash + rank + scatter-max inside the shared fused
scan (numeric columns: one fused kernel, ``scatter_max.hll_update``;
dictionary-encoded strings: one fused kernel over the codes,
``scatter_max.hll_update_codes``); merge = elementwise max. Nulls are
ignored.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from deequ_tpu_torch.analyzers.base import (
    Precondition,
    ScanOps,
    ScanShareableAnalyzer,
    has_column,
    pad_pow2,
)
from deequ_tpu_torch.analyzers.basic import _compile_where, _row_mask
from deequ_tpu_torch.analyzers.states import ApproxCountDistinctState
from deequ_tpu_torch.data.table import ColumnRequest, Dataset
from deequ_tpu_torch.metrics.metric import DoubleMetric
from deequ_tpu_torch.sketches import hll, scatter_max


@dataclass(frozen=True)
class ApproxCountDistinct(ScanShareableAnalyzer):
    column: str
    where: Optional[str] = None

    @property
    def instance(self) -> str:
        return self.column

    def preconditions(self) -> List[Precondition]:
        return [has_column(self.column)]

    def device_requests(self, dataset: Dataset) -> List[ColumnRequest]:
        return [
            ColumnRequest(self.column, dataset.hll_repr(self.column)),
            ColumnRequest(self.column, "mask"),
        ] + _compile_where(self.where, dataset)[1]

    def make_ops(self, dataset: Dataset) -> ScanOps:
        where_fn, _ = _compile_where(self.where, dataset)
        col = self.column
        value_repr = dataset.hll_repr(col)
        string = value_repr == "codes"

        def init() -> ApproxCountDistinctState:
            return ApproxCountDistinctState(torch.zeros(hll.M, dtype=torch.int8))

        consts = None
        if string:
            # the dictionary's hash LUTs, pow2-padded as the JAX package
            # pads them (the presence path scatters every padded slot)
            lut1, lut2 = hll.dictionary_hash_pairs(dataset.dictionary(col))
            consts = {
                "h1": torch.from_numpy(pad_pow2(lut1).astype(np.int64)),
                "h2": torch.from_numpy(pad_pow2(lut2).astype(np.int64)),
            }

        def update(state: ApproxCountDistinctState, batch, consts_in=None):
            rows = _row_mask(batch, where_fn)
            values = batch[f"{col}::{value_repr}"][None, :]
            mask = batch[f"{col}::mask"][None, :]
            if string:
                regs = scatter_max.hll_update_codes(
                    values, mask, rows, consts_in["h1"][None, :], consts_in["h2"][None, :],
                    state.registers[None, :],
                )
            else:
                regs = scatter_max.hll_update(values, mask, rows, state.registers[None, :])
            return ApproxCountDistinctState(regs[0])

        return ScanOps(init, update, ApproxCountDistinctState.merge, consts=consts)

    def compute_metric_from_state(self, state) -> DoubleMetric:
        if state is None:
            return DoubleMetric.success(
                self.entity, "ApproxCountDistinct", self.instance, 0.0
            )
        return DoubleMetric.success(
            self.entity,
            "ApproxCountDistinct",
            self.instance,
            hll.estimate(state.registers.cpu().numpy()),
        )
