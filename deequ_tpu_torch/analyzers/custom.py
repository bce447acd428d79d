"""CustomSql: a metric from a scalar aggregate expression.

Counterpart of ``deequ_tpu/analyzers/custom.py``. The expression
compiles onto the fused scan: every aggregate call (SUM, COUNT, AVG,
MIN, MAX over one column, or COUNT(*)) becomes a slot of a mergeable
state updated in the shared pass, and the arithmetic around the calls
(+, -, *, /, %, unary minus, numeric literals) is evaluated on the host
over the final scalars. So ``CustomSql("SUM(a) / SUM(b) + 1")`` costs
no pass of its own, and its state merges like any other.

The state holds k slots as four vectors (sums float64, counts int64,
mins float64, maxs float64), whose merge is elementwise and does not
depend on the expression, so a persisted state merges without it. The
JAX package's state of the same name has the same fields, dtypes and
merge (``interop.py`` carries it across).

A COUNT slot reads only the column's mask, so COUNT of a string column
counts its non-null rows.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from deequ_tpu_torch.analyzers.base import (
    EmptyStateException,
    IllegalAnalyzerParameterException,
    Precondition,
    ScanOps,
    ScanShareableAnalyzer,
    has_column,
    is_numeric,
)
from deequ_tpu_torch.analyzers.basic import (
    _col_mask,
    _compile_where,
    _mcount,
    _mmax,
    _mmin,
    _msum,
    _row_mask,
    _values,
)
from deequ_tpu_torch.analyzers.states import STATE_TYPES, nan_largest_min
from deequ_tpu_torch.data.table import ColumnRequest, Dataset
from deequ_tpu_torch.metrics.metric import DoubleMetric, Entity
from deequ_tpu_torch.sql.predicate import (
    BinOp,
    ColumnRef,
    FuncCall,
    Node,
    NumberLit,
    PredicateParseError,
    StarLit,
    UnaryOp,
    parse_predicate,
)

_AGGREGATES = ("SUM", "COUNT", "AVG", "MIN", "MAX")
_F64 = torch.float64

# aggregate slot: (function name, column name or "*")
_Slot = Tuple[str, str]


class CustomSqlState(NamedTuple):
    """k aggregate slots as parallel vectors; merge is elementwise."""

    sums: torch.Tensor  # f64[k]
    counts: torch.Tensor  # i64[k]
    mins: torch.Tensor  # f64[k]
    maxs: torch.Tensor  # f64[k]

    @staticmethod
    def identity(k: int) -> "CustomSqlState":
        # NaN is nan_largest_min's identity (states.MinState's too)
        return CustomSqlState(
            torch.zeros(k, dtype=_F64),
            torch.zeros(k, dtype=torch.int64),
            torch.full((k,), float("nan"), dtype=_F64),
            torch.full((k,), float("-inf"), dtype=_F64),
        )

    @staticmethod
    def merge(a: "CustomSqlState", b: "CustomSqlState") -> "CustomSqlState":
        return CustomSqlState(
            a.sums + b.sums,
            a.counts + b.counts,
            nan_largest_min(a.mins, b.mins),
            torch.maximum(a.maxs, b.maxs),
        )


STATE_TYPES.setdefault("CustomSqlState", CustomSqlState)


def _collect_aggregates(node: Node, out: List[_Slot]) -> None:
    """Collect the aggregate calls of an expression in order of first
    appearance; a column outside an aggregate has no scalar meaning and
    is refused."""
    if isinstance(node, FuncCall) and node.name in _AGGREGATES:
        if len(node.args) != 1:
            raise PredicateParseError(f"{node.name} takes exactly one argument")
        arg = node.args[0]
        if isinstance(arg, StarLit):
            if node.name != "COUNT":
                raise PredicateParseError(f"* is only valid in COUNT(*), not {node.name}")
            slot = (node.name, "*")
        elif isinstance(arg, ColumnRef):
            slot = (node.name, arg.name)
        else:
            raise PredicateParseError(f"{node.name} expects a column (or * for COUNT)")
        if slot not in out:
            out.append(slot)
        return
    if isinstance(node, ColumnRef):
        raise PredicateParseError(
            f"bare column {node.name!r} outside an aggregate — aggregate "
            "expressions reduce to one scalar"
        )
    if isinstance(node, NumberLit):
        return
    if isinstance(node, UnaryOp) and node.op == "NEG":
        _collect_aggregates(node.operand, out)
        return
    if isinstance(node, BinOp) and node.op in ("+", "-", "*", "/", "%"):
        _collect_aggregates(node.left, out)
        _collect_aggregates(node.right, out)
        return
    raise PredicateParseError(f"unsupported node in aggregate expression: {node!r}")


def _finalize(node: Node, values: Dict[_Slot, float]) -> float:
    """The expression's arithmetic over the final aggregate scalars."""
    if isinstance(node, FuncCall) and node.name in _AGGREGATES:
        arg = node.args[0]
        col = "*" if isinstance(arg, StarLit) else arg.name  # type: ignore[union-attr]
        return values[(node.name, col)]
    if isinstance(node, NumberLit):
        return node.value
    if isinstance(node, UnaryOp):
        return -_finalize(node.operand, values)
    if isinstance(node, BinOp):
        left = _finalize(node.left, values)
        right = _finalize(node.right, values)
        if node.op == "+":
            return left + right
        if node.op == "-":
            return left - right
        if node.op == "*":
            return left * right
        if right == 0:
            word = "division" if node.op == "/" else "modulo"
            raise IllegalAnalyzerParameterException(f"{word} by zero in CustomSql expression")
        return left / right if node.op == "/" else left % right
    raise PredicateParseError(f"cannot finalize node {node!r}")


@dataclass(frozen=True)
class CustomSql(ScanShareableAnalyzer):
    expression: str
    where: Optional[str] = None

    @property
    def entity(self) -> Entity:
        return Entity.DATASET

    @property
    def instance(self) -> str:
        return self.expression

    def _plan(self) -> Tuple[Node, List[_Slot]]:
        node = parse_predicate(self.expression)
        slots: List[_Slot] = []
        _collect_aggregates(node, slots)
        if not slots:
            raise PredicateParseError("aggregate expression contains no aggregate call")
        return node, slots

    def preconditions(self) -> List[Precondition]:
        try:
            _, slots = self._plan()
        except PredicateParseError:
            # the parse error becomes the failure metric at run time
            def bad(schema):
                self._plan()

            return [bad]
        checks: List[Precondition] = []
        for func, col in slots:
            if col == "*":
                continue
            checks.append(has_column(col))
            if func != "COUNT":
                checks.append(is_numeric(col))
        return checks

    def device_requests(self, dataset: Dataset) -> List[ColumnRequest]:
        _, slots = self._plan()
        requests: List[ColumnRequest] = list(_compile_where(self.where, dataset)[1])
        for func, col in slots:
            if col == "*":
                continue
            requests.append(ColumnRequest(col, "mask"))
            if func != "COUNT":
                requests.append(ColumnRequest(col, "values"))
        return requests

    def make_ops(self, dataset: Dataset) -> ScanOps:
        _, slots = self._plan()
        where_fn, _ = _compile_where(self.where, dataset)
        k = len(slots)

        def update(state: CustomSqlState, batch) -> CustomSqlState:
            device = state.sums.device

            def const(v):
                return torch.full((), v, dtype=_F64, device=device)

            sums, counts, mins, maxs = [], [], [], []
            for func, col in slots:
                mask = _row_mask(batch, where_fn) if col == "*" else _col_mask(batch, col, where_fn)
                counts.append(_mcount(mask))
                values = None if func == "COUNT" else _values(batch, col)
                sums.append(
                    _msum(values, mask).to(_F64) if func in ("SUM", "AVG") else const(0.0)
                )
                ends = func in ("MIN", "MAX")
                mins.append(_mmin(values, mask) if ends else const(float("inf")))
                maxs.append(_mmax(values, mask) if ends else const(float("-inf")))
            batch_state = CustomSqlState(
                torch.stack(sums), torch.stack(counts), torch.stack(mins), torch.stack(maxs)
            )
            return CustomSqlState.merge(state, batch_state)

        return ScanOps(lambda: CustomSqlState.identity(k), update, CustomSqlState.merge)

    def compute_metric_from_state(self, state) -> DoubleMetric:
        if state is None:
            return self.to_failure_metric(
                EmptyStateException("Empty state for analyzer CustomSql.")
            )
        node, slots = self._plan()
        sums, counts, mins, maxs = (
            torch.as_tensor(getattr(state, f)).cpu().tolist() for f in CustomSqlState._fields
        )
        values: Dict[_Slot, float] = {}
        for i, (func, col) in enumerate(slots):
            if func in ("AVG", "MIN", "MAX") and counts[i] == 0:
                return self.to_failure_metric(
                    EmptyStateException(f"{func}({col}) over zero rows in CustomSql.")
                )
            if func == "SUM":
                values[(func, col)] = float(sums[i])
            elif func == "COUNT":
                values[(func, col)] = float(counts[i])
            elif func == "AVG":
                values[(func, col)] = float(sums[i]) / counts[i]
            else:  # -0.0 -> 0.0, as Minimum and Maximum normalise it
                values[(func, col)] = float(mins[i] if func == "MIN" else maxs[i]) + 0.0
        try:
            result = _finalize(node, values)
        except Exception as exc:  # noqa: BLE001
            return self.to_failure_metric(exc)
        return DoubleMetric.success(self.entity, "CustomSql", self.instance, float(result))
