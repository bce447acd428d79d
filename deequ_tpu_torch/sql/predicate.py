"""A small SQL-expression compiler for predicates over device columns.

Counterpart of ``deequ_tpu/sql/predicate.py``: the same grammar, the
same plan-time checks and error messages, and the same values. The
reference's ``Compliance`` analyzer and ``.where(...)`` filters take
Spark SQL expression strings; this module compiles one to PyTorch ops
over a batch's device tensors:

- numeric columns evaluate on their device ``values``;
- string comparisons become *dictionary-code* operations: equality/IN
  are host-side dictionary lookups, LIKE/RLIKE a host-side regex sweep
  over the dictionary producing a per-code lookup table that the device
  gathers by code. Strings never reach the device.

Three-valued logic follows SQL: comparisons involving NULL are NULL; a
row "complies" iff the predicate is TRUE (not NULL, not FALSE). Division
and modulo by zero give NULL.

Supported grammar:

| form | notes |
|---|---|
| OR / AND / NOT | SQL three-valued logic |
| = == != <> < <= > >= | string orderings via shared lexicographic ranks |
| + - * / % , unary - | / and % by zero -> NULL |
| IS [NOT] NULL | |
| [NOT] IN (...) | string or numeric item lists |
| BETWEEN x AND y | |
| [NOT] LIKE 'pat%' / RLIKE 're' | host regex over the dictionary |
| CASE WHEN c THEN v ... [ELSE v] END | numeric/bool OR string branch values (homogeneous) |
| COALESCE(a, b, ...) | numeric/bool OR string arguments (homogeneous) |
| ABS(x) | |
| LENGTH(s) | also over TRIM/UPPER/... and CASE/CONCAT results |
| TRIM/LTRIM/RTRIM(s) | host transform over the dictionary |
| UPPER(s) / LOWER(s) | compose freely, e.g. UPPER(TRIM(s)) |
| SUBSTR/SUBSTRING(s, pos[, len]) | Spark 1-based semantics |
| CONCAT(...) | any mix of string columns/expressions and literals (cross-dictionary product bounded by a 65536-entry plan budget) |
| CAST(x AS INT/BIGINT/DOUBLE/...) | string operands parse per dictionary entry, unparseable -> NULL; timestamp columns -> epoch SECONDS (floor for integral targets) |
| CAST(x AS STRING) | string operands (identity) and boolean columns ('true'/'false') |
| ts_col <op> 'YYYY-MM-DD[ HH:MM:SS]' | date literal in the column's unit |
| DATE_ADD(ts_col, n) / DATE_SUB | shifts by whole days in the column's unit |
| DATEDIFF(a, b) | UTC-day difference; timestamp columns and/or date literals |
| literals | numbers, 'strings', TRUE/FALSE/NULL |

Unsupported syntax fails at PLANNING time (PredicateParseError), which
the runner turns into that analyzer's failure metric, never a failure
mid-scan that would take the analyzers scheduled beside it down too.

Evaluation runs eagerly on every batch, so every host-side product of a
compiled predicate (dictionary views, lookup tables, 0-d constants) is
built once per device and reused (:class:`_EvalContext`). Result dtypes
follow the JAX package's promotion: a literal is a 0-d float64 tensor,
which PyTorch's promotion treats as JAX treats a weakly-typed scalar;
the one rule that differs, integer true division involving int64
(float64 in JAX, float32 in PyTorch), is written out in
:func:`_true_divide`.
"""

from __future__ import annotations

import datetime as _dt
import re
import weakref
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deequ_tpu_torch.data.table import ROW_MASK, ColumnRequest, Dataset, Kind

# --------------------------------------------------------------------------
# Tokenizer
# --------------------------------------------------------------------------

_TOKEN_RE = re.compile(
    r"""
    (?P<ws>\s+)
  | (?P<number>\d+\.\d*(?:[eE][+-]?\d+)?|\.\d+(?:[eE][+-]?\d+)?|\d+(?:[eE][+-]?\d+)?)
  | (?P<string>'(?:[^'\\]|\\.)*'|"(?:[^"\\]|\\.)*")
  | (?P<bq_ident>`[^`]+`)
  | (?P<op><=|>=|!=|<>|==|=|<|>|\+|-|\*|/|%|\(|\)|,)
  | (?P<ident>[A-Za-z_][A-Za-z_0-9.]*)
    """,
    re.VERBOSE,
)

_KEYWORDS = {
    "AND", "OR", "NOT", "IS", "NULL", "IN", "BETWEEN", "LIKE", "RLIKE",
    "TRUE", "FALSE", "CASE", "WHEN", "THEN", "ELSE", "END", "CAST", "AS",
}


@dataclass(frozen=True)
class Token:
    kind: str  # 'number' | 'string' | 'ident' | 'op' | 'kw'
    text: str


def tokenize(expression: str) -> List[Token]:
    tokens: List[Token] = []
    pos = 0
    while pos < len(expression):
        m = _TOKEN_RE.match(expression, pos)
        if not m:
            raise PredicateParseError(
                f"cannot tokenize {expression[pos:pos + 20]!r} in predicate"
            )
        pos = m.end()
        if m.lastgroup == "ws":
            continue
        text = m.group()
        kind = m.lastgroup
        if kind == "bq_ident":
            tokens.append(Token("ident", text[1:-1]))
        elif kind == "ident" and text.upper() in _KEYWORDS:
            tokens.append(Token("kw", text.upper()))
        else:
            tokens.append(Token(kind, text))
    return tokens


class PredicateParseError(ValueError):
    pass


# --------------------------------------------------------------------------
# AST
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class Node:
    pass


@dataclass(frozen=True)
class ColumnRef(Node):
    name: str


@dataclass(frozen=True)
class NumberLit(Node):
    value: float


@dataclass(frozen=True)
class StringLit(Node):
    value: str


@dataclass(frozen=True)
class BoolLit(Node):
    value: bool


@dataclass(frozen=True)
class NullLit(Node):
    pass


@dataclass(frozen=True)
class UnaryOp(Node):
    op: str  # 'NOT' | 'NEG'
    operand: Node


@dataclass(frozen=True)
class BinOp(Node):
    op: str  # 'AND','OR','=','!=','<','<=','>','>=','+','-','*','/','%'
    left: Node
    right: Node


@dataclass(frozen=True)
class IsNull(Node):
    operand: Node
    negate: bool


@dataclass(frozen=True)
class InList(Node):
    operand: Node
    items: Tuple[Node, ...]
    negate: bool


@dataclass(frozen=True)
class Between(Node):
    operand: Node
    low: Node
    high: Node


@dataclass(frozen=True)
class Like(Node):
    operand: Node
    pattern: str
    regex: bool
    negate: bool


@dataclass(frozen=True)
class CaseWhen(Node):
    """CASE WHEN c1 THEN v1 [WHEN c2 THEN v2 ...] [ELSE v] END."""

    whens: Tuple[Tuple[Node, Node], ...]
    else_: Optional[Node]


@dataclass(frozen=True)
class Cast(Node):
    """CAST(expr AS type); numeric targets only (INT truncates toward
    zero; string operands parse per dictionary entry, unparseable ->
    NULL, Spark's cast semantics)."""

    operand: Node
    type_name: str  # 'INT' | 'BIGINT' | 'LONG' | 'FLOAT' | 'DOUBLE'


@dataclass(frozen=True)
class StarLit(Node):
    """The `*` inside COUNT(*) (aggregate expressions only)."""


@dataclass(frozen=True)
class FuncCall(Node):
    name: str
    args: Tuple[Node, ...]


class _Parser:
    def __init__(self, tokens: List[Token]):
        self.tokens = tokens
        self.pos = 0

    def peek(self) -> Optional[Token]:
        return self.tokens[self.pos] if self.pos < len(self.tokens) else None

    def next(self) -> Token:
        tok = self.peek()
        if tok is None:
            raise PredicateParseError("unexpected end of predicate")
        self.pos += 1
        return tok

    def accept(self, kind: str, text: Optional[str] = None) -> Optional[Token]:
        tok = self.peek()
        if tok and tok.kind == kind and (text is None or tok.text == text):
            return self.next()
        return None

    def expect(self, kind: str, text: Optional[str] = None) -> Token:
        tok = self.accept(kind, text)
        if tok is None:
            got = self.peek()
            raise PredicateParseError(
                f"expected {text or kind}, got {got.text if got else 'EOF'!r}"
            )
        return tok

    def parse(self) -> Node:
        node = self.or_expr()
        if self.peek() is not None:
            raise PredicateParseError(
                f"trailing tokens starting at {self.peek().text!r}"
            )
        return node

    def or_expr(self) -> Node:
        node = self.and_expr()
        while self.accept("kw", "OR"):
            node = BinOp("OR", node, self.and_expr())
        return node

    def and_expr(self) -> Node:
        node = self.not_expr()
        while self.accept("kw", "AND"):
            node = BinOp("AND", node, self.not_expr())
        return node

    def not_expr(self) -> Node:
        if self.accept("kw", "NOT"):
            return UnaryOp("NOT", self.not_expr())
        return self.comparison()

    def comparison(self) -> Node:
        node = self.additive()
        tok = self.peek()
        if tok is None:
            return node
        if tok.kind == "op" and tok.text in ("=", "==", "!=", "<>", "<", "<=", ">", ">="):
            self.next()
            op = {"==": "=", "<>": "!="}.get(tok.text, tok.text)
            return BinOp(op, node, self.additive())
        if tok.kind == "kw" and tok.text == "IS":
            self.next()
            negate = self.accept("kw", "NOT") is not None
            self.expect("kw", "NULL")
            return IsNull(node, negate)
        negate = False
        if tok.kind == "kw" and tok.text == "NOT":
            nxt = (
                self.tokens[self.pos + 1]
                if self.pos + 1 < len(self.tokens)
                else None
            )
            if nxt and nxt.kind == "kw" and nxt.text in ("IN", "LIKE", "RLIKE"):
                self.next()
                negate = True
                tok = self.peek()
        if tok and tok.kind == "kw" and tok.text == "IN":
            self.next()
            self.expect("op", "(")
            items = [self.additive()]
            while self.accept("op", ","):
                items.append(self.additive())
            self.expect("op", ")")
            return InList(node, tuple(items), negate)
        if tok and tok.kind == "kw" and tok.text == "BETWEEN":
            self.next()
            low = self.additive()
            self.expect("kw", "AND")
            high = self.additive()
            return Between(node, low, high)
        if tok and tok.kind == "kw" and tok.text in ("LIKE", "RLIKE"):
            self.next()
            pat = self.next()
            if pat.kind != "string":
                raise PredicateParseError(
                    f"{tok.text} expects a string pattern"
                )
            return Like(
                node,
                _unquote(pat.text),
                regex=tok.text == "RLIKE",
                negate=negate,
            )
        return node

    def additive(self) -> Node:
        node = self.multiplicative()
        while True:
            tok = self.peek()
            if tok and tok.kind == "op" and tok.text in ("+", "-"):
                self.next()
                node = BinOp(tok.text, node, self.multiplicative())
            else:
                return node

    def multiplicative(self) -> Node:
        node = self.unary()
        while True:
            tok = self.peek()
            if tok and tok.kind == "op" and tok.text in ("*", "/", "%"):
                self.next()
                node = BinOp(tok.text, node, self.unary())
            else:
                return node

    def unary(self) -> Node:
        if self.accept("op", "-"):
            return UnaryOp("NEG", self.unary())
        return self.primary()

    def primary(self) -> Node:
        tok = self.next()
        if tok.kind == "kw" and tok.text == "CAST":
            self.expect("op", "(")
            operand = self.or_expr()
            self.expect("kw", "AS")
            type_tok = self.next()
            if type_tok.kind != "ident":
                raise PredicateParseError(
                    f"CAST expects a type name, got {type_tok.text!r}"
                )
            self.expect("op", ")")
            return Cast(operand, type_tok.text.upper())
        if tok.kind == "kw" and tok.text == "CASE":
            whens: List[Tuple[Node, Node]] = []
            while self.accept("kw", "WHEN"):
                cond = self.or_expr()
                self.expect("kw", "THEN")
                whens.append((cond, self.or_expr()))
            if not whens:
                raise PredicateParseError(
                    "CASE requires at least one WHEN ... THEN branch"
                )
            else_ = self.or_expr() if self.accept("kw", "ELSE") else None
            self.expect("kw", "END")
            return CaseWhen(tuple(whens), else_)
        if tok.kind == "number":
            return NumberLit(float(tok.text))
        if tok.kind == "string":
            return StringLit(_unquote(tok.text))
        if tok.kind == "kw" and tok.text == "TRUE":
            return BoolLit(True)
        if tok.kind == "kw" and tok.text == "FALSE":
            return BoolLit(False)
        if tok.kind == "kw" and tok.text == "NULL":
            return NullLit()
        if tok.kind == "op" and tok.text == "(":
            node = self.or_expr()
            self.expect("op", ")")
            return node
        if tok.kind == "ident":
            if self.accept("op", "("):
                args: List[Node] = []
                if tok.text.upper() == "COUNT" and self.accept("op", "*"):
                    args.append(StarLit())  # COUNT(*) only
                    self.expect("op", ")")
                elif not self.accept("op", ")"):
                    args.append(self.or_expr())
                    while self.accept("op", ","):
                        args.append(self.or_expr())
                    self.expect("op", ")")
                return FuncCall(tok.text.upper(), tuple(args))
            return ColumnRef(tok.text)
        raise PredicateParseError(f"unexpected token {tok.text!r}")


def _unquote(s: str) -> str:
    body = s[1:-1]
    return re.sub(r"\\(.)", r"\1", body)


def parse_predicate(expression: str) -> Node:
    return _Parser(tokenize(expression)).parse()


def _validate_date_literal(text: str) -> None:
    """The ONE date-literal validation (plan time); comparison and
    DATEDIFF literals must accept/reject identically."""
    try:
        _dt.datetime.fromisoformat(text)
    except ValueError as exc:
        raise PredicateParseError(
            f"{text!r} is not a date/timestamp literal "
            "(YYYY-MM-DD[ HH:MM:SS])"
        ) from exc


def _sql_like_to_regex(pattern: str) -> str:
    out = []
    for ch in pattern:
        if ch == "%":
            out.append(".*")
        elif ch == "_":
            out.append(".")
        else:
            out.append(re.escape(ch))
    return "^" + "".join(out) + "$"


# --------------------------------------------------------------------------
# Compiler: AST -> (requests, eager eval over a batch)
# --------------------------------------------------------------------------

# An evaluated expression: (values, valid) with SQL null semantics, or for
# booleans (truth, valid). `values` may be numeric or int32 codes tagged
# with the column whose dictionary they index.


@dataclass
class _Val:
    values: torch.Tensor
    valid: torch.Tensor
    is_bool: bool = False
    codes_of: Optional[str] = None  # column name whose dictionary applies
    # host-side string transform composed over the dictionary (TRIM/
    # UPPER/LOWER/SUBSTR chains): consumers build per-code LUTs from
    # transform(dict[i]) instead of dict[i]; None = raw values
    transform: Optional[Callable[[str], str]] = None
    # SYNTHETIC string lane (string-valued CASE/COALESCE, multi-column
    # CONCAT, CAST(bool AS STRING)): ``values`` are codes into this
    # tuple instead of a column dictionary; entries may be None for
    # never-selected slots (row validity governs). codes_of stays None.
    entries: Optional[Tuple[Optional[str], ...]] = None
    # timestamp/date lane: ``ts_per_day`` = how many epoch units make
    # one UTC day (set for TIMESTAMP/date columns and DATE_ADD results;
    # 1 = day-valued). Comparisons convert string literals into this
    # unit, and mixed-unit lanes normalize to the finer unit.
    # ``ts_col`` names the source column when the values are its RAW
    # storage epochs; None for derived day-valued lanes.
    ts_col: Optional[str] = None
    ts_per_day: Optional[int] = None

    def view(self, value: str) -> str:
        return self.transform(value) if self.transform else value


class _EvalContext:
    """What predicate evaluation may touch: the schema (strong), the
    dictionaries and timestamp units (through a weak reference to the
    dataset), and a memo of everything built from them for one device:
    lookup tables, 0-d constants and host-side dictionary views. The
    memo keys are AST nodes (frozen, so equal nodes share an entry) or
    their children, so each is built on the first batch and reused."""

    def __init__(self, schema, ref, device: torch.device):
        self.schema = schema
        self._ref = ref
        self.device = device
        self._memo: Dict[Any, Any] = {}

    def _dataset(self) -> Dataset:
        dataset = self._ref()
        if dataset is None:  # pragma: no cover — contract violation
            raise RuntimeError(
                "string or timestamp predicate outlived its dataset; it "
                "is only evaluated while the owning run holds the data"
            )
        return dataset

    def dictionary(self, column: str):
        return self._dataset().dictionary(column)

    def timestamp_unit(self, column: str) -> str:
        """Storage unit of a timestamp/date column (the epoch unit its
        ``values`` hold)."""
        return self._dataset().timestamp_unit(column)

    def memo(self, key, build: Callable[[], Any]) -> Any:
        if key not in self._memo:
            self._memo[key] = build()
        return self._memo[key]

    def table(self, key, build: Callable[[], np.ndarray]) -> torch.Tensor:
        """A host-built lookup table on the device, built once."""
        return self.memo(
            ("table",) + key, lambda: torch.from_numpy(build()).to(self.device)
        )

    def scalar(self, value, dtype: torch.dtype) -> torch.Tensor:
        """A 0-d constant on the device, made once (a fill, no copy)."""
        return self.memo(
            ("scalar", type(value), value, dtype),
            lambda: torch.full((), value, dtype=dtype, device=self.device),
        )


class CompiledPredicate:
    """A predicate compiled against a dataset's schema + dictionaries.

    ``requests`` lists the device columns needed; ``evaluate(batch)``
    returns (truth: bool tensor, valid: bool tensor) on the batch's
    device. A row complies iff truth & valid.
    """

    def __init__(
        self,
        node: Node,
        dataset: Dataset,
        columns_used: Sequence[str],
        requests: Sequence[ColumnRequest],
    ):
        self._node = node
        # WEAK reference: a compiled predicate lives in the dataset's
        # compile cache, which must not keep the dataset alive
        self._dataset_ref = weakref.ref(dataset)
        self._schema = dataset.schema
        self.columns_used = tuple(columns_used)
        self.requests = tuple(requests)
        self._contexts: Dict[torch.device, _EvalContext] = {}

    def _context(self, device: torch.device) -> _EvalContext:
        ctx = self._contexts.get(device)
        if ctx is None:
            ctx = _EvalContext(self._schema, self._dataset_ref, device)
            self._contexts[device] = ctx
        return ctx

    def evaluate(self, batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        ctx = self._context(batch[ROW_MASK].device)
        return _as_bool(_eval(self._node, batch, ctx))

    def complies(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        truth, valid = self.evaluate(batch)
        return truth & valid


def compile_predicate(expression: str, dataset: Dataset) -> CompiledPredicate:
    # per-dataset compile cache: device_requests() and make_ops() both
    # compile the same expressions during planning
    cache = dataset._predicate_cache
    if expression in cache:
        return cache[expression]
    node = parse_predicate(expression)
    cols = sorted(_columns_of(node))
    schema = dataset.schema
    requests: List[ColumnRequest] = []
    for c in cols:
        if not schema.has_column(c):
            raise KeyError(f"predicate references unknown column '{c}'")
        kind = schema.kind_of(c)
        if kind == Kind.STRING:
            requests.append(ColumnRequest(c, "codes"))
        else:
            requests.append(ColumnRequest(c, "values"))
        requests.append(ColumnRequest(c, "mask"))
    for col in _length_columns_of(node):
        requests.append(ColumnRequest(col, "lengths"))
    # static type check NOW (planning time) so a bad predicate degrades
    # to THAT analyzer's failure metric — a raise later, inside the
    # shared fused scan, would fail every co-scheduled analyzer
    _check_types(node, schema)
    _check_plan_budgets(node, dataset)
    compiled = CompiledPredicate(node, dataset, cols, requests)
    cache[expression] = compiled
    return compiled


def _check_types(node: Node, schema) -> str:
    """Static kind inference: returns 'string' | 'stringlit' | 'value' |
    'null'; raises PredicateParseError on string/numeric mixes that the
    runtime would otherwise hit mid-scan."""

    def kind_of(n: Node) -> str:
        if isinstance(n, ColumnRef):
            k = schema.kind_of(n.name)
            if k == Kind.STRING:
                return "string"
            if k == Kind.TIMESTAMP:
                return "timestamp"
            return "value"
        if isinstance(n, StringLit):
            return "stringlit"
        if isinstance(n, NullLit):
            return "null"
        if isinstance(n, (NumberLit, BoolLit)):
            return "value"
        if isinstance(n, UnaryOp):
            k = kind_of(n.operand)
            if k in ("string", "stringlit"):
                raise PredicateParseError(
                    f"{'negation' if n.op == 'NEG' else 'NOT'} is "
                    "undefined for string operands"
                )
            return "value"
        if isinstance(n, IsNull):
            kind_of(n.operand)
            return "value"
        if isinstance(n, Between):
            check_cmp(n.operand, n.low)
            check_cmp(n.operand, n.high)
            return "value"
        if isinstance(n, CaseWhen):
            results = [r for _, r in n.whens]
            if n.else_ is not None:
                results.append(n.else_)
            for cond, _ in n.whens:
                if kind_of(cond) in ("string", "stringlit"):
                    raise PredicateParseError(
                        "a CASE condition must be boolean, not a bare "
                        "string operand"
                    )
            return _homogeneous_branches(
                [kind_of(r) for r in results], "CASE"
            )
        if isinstance(n, InList):
            base = kind_of(n.operand)
            for item in n.items:
                if isinstance(item, NullLit):
                    continue
                item_kind = kind_of(item)
                if base == "string" and item_kind != "stringlit":
                    raise PredicateParseError(
                        "IN on a string column requires string literals"
                    )
                if base != "string" and item_kind == "stringlit":
                    raise PredicateParseError(
                        "IN with string literals requires a string column"
                    )
            return "value"
        if isinstance(n, Like):
            if kind_of(n.operand) != "string":
                raise PredicateParseError("LIKE requires a string column")
            return "value"
        if isinstance(n, Cast):
            if (
                n.type_name not in _CAST_TYPES
                and n.type_name not in _STRING_CASTS
            ):
                raise PredicateParseError(
                    f"CAST to {n.type_name} is not supported "
                    "(numeric or STRING targets)"
                )
            k = kind_of(n.operand)
            if k == "stringlit":
                raise PredicateParseError(
                    "CAST of a string literal is constant"
                )
            if n.type_name in _STRING_CASTS:
                if k == "string":
                    return "string"
                if (
                    isinstance(n.operand, ColumnRef)
                    and schema.kind_of(n.operand.name) == Kind.BOOLEAN
                ):
                    return "string"
                raise PredicateParseError(
                    "CAST to STRING supports string and boolean "
                    "operands only (numeric/timestamp formatting is "
                    "not supported)"
                )
            if k == "timestamp" and not isinstance(n.operand, ColumnRef):
                # day-valued DATE_ADD/DATE_SUB results are DATEs;
                # Spark refuses date -> numeric casts
                raise PredicateParseError(
                    "CAST of a date value to a number is not "
                    "supported (Spark refuses date -> numeric)"
                )
            # timestamp COLUMNS cast to epoch seconds (Spark); the
            # date-typed-column refusal needs the arrow type and lives
            # in _check_plan_budgets
            return "value"
        if isinstance(n, FuncCall):
            # the predicate evaluator supports only these functions;
            # aggregates (SUM/COUNT/...) belong to CustomSql expressions
            # and must fail HERE (planning time), not mid-scan where
            # they would poison every co-scheduled analyzer
            if n.name not in (
                "ABS", "LENGTH", "COALESCE", "CONCAT",
                "DATE_ADD", "DATE_SUB", "DATEDIFF",
            ) + _STRING_FNS:
                raise PredicateParseError(
                    f"unsupported function {n.name} in a predicate"
                )
            if n.name in ("DATE_ADD", "DATE_SUB"):
                if len(n.args) != 2:
                    raise PredicateParseError(
                        f"{n.name} takes (timestamp column, days)"
                    )
                if kind_of(n.args[0]) != "timestamp":
                    raise PredicateParseError(
                        f"{n.name} requires a timestamp/date column"
                    )
                _static_int(n.args[1], f"{n.name} day count")
                return "timestamp"
            if n.name == "DATEDIFF":
                if len(n.args) != 2:
                    raise PredicateParseError(
                        "DATEDIFF takes (end, start)"
                    )
                kinds_ = []
                for a in n.args:
                    k = kind_of(a)
                    if k == "stringlit":
                        assert isinstance(a, StringLit)
                        _validate_date_literal(a.value)
                    elif k != "timestamp":
                        raise PredicateParseError(
                            "DATEDIFF arguments must be timestamp "
                            "columns or date literals"
                        )
                    kinds_.append(k)
                if all(k == "stringlit" for k in kinds_):
                    raise PredicateParseError(
                        "DATEDIFF of two literals is constant"
                    )
                return "value"
            if n.name == "CONCAT":
                if not n.args:
                    raise PredicateParseError("CONCAT needs arguments")
                col_args = 0
                for a in n.args:
                    k = kind_of(a)
                    if k == "string":
                        col_args += 1
                    elif k != "stringlit":
                        raise PredicateParseError(
                            "CONCAT arguments must be strings"
                        )
                if col_args == 0:
                    raise PredicateParseError(
                        "CONCAT of only literals is constant"
                    )
                # multi-column CONCAT builds a cross-product synthetic
                # dictionary; its SIZE is validated against the plan
                # budget in _check_plan_budgets (needs dictionaries)
                return "string"
            for a in n.args:
                if isinstance(a, StarLit):
                    raise PredicateParseError(
                        f"* is not a valid argument to {n.name}"
                    )
            if n.name in _STRING_FNS:
                # FULL static validation here: a raise later, inside
                # the shared fused scan, would poison every
                # co-scheduled analyzer (this module's core invariant)
                if n.name in ("SUBSTR", "SUBSTRING"):
                    if len(n.args) not in (2, 3):
                        raise PredicateParseError(
                            f"{n.name} takes (string, pos[, length])"
                        )
                    _static_int(n.args[1], f"{n.name} position")
                    if len(n.args) == 3:
                        _static_int(n.args[2], f"{n.name} length")
                elif len(n.args) != 1:
                    raise PredicateParseError(
                        f"{n.name} takes exactly one argument"
                    )
                if kind_of(n.args[0]) != "string":
                    raise PredicateParseError(
                        f"{n.name} requires a string column operand"
                    )
                return "string"
            if n.name == "COALESCE":
                if not n.args:
                    raise PredicateParseError(
                        "COALESCE needs arguments"
                    )
                return _homogeneous_branches(
                    [kind_of(a) for a in n.args], "COALESCE"
                )
            if n.name == "LENGTH":
                for a in n.args:
                    kind_of(a)
                return "value"
            for a in n.args:
                kind_of(a)
            return "value"
        if isinstance(n, BinOp):
            if n.op in ("AND", "OR"):
                for side in (n.left, n.right):
                    if kind_of(side) in ("string", "stringlit"):
                        raise PredicateParseError(
                            "a bare string operand is not a boolean "
                            f"(in {n.op})"
                        )
                return "value"
            lk, rk = kind_of(n.left), kind_of(n.right)
            if n.op in _CMP:
                check_kinds(lk, rk, n.op)
                check_ts_literal(n.left, lk, n.right, rk)
                return "value"
            # arithmetic
            for k in (lk, rk):
                if k in ("string", "stringlit"):
                    raise PredicateParseError(
                        f"arithmetic {n.op!r} is undefined for string "
                        "operands"
                    )
            return "value"
        return "value"

    def check_kinds(lk: str, rk: str, op: str) -> None:
        stringish = ("string", "stringlit")
        if "null" in (lk, rk):
            return
        # timestamp vs string literal: the literal is a date — valid
        if {"timestamp", "stringlit"} == {lk, rk}:
            return
        if lk == "timestamp":
            lk = "value"
        if rk == "timestamp":
            rk = "value"
        if (lk in stringish) != (rk in stringish):
            raise PredicateParseError(
                "cannot compare a string operand with a non-string "
                "operand (dictionary codes are not values)"
            )
        if lk == "stringlit" and rk == "stringlit":
            raise PredicateParseError(
                f"comparison {op!r} of two string literals is constant"
            )

    def check_ts_literal(a: Node, ak: str, b: Node, bk: str) -> None:
        """A timestamp-vs-string-literal compare carries a STATIC date
        literal — validate it NOW (plan time), not mid-scan."""
        for node_, kind_, other in ((a, ak, bk), (b, bk, ak)):
            if kind_ == "stringlit" and other == "timestamp":
                assert isinstance(node_, StringLit)
                _validate_date_literal(node_.value)

    def check_cmp(a: Node, b: Node) -> None:
        check_kinds(kind_of(a), kind_of(b), "BETWEEN")
        check_ts_literal(a, kind_of(a), b, kind_of(b))

    return kind_of(node)


def _homogeneous_branches(kinds: List[str], what: str) -> str:
    """CASE/COALESCE result branches must all be stringish or all
    value-ish (NULLs are neutral); returns the result kind."""
    stringish = [k for k in kinds if k in ("string", "stringlit")]
    valueish = [k for k in kinds if k in ("value", "timestamp")]
    if stringish and valueish:
        raise PredicateParseError(
            f"{what} branches mix string and non-string results"
        )
    return "string" if stringish else "value"


def _estimated_entries(node: Node, dataset: Dataset) -> int:
    """Upper bound on a string expression's dictionary size (plan
    time): column lanes count their dictionary, CONCAT multiplies,
    CASE/COALESCE unions sum, literals are 1."""
    if isinstance(node, StringLit):
        return 1
    if isinstance(node, ColumnRef):
        return len(dataset.dictionary(node.name))
    if isinstance(node, FuncCall):
        if node.name == "CONCAT":
            total = 1
            for a in node.args:
                e = _estimated_entries(a, dataset)
                if e > 1:  # literals fold into neighbors
                    total *= e
            return total
        if node.name == "COALESCE":
            return sum(
                _estimated_entries(a, dataset) for a in node.args
            )
        if node.name in _STRING_FNS:
            return _estimated_entries(node.args[0], dataset)
    if isinstance(node, CaseWhen):
        total = sum(
            _estimated_entries(r, dataset) for _, r in node.whens
        )
        if node.else_ is not None:
            total += _estimated_entries(node.else_, dataset)
        return total
    if isinstance(node, Cast):  # CAST(s AS STRING) is identity
        return _estimated_entries(node.operand, dataset)
    return 2  # bool lanes etc.


def _check_plan_budgets(node: Node, dataset: Dataset) -> None:
    """Dictionary-dependent plan-time validation (runs after the
    static type check, with the dataset in hand): CONCAT cross-product
    budgets and the date-typed-column CAST refusal."""
    if isinstance(node, FuncCall) and node.name == "CONCAT":
        est = _estimated_entries(node, dataset)
        if est > _CONCAT_DICT_BUDGET:
            raise PredicateParseError(
                f"CONCAT cross-dictionary size ~{est} exceeds the "
                f"{_CONCAT_DICT_BUDGET}-entry plan budget"
            )
    if (
        isinstance(node, Cast)
        and node.type_name in _CAST_TYPES
        and isinstance(node.operand, ColumnRef)
        and dataset.schema.kind_of(node.operand.name) == Kind.TIMESTAMP
    ):
        if dataset.timestamp_unit(node.operand.name) in ("date32", "date64"):
            raise PredicateParseError(
                "CAST of a DATE column to a number is not supported "
                "(Spark refuses date -> numeric)"
            )
    for child in _children_of(node):
        _check_plan_budgets(child, dataset)


def _children_of(node: Node):
    """Every child Node, uniformly across node shapes (incl. CASE)."""
    for attr in ("operand", "left", "right", "low", "high", "else_"):
        child = getattr(node, attr, None)
        if isinstance(child, Node):
            yield child
    for attr in ("items", "args"):
        for child in getattr(node, attr, ()):
            if isinstance(child, Node):
                yield child
    for pair in getattr(node, "whens", ()):
        yield pair[0]
        yield pair[1]


def _length_columns_of(node: Node) -> set:
    """Columns appearing as LENGTH(col) — they need the 'lengths' repr."""
    out: set = set()
    if isinstance(node, FuncCall) and node.name == "LENGTH":
        for arg in node.args:
            if isinstance(arg, ColumnRef):
                out.add(arg.name)
    for child in _children_of(node):
        out |= _length_columns_of(child)
    return out


def _columns_of(node: Node) -> set:
    if isinstance(node, ColumnRef):
        return {node.name}
    out: set = set()
    for child in _children_of(node):
        out |= _columns_of(child)
    return out


def _as_bool(v: _Val) -> Tuple[torch.Tensor, torch.Tensor]:
    if v.is_bool:
        return v.values.to(torch.bool), v.valid
    return v.values != 0, v.valid


_CMP = ("=", "!=", "<", "<=", ">", ">=")
_CMP_FNS = {
    "=": torch.eq,
    "!=": torch.ne,
    "<": torch.lt,
    "<=": torch.le,
    ">": torch.gt,
    ">=": torch.ge,
}


def _cmp(op: str, a, b) -> torch.Tensor:
    """Comparison where either side may be a Python int (a literal's
    epoch or rank)."""
    if not isinstance(a, torch.Tensor):
        return _CMP_FNS[_FLIP[op]](b, a)
    return _CMP_FNS[op](a, b)


_FLIP = {"=": "=", "!=": "!=", "<": ">", "<=": ">=", ">": "<", ">=": "<="}


def _true_divide(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a / b`` with the JAX package's result dtype: integer operands
    divide in float64 when either is int64 (PyTorch would use float32);
    every other pairing promotes alike in both frameworks."""
    if not (a.dtype.is_floating_point or b.dtype.is_floating_point) and (
        torch.int64 in (a.dtype, b.dtype)
    ):
        a, b = a.to(torch.float64), b.to(torch.float64)
    return a / b


def _is_string_lane(v: "_Val") -> bool:
    """Column-backed (codes_of) OR synthetic (entries) string lane."""
    return v.codes_of is not None or v.entries is not None


def _lane_entries(ctx: _EvalContext, v: "_Val", key) -> "list[Optional[str]]":
    """The lane's dictionary as the EXPRESSION sees it (``key`` names
    the node that produced ``v``): synthetic entries verbatim;
    column-backed entries through the composed view."""
    if v.entries is not None:
        return list(v.entries)
    return ctx.memo(
        ("entries", key),
        lambda: [
            None if x is None else v.view(str(x))
            for x in ctx.dictionary(v.codes_of)
        ],
    )


def _dict_lookup(ctx: _EvalContext, column: str, value: str) -> int:
    def find() -> int:
        matches = np.nonzero(ctx.dictionary(column) == value)[0]
        return int(matches[0]) if len(matches) else -2  # -2: matches nothing

    return ctx.memo(("lookup", column, value), find)


def _gather_null_slot(table: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """``table[code]`` with null codes (< 0) reading the trailing slot."""
    last = table.shape[0] - 1
    idx = torch.where(codes < 0, last, codes).clamp(0, last)
    return table[idx.to(torch.int64)]


def _string_eq_lut(ctx: _EvalContext, base: "_Val", key, literal: str) -> torch.Tensor:
    """Per-code bool for ``view(entry[i]) == literal`` — required when a
    transform applies (several raw entries may map to the same
    transformed value, so a single-code lookup can't represent it) and
    for synthetic lanes."""

    def build() -> np.ndarray:
        view = _lane_entries(ctx, base, key)
        table = np.zeros(len(view) + 1, dtype=bool)
        for i, s in enumerate(view):
            if s is not None and s == literal:
                table[i] = True
        return table

    return _gather_null_slot(ctx.table(("eq", key, literal), build), base.values)


def _rank_table(
    views: "list[list[str]]", extra: "list[str]"
) -> "dict[str, int]":
    """Lexicographic rank of every distinct string across the given
    (already-transformed) dictionary views (+ literals): the shared
    value domain that makes codes from unrelated dictionaries — or
    transformed views of them — comparable."""
    values = set(extra)
    for view in views:
        values.update(v for v in view if v is not None)
    return {v: i for i, v in enumerate(sorted(values))}


def _ranks_for(
    view: "list[Optional[str]]", rank: "dict[str, int]"
) -> np.ndarray:
    """int32 LUT code -> shared rank; one trailing slot (-1) for null
    codes so a single clipped gather covers every code."""
    out = np.full(len(view) + 1, -1, dtype=np.int32)
    for i, v in enumerate(view):
        if v is not None:
            out[i] = rank[v]
    return out


def _shared_rank_luts(ctx: _EvalContext, node: "BinOp", a: "_Val", b: "_Val"):
    def build():
        va = _lane_entries(ctx, a, node.left)
        vb = _lane_entries(ctx, b, node.right)
        rank = _rank_table(
            [[x for x in va if x is not None], [x for x in vb if x is not None]],
            [],
        )
        return (
            torch.from_numpy(_ranks_for(va, rank)).to(ctx.device),
            torch.from_numpy(_ranks_for(vb, rank)).to(ctx.device),
        )

    return ctx.memo(("rank2", node), build)


def _rank_lut_with_literal(ctx: _EvalContext, base: "_Val", key, literal: str):
    def build():
        view = _lane_entries(ctx, base, key)
        rank = _rank_table([[x for x in view if x is not None]], [literal])
        return torch.from_numpy(_ranks_for(view, rank)).to(ctx.device), rank[literal]

    return ctx.memo(("rank_lit", key, literal), build)


_STRING_FNS = ("TRIM", "LTRIM", "RTRIM", "UPPER", "LOWER", "SUBSTR",
               "SUBSTRING")
_CAST_TYPES = (
    "INT", "INTEGER", "BIGINT", "LONG", "SMALLINT", "TINYINT",
    "FLOAT", "DOUBLE", "REAL",
)
_INT_CASTS = ("INT", "INTEGER", "BIGINT", "LONG", "SMALLINT", "TINYINT")
_STRING_CASTS = ("STRING", "VARCHAR", "TEXT")
# cap on a synthetic cross-product dictionary (multi-column CONCAT):
# host-side string materialization + per-code LUT sizes stay bounded
_CONCAT_DICT_BUDGET = 1 << 16
# JVM d2i-style saturation bounds per integral target (f64 lane: the
# i64 bounds round to the nearest representable double)
_INT_CAST_BOUNDS = {
    "INT": (-2147483648.0, 2147483647.0),
    "INTEGER": (-2147483648.0, 2147483647.0),
    "BIGINT": (-9.223372036854776e18, 9.223372036854776e18),
    "LONG": (-9.223372036854776e18, 9.223372036854776e18),
    "SMALLINT": (-32768.0, 32767.0),
    "TINYINT": (-128.0, 127.0),
}


def _static_int(node: Node, what: str) -> int:
    """A SUBSTR position/length argument must be a static integer."""
    if isinstance(node, UnaryOp) and node.op == "NEG":
        return -_static_int(node.operand, what)
    if isinstance(node, NumberLit) and float(node.value).is_integer():
        return int(node.value)
    raise PredicateParseError(f"{what} must be an integer literal")


def _substr(s: str, pos: int, length: Optional[int]) -> str:
    """Spark substring semantics: 1-based; pos 0 behaves like 1;
    negative pos counts from the end; negative length -> empty."""
    if pos > 0:
        start = pos - 1
    elif pos < 0:
        start = max(len(s) + pos, 0)
    else:
        start = 0
    if length is None:
        return s[start:]
    if length <= 0:
        return ""
    return s[start:start + length]


def _eval_string_fn(
    node: "FuncCall", batch: Dict[str, torch.Tensor], ctx: _EvalContext
) -> "_Val":
    """TRIM/LTRIM/RTRIM/UPPER/LOWER/SUBSTR compose a host-side
    transform over the operand's dictionary view; codes/validity pass
    through untouched (the device never sees strings)."""
    if node.name in ("SUBSTR", "SUBSTRING"):
        if len(node.args) not in (2, 3):
            raise PredicateParseError(
                f"{node.name} takes (string, pos[, length])"
            )
        base = _eval(node.args[0], batch, ctx)
        pos = _static_int(node.args[1], f"{node.name} position")
        length = (
            _static_int(node.args[2], f"{node.name} length")
            if len(node.args) == 3
            else None
        )
        inner = base.view

        def transform(s: str, _pos=pos, _len=length, _inner=inner):
            return _substr(_inner(s), _pos, _len)

    else:
        if len(node.args) != 1:
            raise PredicateParseError(
                f"{node.name} takes exactly one argument"
            )
        base = _eval(node.args[0], batch, ctx)
        inner = base.view
        fn = {
            "TRIM": str.strip,
            "LTRIM": str.lstrip,
            "RTRIM": str.rstrip,
            "UPPER": str.upper,
            "LOWER": str.lower,
        }[node.name]

        def transform(s: str, _fn=fn, _inner=inner):
            return _fn(_inner(s))

    if base.entries is not None:
        # synthetic lane: entries are final strings — apply the
        # function eagerly instead of composing a lazy transform
        entries = ctx.memo(
            ("strfn", node),
            lambda: tuple(None if e is None else transform(e) for e in base.entries),
        )
        return _Val(base.values, base.valid, entries=entries)
    if base.codes_of is None:
        raise PredicateParseError(
            f"{node.name} requires a string column operand"
        )
    return _Val(
        base.values, base.valid, codes_of=base.codes_of,
        transform=transform,
    )


_UNITS_PER_SECOND = {"s": 1, "ms": 1_000, "us": 1_000_000, "ns": 1_000_000_000}


def _units_per_day(unit: str) -> int:
    """How many of the column's int64 epoch units make one UTC day."""
    if unit == "date32":
        return 1
    if unit == "date64":
        return 86_400_000
    if unit not in _UNITS_PER_SECOND:
        raise PredicateParseError(f"unsupported timestamp unit {unit!r}")
    return 86_400 * _UNITS_PER_SECOND[unit]


def _epoch_days_of_literal(literal: str) -> int:
    d = _dt.datetime.fromisoformat(literal).date()
    return (d - _dt.date(1970, 1, 1)).days


def _date_literal_epoch(ctx: _EvalContext, column: str, literal: str) -> int:
    """'YYYY-MM-DD[ HH:MM:SS[.ffffff]]' -> the column's int64 epoch
    value, as Arrow's cast of the literal into the column's type gives
    it: date columns keep the date, timestamps floor to their unit, and
    an offset-aware literal converts to UTC."""
    try:
        dt = _dt.datetime.fromisoformat(literal)
    except ValueError as exc:
        raise PredicateParseError(
            f"{literal!r} is not a date/timestamp literal "
            "(YYYY-MM-DD[ HH:MM:SS])"
        ) from exc
    unit = ctx.timestamp_unit(column)
    if unit in ("date32", "date64"):
        days = (dt.date() - _dt.date(1970, 1, 1)).days
        return days if unit == "date32" else days * 86_400_000
    if dt.tzinfo is not None:
        dt = dt.astimezone(_dt.timezone.utc).replace(tzinfo=None)
    micros = (dt - _dt.datetime(1970, 1, 1)) // _dt.timedelta(microseconds=1)
    per_second = _UNITS_PER_SECOND[unit]
    if per_second >= 1_000_000:
        return micros * (per_second // 1_000_000)
    return micros // (1_000_000 // per_second)


def _eval_stringish(node: Node, batch, ctx):
    """Branch evaluation for CASE/COALESCE, where a bare string
    literal (or NULL) is a legal RESULT: literals become ('lit', s)
    markers instead of erroring, everything else evaluates."""
    if isinstance(node, StringLit):
        return ("lit", node.value)
    if isinstance(node, NullLit):
        return ("null",)
    return _eval(node, batch, ctx)


def _any_stringish(branches) -> bool:
    return any(
        (isinstance(b, tuple) and b[0] == "lit")
        or (isinstance(b, _Val) and _is_string_lane(b))
        for b in branches
    )


def _string_union(ctx: _EvalContext, key, nodes, branches):
    """Union synthetic dictionary over string branches + each branch
    as (union codes, valid). Branches: ('lit', s) | ('null',) | string
    _Val lanes (homogeneity is enforced at plan time; a numeric _Val
    here means the checker missed a case — refuse loudly). ``nodes``
    are the branches' AST nodes."""

    def build():
        values: set = set()
        views: List[Optional[List[Optional[str]]]] = []
        for n, b in zip(nodes, branches):
            if isinstance(b, tuple):
                views.append(None)
                if b[0] == "lit":
                    values.add(b[1])
            elif _is_string_lane(b):
                view = _lane_entries(ctx, b, n)
                views.append(view)
                values.update(v for v in view if v is not None)
            else:
                raise PredicateParseError(
                    "CASE/COALESCE branches mix string and non-string "
                    "results"
                )
        union = sorted(values)
        index = {v: i for i, v in enumerate(union)}
        luts = []
        for b, view in zip(branches, views):
            if view is None:
                luts.append(None)
                continue
            lut = np.zeros(len(view) + 1, dtype=np.int32)
            for i, v in enumerate(view):
                if v is not None:
                    lut[i] = index[v]
            luts.append(torch.from_numpy(lut).to(ctx.device))
        return union, index, luts

    union, index, luts = ctx.memo(("union", key), build)
    out = []
    for b, lut in zip(branches, luts):
        if isinstance(b, tuple):
            if b[0] == "lit":
                out.append((ctx.scalar(index[b[1]], torch.int32),
                            ctx.scalar(True, torch.bool)))
            else:
                out.append((ctx.scalar(0, torch.int32), ctx.scalar(False, torch.bool)))
        else:
            out.append((_gather_null_slot(lut, b.values), b.valid))
    return union, out


def _eval(node: Node, batch: Dict[str, torch.Tensor], ctx: _EvalContext) -> _Val:
    if isinstance(node, ColumnRef):
        kind = ctx.schema.kind_of(node.name)
        mask = batch[f"{node.name}::mask"]
        if kind == Kind.STRING:
            return _Val(batch[f"{node.name}::codes"], mask, codes_of=node.name)
        vals = batch[f"{node.name}::values"]
        is_ts = kind == Kind.TIMESTAMP
        return _Val(
            vals,
            mask,
            is_bool=kind == Kind.BOOLEAN,
            ts_col=node.name if is_ts else None,
            ts_per_day=(
                _units_per_day(ctx.timestamp_unit(node.name)) if is_ts else None
            ),
        )
    if isinstance(node, NumberLit):
        return _Val(ctx.scalar(node.value, torch.float64), ctx.scalar(True, torch.bool))
    if isinstance(node, BoolLit):
        return _Val(
            ctx.scalar(node.value, torch.bool), ctx.scalar(True, torch.bool), is_bool=True
        )
    if isinstance(node, NullLit):
        return _Val(ctx.scalar(0.0, torch.float64), ctx.scalar(False, torch.bool))
    if isinstance(node, StringLit):
        # bare string literal only makes sense inside comparisons, which
        # special-case it; standing alone it is an error
        raise PredicateParseError(
            f"string literal {node.value!r} outside comparison"
        )
    if isinstance(node, UnaryOp):
        if node.op == "NEG":
            v = _eval(node.operand, batch, ctx)
            return _Val(-v.values, v.valid)
        truth, valid = _as_bool(_eval(node.operand, batch, ctx))
        return _Val(~truth, valid, is_bool=True)
    if isinstance(node, IsNull):
        v = _eval(node.operand, batch, ctx)
        res = v.valid if node.negate else ~v.valid
        return _Val(res, torch.ones_like(res, dtype=torch.bool), is_bool=True)
    if isinstance(node, Between):
        return _eval(
            BinOp(
                "AND",
                BinOp(">=", node.operand, node.low),
                BinOp("<=", node.operand, node.high),
            ),
            batch,
            ctx,
        )
    if isinstance(node, Cast):
        return _eval_cast(node, batch, ctx)
    if isinstance(node, CaseWhen):
        return _eval_case(node, batch, ctx)
    if isinstance(node, InList):
        base = _eval(node.operand, batch, ctx)
        truth = torch.zeros_like(base.values, dtype=torch.bool)
        has_null_item = False
        for item in node.items:
            if isinstance(item, NullLit):
                # SQL: x IN (..., NULL) is TRUE on a match, else NULL
                has_null_item = True
            elif isinstance(item, StringLit):
                if not _is_string_lane(base):
                    raise PredicateParseError(
                        "IN with string literals requires a string column"
                    )
                if base.transform is not None or base.entries is not None:
                    truth = truth | _string_eq_lut(ctx, base, node.operand, item.value)
                else:
                    code = _dict_lookup(ctx, base.codes_of, item.value)
                    truth = truth | (base.values == code)
            else:
                rhs = _eval(item, batch, ctx)
                truth = truth | ((base.values == rhs.values) & rhs.valid)
        valid = base.valid
        if has_null_item:
            valid = valid & truth  # non-matches become NULL
        if node.negate:
            truth = ~truth
        return _Val(truth, valid, is_bool=True)
    if isinstance(node, Like):
        base = _eval(node.operand, batch, ctx)
        if not _is_string_lane(base):
            raise PredicateParseError("LIKE requires a string column")

        def build() -> np.ndarray:
            view = _lane_entries(ctx, base, node.operand)
            pattern = (
                node.pattern if node.regex else _sql_like_to_regex(node.pattern)
            )
            prog = re.compile(pattern)
            table = np.zeros(len(view) + 1, dtype=bool)
            for i, s in enumerate(view):
                if s is not None and prog.search(s):
                    table[i] = True
            return table

        truth = _gather_null_slot(ctx.table(("like", node), build), base.values)
        truth = torch.where(base.values < 0, False, truth)
        if node.negate:
            truth = ~truth
        return _Val(truth, base.valid, is_bool=True)
    if isinstance(node, FuncCall):
        return _eval_function(node, batch, ctx)
    if isinstance(node, BinOp):
        return _eval_binop(node, batch, ctx)
    raise PredicateParseError(f"cannot evaluate node {node!r}")


def _eval_cast(node: "Cast", batch, ctx: _EvalContext) -> _Val:
    v = _eval(node.operand, batch, ctx)
    if node.type_name in _STRING_CASTS:
        if _is_string_lane(v):
            return v  # identity (transform/entries preserved)
        if v.is_bool:
            # Spark: cast(true AS STRING) = 'true'
            return _Val(
                v.values.to(torch.int32),
                v.valid,
                entries=("false", "true"),
            )
        raise PredicateParseError(
            "CAST to STRING supports string and boolean operands "
            "only (numeric/timestamp formatting is not supported)"
        )
    integral = node.type_name in _INT_CASTS
    if v.ts_per_day is not None:
        # Spark: cast(timestamp AS BIGINT/DOUBLE) = epoch SECONDS
        # (floor for integral targets, then the same saturation bounds
        # every integral cast applies); date operands are refused at
        # plan time like Spark's analyzer does
        upd = v.ts_per_day // 86_400  # units per second
        raw = v.values.to(torch.int64)
        if integral:
            lo, hi = _INT_CAST_BOUNDS[node.type_name]
            vals = torch.clamp(
                torch.div(raw, upd, rounding_mode="floor").to(torch.float64), lo, hi
            )
        else:
            vals = raw.to(torch.float64) / float(upd)
        return _Val(vals, v.valid)
    if _is_string_lane(v):
        # string lane: parse each dictionary entry ONCE (Spark cast
        # semantics: unparseable -> NULL). Validity lives in its OWN
        # table: an entry 'NaN' casts to the VALUE NaN, not to NULL.
        def build():
            view = _lane_entries(ctx, v, node.operand)
            table = np.zeros(len(view) + 1)
            ok = np.zeros(len(view) + 1, dtype=bool)
            for i, s in enumerate(view):
                if s is not None:
                    text = s.strip()
                    if "_" in text:  # Python-only numeric syntax
                        continue  # ('1_0'); Spark casts it to NULL
                    try:
                        table[i] = float(text)
                        ok[i] = True
                    except ValueError:
                        pass
            return (torch.from_numpy(table).to(ctx.device),
                    torch.from_numpy(ok).to(ctx.device))

        lut, ok_lut = ctx.memo(("cast", node.operand), build)
        vals = _gather_null_slot(lut, v.values)
        valid = v.valid & _gather_null_slot(ok_lut, v.values)
        vals = torch.where(valid, vals, 0.0)
        if integral:
            # a string with no finite numeric value has no integral
            # parse -> NULL (Spark's string-to-int cast rejects 'NaN'/
            # 'Infinity'); finite parses saturate at the target bounds
            # like the numeric-source path
            finite = torch.isfinite(vals)
            valid = valid & finite
            lo, hi = _INT_CAST_BOUNDS[node.type_name]
            vals = torch.clamp(torch.trunc(torch.where(finite, vals, 0.0)), lo, hi)
        return _Val(vals, valid)
    vals = v.values.to(torch.float64)
    valid = v.valid
    if integral:
        # numeric source follows JVM double-to-int conversion like
        # non-ANSI Spark: truncate toward zero, SATURATE at the target
        # bounds, NaN -> 0 (not NULL)
        lo, hi = _INT_CAST_BOUNDS[node.type_name]
        vals = torch.clamp(torch.trunc(vals), lo, hi)
        vals = torch.where(torch.isnan(vals), 0.0, vals)
    return _Val(vals, valid)


def _eval_case(node: "CaseWhen", batch, ctx: _EvalContext) -> _Val:
    # SQL: first branch whose condition is TRUE wins (NULL conditions
    # skip); no match and no ELSE -> NULL. Folded in reverse so earlier
    # branches override later ones. String-valued results (homogeneous,
    # enforced at plan time) fold the same way over codes into a UNION
    # synthetic dictionary.
    branches = [
        (cond, _eval_stringish(r, batch, ctx))
        for cond, r in node.whens
    ]
    else_b = (
        _eval_stringish(node.else_, batch, ctx)
        if node.else_ is not None
        else ("null",)
    )
    if _any_stringish([b for _, b in branches] + [else_b]):
        union, codes_of_branch = _string_union(
            ctx,
            node,
            [r for _, r in node.whens] + [node.else_],
            [b for _, b in branches] + [else_b],
        )
        vals, valid = codes_of_branch[-1]
        for (cond, _), (bc, bv) in zip(
            reversed(branches), reversed(codes_of_branch[:-1])
        ):
            ct, cv = _as_bool(_eval(cond, batch, ctx))
            hit = ct & cv
            vals = torch.where(hit, bc, vals)
            valid = torch.where(hit, bv, valid)
        return _Val(vals, valid, entries=tuple(union))

    # numeric fold, REUSING the already-evaluated branches (a ('null',)
    # marker is an invalid slot); branch values coerce to f64 (SQL
    # promotes mixed numeric/bool CASE branches)
    def as_num(b):
        if isinstance(b, tuple):  # ('null',)
            return ctx.scalar(0.0, torch.float64), ctx.scalar(False, torch.bool)
        return b.values.to(torch.float64), b.valid

    vals, valid = as_num(else_b)
    for (cond, _), b in zip(reversed(node.whens), reversed(branches)):
        ct, cv = _as_bool(_eval(cond, batch, ctx))
        hit = ct & cv
        bv, bok = as_num(b[1])
        vals = torch.where(hit, bv, vals)
        valid = torch.where(hit, bok, valid)
    return _Val(vals, valid)


def _eval_function(node: "FuncCall", batch, ctx: _EvalContext) -> _Val:
    if node.name == "ABS" and len(node.args) == 1:
        v = _eval(node.args[0], batch, ctx)
        return _Val(torch.abs(v.values), v.valid)
    if node.name == "COALESCE":
        if not node.args:
            raise PredicateParseError("COALESCE needs arguments")
        branches = [_eval_stringish(a, batch, ctx) for a in node.args]
        if _any_stringish(branches):
            union, pairs = _string_union(ctx, node, list(node.args), branches)
            vals, valid = pairs[0]
            for code, ok in pairs[1:]:
                vals = torch.where(valid, vals, code)
                valid = valid | ok
            return _Val(vals, valid, entries=tuple(union))
        parts = [
            b if isinstance(b, _Val)
            else _Val(ctx.scalar(0.0, torch.float64), ctx.scalar(False, torch.bool))
            for b in branches
        ]
        vals = parts[0].values
        valid = parts[0].valid
        for p in parts[1:]:
            vals = torch.where(valid, vals, p.values)
            valid = valid | p.valid
        return _Val(vals, valid, is_bool=all(p.is_bool for p in parts))
    if node.name == "LENGTH" and len(node.args) == 1:
        arg = node.args[0]
        if isinstance(arg, ColumnRef):
            mask = batch[f"{arg.name}::mask"]
            return _Val(batch[f"{arg.name}::lengths"], mask)
        # LENGTH over a transformed string expression: per-code i32
        # LUT of len(view(dict[i])), gathered by code
        v = _eval(arg, batch, ctx)
        if not _is_string_lane(v):
            raise PredicateParseError(
                "LENGTH expects a string column or string function"
            )

        def build() -> np.ndarray:
            view = _lane_entries(ctx, v, arg)
            table = np.zeros(len(view) + 1, dtype=np.int32)
            for i, s in enumerate(view):
                if s is not None:
                    table[i] = len(s)
            return table

        return _Val(_gather_null_slot(ctx.table(("len", arg), build), v.values), v.valid)
    if node.name in ("DATE_ADD", "DATE_SUB"):
        v = _eval(node.args[0], batch, ctx)
        if v.ts_per_day is None:
            raise PredicateParseError(
                f"{node.name} requires a timestamp/date column"
            )
        n_days = _static_int(node.args[1], f"{node.name} day count")
        if node.name == "DATE_SUB":
            n_days = -n_days
        # Spark's date_add casts to DATE first: the result is DAY-valued
        # (time-of-day truncates), so equality against date literals
        # behaves like Spark's
        days = torch.div(v.values.to(torch.int64), v.ts_per_day, rounding_mode="floor")
        return _Val(days + n_days, v.valid, ts_per_day=1)
    if node.name == "DATEDIFF":
        def days_of(arg):
            if isinstance(arg, StringLit):
                return (
                    ctx.scalar(_epoch_days_of_literal(arg.value), torch.int64),
                    ctx.scalar(True, torch.bool),
                )
            v = _eval(arg, batch, ctx)
            if v.ts_per_day is None:
                raise PredicateParseError(
                    "DATEDIFF arguments must be timestamp columns "
                    "or date literals"
                )
            return (
                torch.div(v.values.to(torch.int64), v.ts_per_day, rounding_mode="floor"),
                v.valid,
            )

        end_days, end_valid = days_of(node.args[0])
        start_days, start_valid = days_of(node.args[1])
        return _Val(end_days - start_days, end_valid & start_valid)
    if node.name == "CONCAT":
        return _eval_concat(node, batch, ctx)
    if node.name in _STRING_FNS:
        return _eval_string_fn(node, batch, ctx)
    raise PredicateParseError(f"unsupported function {node.name}")


def _eval_concat(node: "FuncCall", batch, ctx: _EvalContext) -> _Val:
    lanes: List[Tuple[str, object, Node]] = []
    for a in node.args:
        if isinstance(a, StringLit):
            lanes.append(("lit", a.value, a))
        else:
            v = _eval(a, batch, ctx)
            if not _is_string_lane(v):
                raise PredicateParseError("CONCAT arguments must be strings")
            lanes.append(("lane", v, a))
    n_lanes = sum(1 for k, _, _ in lanes if k == "lane")
    if n_lanes == 0:
        raise PredicateParseError("CONCAT of only literals is constant")
    if n_lanes == 1 and all(
        k == "lit" or v.codes_of is not None for k, v, _ in lanes
    ):
        # one COLUMN-BACKED lane: literals fold into its lazy transform
        # — no synthetic dictionary needed
        col_val = next(v for k, v, _ in lanes if k == "lane")
        inner = col_val.view
        parts = tuple(v if k == "lit" else None for k, v, _ in lanes)

        def transform(s, _parts=parts, _inner=inner):
            return "".join(_inner(s) if p is None else p for p in _parts)

        return _Val(
            col_val.values,
            col_val.valid,
            codes_of=col_val.codes_of,
            transform=transform,
        )

    # MULTI-column (or synthetic-lane) CONCAT: fold lanes into a
    # cross-product synthetic dictionary (size bounded at plan time by
    # _check_plan_budgets); row code = left_code * |right| + right_code;
    # NULL if ANY operand is null (Spark's concat)
    def build():
        acc_entries: Optional[List[Optional[str]]] = None
        pending = ""
        sizes = []
        for k, v, a in lanes:
            if k == "lit":
                if acc_entries is None:
                    pending += v
                else:
                    acc_entries = [None if e is None else e + v for e in acc_entries]
                continue
            view = _lane_entries(ctx, v, a)
            sizes.append(len(view))
            if acc_entries is None:
                acc_entries = [None if e is None else pending + e for e in view]
                pending = ""
            else:
                acc_entries = [
                    None if ea is None or eb is None else ea + eb
                    for ea in acc_entries
                    for eb in view
                ]
        return tuple(acc_entries), sizes

    entries, sizes = ctx.memo(("concat", node), build)
    acc_codes = acc_valid = None
    for (k, v, _), L in zip([lane for lane in lanes if lane[0] == "lane"], sizes):
        codes = torch.where(v.values < 0, 0, v.values).clamp(0, L - 1).to(torch.int32)
        if acc_codes is None:
            acc_codes, acc_valid = codes, v.valid
        else:
            acc_codes = acc_codes * L + codes
            acc_valid = acc_valid & v.valid
    return _Val(acc_codes, acc_valid, entries=entries)


def _eval_binop(node: "BinOp", batch, ctx: _EvalContext) -> _Val:
    if node.op in ("AND", "OR"):
        lt, lv = _as_bool(_eval(node.left, batch, ctx))
        rt, rv = _as_bool(_eval(node.right, batch, ctx))
        if node.op == "AND":
            truth = lt & rt
            # SQL 3VL: FALSE AND NULL = FALSE (valid)
            valid = (lv & rv) | (lv & ~lt) | (rv & ~rt)
        else:
            truth = lt | rt
            # TRUE OR NULL = TRUE (valid)
            valid = (lv & rv) | (lv & lt) | (rv & rt)
        return _Val(truth, valid, is_bool=True)
    # comparisons involving string literals: =/!= compare raw codes
    # (one dictionary lookup, scalar compare); orderings need
    # lexicographic ranks — codes are in order of appearance
    if node.op in _CMP and (
        isinstance(node.left, StringLit) or isinstance(node.right, StringLit)
    ):
        lit_on_right = isinstance(node.right, StringLit)
        col_node, lit = (
            (node.left, node.right) if lit_on_right else (node.right, node.left)
        )
        base = _eval(col_node, batch, ctx)
        if base.ts_per_day is not None:
            # timestamp/date lane vs date literal: the literal converts
            # to the lane's epoch unit on the host (as Arrow's cast does
            # for raw columns; as UTC days for day-valued DATE_ADD
            # results); the device compare stays numeric
            if base.ts_col is not None:
                epoch = ctx.memo(
                    ("epoch", base.ts_col, lit.value),
                    lambda: _date_literal_epoch(ctx, base.ts_col, lit.value),
                )
            else:
                epoch = _epoch_days_of_literal(lit.value)
            lv, rv = (base.values, epoch) if lit_on_right else (epoch, base.values)
            return _Val(_cmp(node.op, lv, rv), base.valid, is_bool=True)
        if not _is_string_lane(base):
            raise PredicateParseError(
                "string comparison requires a string column"
            )
        if node.op in ("=", "!="):
            if base.transform is not None or base.entries is not None:
                truth = _string_eq_lut(ctx, base, col_node, lit.value)
            else:
                code = _dict_lookup(ctx, base.codes_of, lit.value)
                truth = base.values == code
            if node.op == "!=":
                truth = ~truth
            return _Val(truth, base.valid, is_bool=True)
        ranks, lit_rank = _rank_lut_with_literal(ctx, base, col_node, lit.value)
        col_ranks = _gather_null_slot(ranks, base.values)
        lv, rv = (col_ranks, lit_rank) if lit_on_right else (lit_rank, col_ranks)
        return _Val(_cmp(node.op, lv, rv), base.valid, is_bool=True)
    lhs = _eval(node.left, batch, ctx)
    rhs = _eval(node.right, batch, ctx)
    valid = lhs.valid & rhs.valid
    lv, rv = lhs.values, rhs.values
    if (
        node.op in _CMP
        and lhs.ts_per_day is not None
        and rhs.ts_per_day is not None
        and lhs.ts_per_day != rhs.ts_per_day
    ):
        # mixed-unit timestamp lanes (timestamp[us] vs date32, or a
        # day-valued DATE_ADD vs a raw column): scale the coarser side
        # up to the finer unit so epochs compare as instants
        if lhs.ts_per_day < rhs.ts_per_day:
            lv = lv.to(torch.int64) * (rhs.ts_per_day // lhs.ts_per_day)
        else:
            rv = rv.to(torch.int64) * (lhs.ts_per_day // rhs.ts_per_day)
    if node.op in _CMP:
        if _is_string_lane(lhs) and _is_string_lane(rhs):
            # two string columns: dictionary codes come from UNRELATED
            # dictionaries (and even one dictionary is in order of
            # appearance, not sorted) — remap both sides to ranks in a
            # shared sorted value domain so =/!= and lexicographic
            # ordering are exact
            lut_l, lut_r = _shared_rank_luts(ctx, node, lhs, rhs)
            lv = _gather_null_slot(lut_l, lv)
            rv = _gather_null_slot(lut_r, rv)
        elif _is_string_lane(lhs) != _is_string_lane(rhs):
            raise PredicateParseError(
                "cannot compare a string column with a non-string "
                "operand (dictionary codes are not values)"
            )
        return _Val(_CMP_FNS[node.op](lv, rv), valid, is_bool=True)
    if _is_string_lane(lhs) or _is_string_lane(rhs):
        raise PredicateParseError(
            f"arithmetic {node.op!r} is undefined for string columns"
        )
    if node.op == "+":
        return _Val(lv + rv, valid)
    if node.op == "-":
        return _Val(lv - rv, valid)
    if node.op == "*":
        return _Val(lv * rv, valid)
    denom_ok = rv != 0
    safe = torch.where(denom_ok, rv, 1)
    if node.op == "/":
        return _Val(_true_divide(lv, safe), valid & denom_ok)
    if node.op == "%":
        return _Val(torch.remainder(lv, safe), valid & denom_ok)
    raise PredicateParseError(f"cannot evaluate node {node!r}")
