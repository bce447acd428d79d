"""The device half of row-level egress: constraint outcomes in the scan.

Counterpart of ``deequ_tpu/egress/plan.py``. ``plan_row_sink`` sorts a
run's constraints into the families of ``verification/rowlevel.py``
(the oracle):

- **scan families** (mask and predicate, pattern, and asserted values
  whose assertion runs on a tensor): each row's pass is a few torch ops
  on the batch the metric ops read, so they ride the fused scan LAST as
  one more ``ScanOps``. Its per-batch output is the ``(planes, B/8)``
  uint8 matrix of the planes, bit-packed little-endian, and the batch's
  valid-row count: a host-folded output that the engine fetches with
  the scan's others (at a drain, a checkpoint and the end), never with
  a host sync a batch, and folds into the
  :class:`~deequ_tpu_torch.egress.writer.QuarantineWriter`;
- **deferred families** (Uniqueness and UniqueValueRatio, global by
  nature, and assertions that do not run on a tensor): evaluated at
  finalize by the oracle's ``_outcome_for`` and merged with the spooled
  planes. Such a run reads the data twice and counts
  ``engine.data_passes == 2``; the device holds one scan batch of rows,
  or one key partition of about that size, at a time. Memory pressure
  or a device fault there fails the run.

The sink's op holds this run's writer and compiled predicates: nothing
caches it (the engine keeps no plan cache). A sink on a mesh engine
raises at the run's start, on every rank: the mesh egress is a later
slice.

The bit order is little-endian in a byte, as the writer unpacks it
(``np.unpackbits(..., bitorder="little")``).
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deequ_tpu_torch.analyzers.base import ScanOps, pad_pow2
from deequ_tpu_torch.analyzers.basic import (
    Completeness,
    Compliance,
    Maximum,
    MaxLength,
    Minimum,
    MinLength,
    PatternMatch,
)
from deequ_tpu_torch.analyzers.grouping import Uniqueness, UniqueValueRatio
from deequ_tpu_torch.constraints.constraint import AnalysisBasedConstraint, ConstraintDecorator
from deequ_tpu_torch.data.table import ROW_MASK, ColumnRequest
from deequ_tpu_torch.egress.writer import EgressReport, QuarantineWriter, RowLevelSink
from deequ_tpu_torch.engine.pack import count_data_pass
from deequ_tpu_torch.sql.predicate import compile_predicate
from deequ_tpu_torch.telemetry import get_telemetry

#: a plane function: (device batch, consts) -> each row's pass booleans
PlaneFn = Callable[[Dict[str, torch.Tensor], Optional[Dict[str, Any]]], torch.Tensor]


class _ProbeTensor(torch.Tensor):
    """A tensor that refuses to become a numpy array, as a traced JAX
    value refuses: an assertion through numpy does not ride the scan."""

    def __array__(self, *args, **kwargs):
        raise TypeError("a row-level assertion on a tensor does not reach numpy")


def _assertion_traceable(assertion, dtype) -> bool:
    """Whether the constraint's assertion runs on a tensor and gives one
    boolean a row (the JAX package decides it by tracing the assertion;
    here it is called on a tensor of four values of the column's dtype).
    An assertion that branches on a value (``and``, ``if``, a chained
    comparison) or goes through numpy or Python scalars raises on a
    tensor and is evaluated at finalize, once a distinct value."""
    probe = torch.ones(4, dtype=torch.from_numpy(np.zeros(0, dtype)).dtype)
    try:
        out = assertion(probe.as_subclass(_ProbeTensor))
    except Exception:  # noqa: BLE001 — not tensor-shaped, not an error
        return False
    return isinstance(out, torch.Tensor) and tuple(out.shape) == (4,)


def _mask_key(column: str) -> str:
    return f"{column}::mask"


@dataclass
class _PlaneSpec:
    """One outcome column the scan evaluates."""

    name: str
    fn: PlaneFn
    requests: Tuple[ColumnRequest, ...]
    #: the index of its where-exclusion plane, or None (no filter)
    excl: Optional[int] = None


@dataclass
class _Deferred:
    name: str
    analyzer: Any
    assertion: Any
    where: Optional[str]


class _SinkScanAdapter:
    """The sink op's partner in the runner's ``scan_pairs``: the columns
    its planes read."""

    def __init__(self, requests: Sequence[ColumnRequest]):
        self._requests = tuple(requests)

    def device_requests(self, dataset) -> Tuple[ColumnRequest, ...]:
        return self._requests


@dataclass
class RowSinkPlan:
    """What a run threads through its fused pass for one sink: the op
    riding the scan, the writer it folds into, and the deferred work
    finalize still owes."""

    sink: RowLevelSink
    writer: QuarantineWriter
    ops: ScanOps
    adapter: _SinkScanAdapter
    scan_names: List[str]
    deferred: List[_Deferred]
    unsupported: Dict[str, str]
    batch_capacity: int  # rows one plane row holds (B/8 * 8)
    scan_failed: bool = False
    _scan_record: Any = None
    _interrupted: bool = False

    @property
    def scan_pair(self) -> Tuple[_SinkScanAdapter, ScanOps]:
        return (self.adapter, self.ops)

    def bind_scan_geometry(self, scan_plan, data, engine) -> None:
        """Between ``prepare_scan`` and ``execute_plan``: the unit the
        scan quarantines (a batch, resident or streamed), the live
        degradation record the writer reads, and the engine's egress
        hooks for THIS scan (the checkpoint flushes the open span before
        its cursor; a resume reconciles the writer first)."""
        if scan_plan.batch_size > self.batch_capacity:
            raise RuntimeError(
                f"egress planned for batch_size <= {self.batch_capacity} "
                f"but the scan resolved {scan_plan.batch_size}"
            )
        self.writer.bind_geometry(scan_plan.batch_size, scan_plan.batch_size,
                                  durable=engine.checkpointer is not None)
        # mid-scan the live record is active_degradation; folds drained
        # at the scan's end come after the engine merged it into
        # last_degradation (reset by the runner: this is the run's first scan)
        self.writer.set_degradation_probe(
            lambda: engine.active_degradation or engine.last_degradation
        )
        engine.active_egress = self.writer

    def note_scan_complete(self, engine) -> None:
        # later scans of the run (deferred re-reads) leave the sink alone
        engine.active_egress = None
        self._scan_record = engine.active_degradation or engine.last_degradation
        self._interrupted = engine.last_interruption is not None

    def mark_scan_failed(self) -> None:
        self.scan_failed = True


def _classify_constraints(checks, data):
    """Every check's constraints, once, sorted into the oracle's
    families, with plane functions for the scan families."""
    planes: List[_PlaneSpec] = []
    deferred: List[_Deferred] = []
    unsupported: Dict[str, str] = {}
    consts: Dict[str, torch.Tensor] = {}
    where_planes: List[PlaneFn] = []
    where_index: Dict[str, int] = {}
    where_requests: List[ColumnRequest] = []
    seen: set = set()

    def where_plane(where: Optional[str]) -> Optional[int]:
        if where is None:
            return None
        if where in where_index:
            return where_index[where]
        pred = compile_predicate(where, data)
        where_requests.extend(pred.requests)
        where_requests.extend(ColumnRequest(c, "mask") for c in pred.columns_used)

        def excl_fn(batch, _consts, _pred=pred):
            # True for the rows the filter EXCLUDES (oracle: _where_pass)
            return ~_pred.complies(batch)

        where_index[where] = len(where_planes)
        where_planes.append(excl_fn)
        return where_index[where]

    for check in checks:
        for constraint in getattr(check, "constraints", ()):
            inner = (constraint.inner if isinstance(constraint, ConstraintDecorator)
                     else constraint)
            if not isinstance(inner, AnalysisBasedConstraint):
                continue
            name = str(constraint)
            if name in seen:
                continue
            analyzer = inner.analyzer
            where = getattr(analyzer, "where", None)
            try:
                spec = _plane_for(analyzer, inner.assertion, where, data, consts, where_plane)
            except Exception as exc:  # noqa: BLE001 — this constraint only
                # (oracle: row_level_results); its aggregate result
                # already reports the exception
                seen.add(name)
                unsupported[name] = f"{type(exc).__name__}: {exc}"
                continue
            if spec is None:
                continue  # not a row-level family (Size, Mean, ...)
            seen.add(name)
            spec.name = name
            (deferred if isinstance(spec, _Deferred) else planes).append(spec)
    return planes, where_planes, deferred, unsupported, consts, where_requests


def _plane_for(analyzer, assertion, where, data, consts, where_plane):
    """One constraint as a _PlaneSpec (rides the scan), a _Deferred
    (finalize) or None (not row-level capable). Raises for a constraint
    with no outcome column (a bad predicate or pattern)."""
    if isinstance(analyzer, (Uniqueness, UniqueValueRatio)):
        return _Deferred("", analyzer, assertion, where)

    if isinstance(analyzer, Completeness):
        col = analyzer.column
        excl = where_plane(where)

        def fn(batch, _consts, _k=_mask_key(col)):
            return batch[_k]

        return _PlaneSpec("", fn, (ColumnRequest(col, "mask"),), excl)

    if isinstance(analyzer, Compliance):
        pred = compile_predicate(analyzer.predicate, data)
        excl = where_plane(where)
        reqs = tuple(pred.requests) + tuple(ColumnRequest(c, "mask") for c in pred.columns_used)

        def fn(batch, _consts, _pred=pred):
            return _pred.complies(batch)

        return _PlaneSpec("", fn, reqs, excl)

    if isinstance(analyzer, PatternMatch):
        col = analyzer.column
        dictionary = data.dictionary(col)
        prog = re.compile(analyzer.pattern)
        lut = np.zeros(max(len(dictionary), 1) + 1, dtype=bool)
        for i, value in enumerate(dictionary):
            if value is not None and prog.search(str(value)):
                lut[i] = True
        null_idx = len(lut) - 1
        key = f"__rl_lut_{len(consts)}"
        consts[key] = torch.from_numpy(pad_pow2(lut))
        excl = where_plane(where)

        def fn(batch, c, _key=key, _null=null_idx, _col=col):
            lut_d = c[_key]
            codes = batch[f"{_col}::codes"].to(torch.int64)
            idx = torch.where(codes < 0, _null, codes).clamp(0, lut_d.shape[0] - 1)
            return lut_d[idx] & batch[_mask_key(_col)]

        return _PlaneSpec("", fn, (ColumnRequest(col, "codes"), ColumnRequest(col, "mask")), excl)

    if isinstance(analyzer, (MinLength, MaxLength, Minimum, Maximum)):
        if assertion is None:
            return None
        repr_name = "lengths" if isinstance(analyzer, (MinLength, MaxLength)) else "values"
        col = analyzer.column
        data.check_row_level_repr(col, repr_name)
        dtype = data.request_dtype(ColumnRequest(col, repr_name))
        if not _assertion_traceable(assertion, dtype):
            return _Deferred("", analyzer, assertion, where)
        excl = where_plane(where)

        def fn(batch, _consts, _a=assertion, _col=col, _r=repr_name):
            passes = torch.as_tensor(_a(batch[f"{_col}::{_r}"])).to(torch.bool)
            # null rows pass; the mask overrides their placeholder lanes
            return ~batch[_mask_key(_col)] | passes

        return _PlaneSpec("", fn, (ColumnRequest(col, repr_name), ColumnRequest(col, "mask")),
                          excl)

    return None


def _build_ops(planes, where_planes, consts, b8: int, writer: QuarantineWriter) -> ScanOps:
    """The sink's ScanOps: a fixed ``(n_planes, B/8)`` uint8 output a
    batch (fixed, so a backed-off slice gives the same shape), bit-packed
    on the device, and the batch's valid rows; ``host_fold`` hands each
    fetched output to the writer."""
    plane_fns: List[PlaneFn] = [p.fn for p in planes] + list(where_planes)
    n_planes = len(plane_fns)

    def _pack(batch, c):
        device = batch[ROW_MASK].device
        if plane_fns:
            m = torch.stack([torch.as_tensor(f(batch, c)).to(torch.bool) for f in plane_fns])
            padded = torch.zeros((n_planes, b8 * 8), dtype=torch.uint8, device=device)
            padded[:, :m.shape[1]] = m
            lanes = padded.view(n_planes, b8, 8)
            bits = lanes[:, :, 0].clone()
            for k in range(1, 8):
                bits |= lanes[:, :, k] << k
        else:
            bits = torch.zeros((0, b8), dtype=torch.uint8, device=device)
        valid = batch[ROW_MASK].sum(dtype=torch.int32)
        return {"bits": bits, "valid": valid}

    def init():
        return {"bits": torch.zeros((n_planes, b8), dtype=torch.uint8),
                "valid": torch.zeros((), dtype=torch.int32)}

    if consts:
        def update(state, batch, c):
            return _pack(batch, c)
    else:
        def update(state, batch):
            return _pack(batch, None)

    def host_fold(acc, out):
        valid = int(out["valid"])
        writer.consume(np.asarray(out["bits"]), valid)
        return {"spans": acc["spans"] + 1, "rows": acc["rows"] + valid}

    return ScanOps(
        init=init,
        update=update,
        merge=lambda a, b: b,
        host_init=lambda: {"spans": 0, "rows": 0},
        host_fold=host_fold,
        consts=dict(consts) if consts else None,
    )


def plan_row_sink(sink: RowLevelSink, checks, data, engine) -> Optional[RowSinkPlan]:
    """The sink's rider of one run's scan, or None (and a
    ``no_row_level_constraints`` report) when no constraint of the suite
    is row-level capable. A mesh engine raises: the sink on a mesh is a
    later slice."""
    if engine.mesh_context is not None:
        raise ValueError(
            "a row-level sink does not run on a mesh engine yet: the mesh egress "
            "is not supported"
        )
    planes, where_planes, deferred, unsupported, consts, where_requests = (
        _classify_constraints(checks, data))
    if not planes and not deferred:
        sink.report = EgressReport(
            status="no_row_level_constraints",
            rows_total=int(data.num_rows),
            unsupported=unsupported,
        )
        return None
    batch_size = engine._resolve_batch_size(data.num_rows)
    b8 = (int(batch_size) + 7) // 8
    writer = QuarantineWriter(
        sink,
        data,
        scan_names=[p.name for p in planes],
        excl_of=[p.excl for p in planes],
        deferred_names=[d.name for d in deferred],
        plane_shape=(len(planes) + len(where_planes), b8),
        row_columns=list(sink.columns or data.schema.column_names),
    )
    ops = _build_ops(planes, where_planes, consts, b8, writer)
    requests: List[ColumnRequest] = []
    seen_req: set = set()
    for r in [r for spec in planes for r in spec.requests] + where_requests:
        if r.key not in seen_req:
            seen_req.add(r.key)
            requests.append(r)
    return RowSinkPlan(
        sink=sink,
        writer=writer,
        ops=ops,
        adapter=_SinkScanAdapter(requests),
        scan_names=[p.name for p in planes],
        deferred=list(deferred),
        unsupported=unsupported,
        batch_capacity=b8 * 8,
    )


def finalize_row_sink(plan: RowSinkPlan, data, engine) -> EgressReport:
    """After the fused pass: the deferred families through the oracle,
    the spool replayed, quarantined units after the last fold written,
    the writers closed, and ``sink.report`` set."""
    sink = plan.sink
    writer = plan.writer
    # a failed scan can get here without note_scan_complete: no later
    # scan may see the hook
    engine.active_egress = None
    if plan.scan_failed:
        writer.abort()
        report = EgressReport(
            status="aborted",
            rows_total=int(data.num_rows),
            rows_clean=writer.rows_clean,
            rows_quarantined=writer.rows_quarantined,
            bytes_raw=writer.bytes_raw,
            bytes_encoded=writer.bytes_encoded,
            unsupported=dict(plan.unsupported),
        )
        report.manifest_path = writer.write_manifest(report, {})
        get_telemetry().event("rowlevel_egress", status="aborted", tenant=sink.tenant,
                              run_id=sink.run_id)
        sink.report = report
        return report

    unsupported = dict(plan.unsupported)
    deferred_outcomes: Dict[str, Tuple[np.ndarray, Optional[np.ndarray]]] = {}
    record = plan._scan_record or engine.last_degradation
    try:
        if plan.deferred:
            from deequ_tpu_torch.verification.rowlevel import (
                _fails_the_run,
                _OracleCache,
                _outcome_for,
                _where_pass,
            )

            # the deferred families read the source again (uniqueness is
            # global): the run pays a second pass, a scan batch of rows
            # (or a key partition of that size) on the device at a time
            count_data_pass(engine)
            cache = _OracleCache(data, engine.device, plan.batch_capacity)
            for d in plan.deferred:
                try:
                    excluded = _where_pass(d.where, data, cache)
                    outcome = _outcome_for(d.analyzer, data, cache, assertion=d.assertion,
                                           excluded=excluded)
                except Exception as exc:  # noqa: BLE001 — the oracle degrades,
                    # but memory pressure and device faults fail the run
                    if _fails_the_run(exc):
                        raise
                    unsupported[d.name] = f"{type(exc).__name__}: {exc}"
                    continue
                if outcome is None:
                    unsupported[d.name] = "assertion raised per-value; no row-level column"
                    continue
                deferred_outcomes[d.name] = (outcome, excluded)
            del cache
            # a column the oracle dropped is not in the schema
            writer.deferred_names = [n for n in writer.deferred_names if n in deferred_outcomes]
        if writer.spool_mode:
            writer.replay_spool(deferred_outcomes, record)
        rows_clean, rows_quarantined = writer.finish(record, interrupted=plan._interrupted)
    except BaseException:
        # a failed finalize fails the run, and leaves no write thread
        writer.abort()
        raise
    constraints = {n: "scan" for n in plan.scan_names}
    constraints.update({n: "deferred" for n in writer.deferred_names})
    report = EgressReport(
        status="interrupted" if plan._interrupted else "complete",
        rows_total=int(data.num_rows),
        rows_clean=rows_clean,
        rows_quarantined=rows_quarantined,
        bytes_raw=writer.bytes_raw,
        bytes_encoded=writer.bytes_encoded,
        constraints=constraints,
        unsupported=unsupported,
        clean_dir=os.path.dirname(writer._paths.get("clean", "")),
        quarantine_dir=os.path.dirname(writer._paths.get("quarantine", "")),
    )
    failures = [
        {"batch_index": int(f.batch_index), "rows": int(f.rows),
         "error_class": str(f.error_class), "attempts": int(f.attempts)}
        for f in (getattr(record, "failures", ()) if record is not None else ())
    ]
    report.manifest_path = writer.write_manifest(report, {"scan_failures": failures})
    get_telemetry().event(
        "rowlevel_egress", status=report.status, rows_clean=rows_clean,
        rows_quarantined=rows_quarantined, bytes_raw=report.bytes_raw,
        bytes_encoded=report.bytes_encoded, constraints=len(constraints), tenant=sink.tenant,
        run_id=sink.run_id)
    sink.report = report
    return report
