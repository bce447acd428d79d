"""Hygiene of the PyTorch port: what it imports, where it runs, and how
its kernel wrapper refuses input.

- ``deequ_tpu_torch``, ``chip_smoke.py`` and ``smoke_phase4_parts.py``
  import neither JAX nor anything of the JAX package (an AST scan of
  every module). ``pyarrow``
  is imported at module level only by the modules that read and write
  parquet (``data/parquet.py``, ``repository/table.py``, ``egress/``),
  and elsewhere only inside the named Arrow-boundary functions of
  ``data/table.py`` and the row-level results; ``pandas`` only inside
  the named ``*_dataframe`` methods. ``import deequ_tpu_torch`` (run in a fresh interpreter)
  imports neither.
- A rank spawned by ``deequ_tpu_torch.testing.mesh.run_ranks`` holds
  neither ``jax`` nor any module of the JAX package in ``sys.modules``
  after a mesh run, and the module of the mesh tests' rank bodies
  (``tests/test_torch_mesh_ranks.py``) imports neither.
- With no CUDA device, the default engine raises instead of running on
  the CPU; only an explicit ``device="cpu"`` runs on the host.
- ``scatter_max`` checks dtype, shape, contiguity, device and the
  idx/rho ranges before any launch, and no code path catches a kernel
  error to fall back to the plain version.
- K1's fused entry ``hll_update`` checks dtypes, shapes, contiguity and
  devices before any launch, and the CPU takes its plain version
  without launching.
- The resilience modules (``engine/resilience.py``, ``engine/memory.py``,
  ``engine/deadline.py``, ``testing/faults.py``) are in the scan above,
  and no ``except`` of ``engine/scan.py``'s dispatch path swallows an
  exception that ``classify_memory_pressure`` does not classify: each
  handler re-raises, at its end or where the classification is None,
  but the one clean exit of a cancel or a deadline (an AST rule, and an
  update's ValueError propagating out of the scan in both modes).
- Crash isolation (``engine/subproc.py``) and the module of its tests'
  children import neither JAX nor the JAX package and ask no question
  of the GPU (the child's device is the parent's configured one); a
  child that ``IsolatedRunner`` spawns holds neither in ``sys.modules``;
  ``deequ_tpu_torch.engine.__all__`` is the JAX package's.
"""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import deequ_tpu_torch as T
from deequ_tpu_torch import config as tconfig
from deequ_tpu_torch.sketches import scatter_max as sm

REPO = Path(__file__).resolve().parents[1]
PACKAGE = REPO / "deequ_tpu_torch"
PORT_FILES = sorted(PACKAGE.rglob("*.py")) + [REPO / "chip_smoke.py",
                                                REPO / "smoke_phase4_parts.py"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "deequ_tpu")


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_neither_jax_nor_reference(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def _pyarrow_imports(path: Path, top: str = "pyarrow"):
    """(function name or None, module) of every import of ``top``
    (pyarrow by default)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    out = []

    def visit(node, func):
        for child in ast.iter_child_nodes(node):
            name = child.name if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)) else func
            mods = []
            if isinstance(child, ast.Import):
                mods = [a.name for a in child.names]
            elif isinstance(child, ast.ImportFrom) and child.module:
                mods = [child.module]
            out.extend((name, m) for m in mods if m.split(".")[0] == top)
            visit(child, name)

    visit(tree, None)
    return out


# the modules that read or write parquet, which may import pyarrow at
# module level; all but the egress plan, which reaches it through its
# writer, do
ARROW_MODULES = {Path("data/parquet.py"), Path("repository/table.py"),
                 Path("egress/writer.py"), Path("egress/plan.py")}
ARROW_AT_MODULE_LEVEL = ARROW_MODULES - {Path("egress/plan.py")}
# the Arrow-boundary functions of data/table.py that import it inside
TABLE_ARROW_FUNCTIONS = {"_arrow_column", "_arrow_dictionary", "_column_to_arrow",
                         "_keep_validity", "from_pandas", "_arrow_table"}
# the row-level results, which may import it inside, each in its module
ROW_LEVEL_ARROW_FUNCTIONS = {Path("verification/rowlevel.py"): {"row_level_results"},
                             Path("verification/suite.py"): {"row_level_results_as_dataset"}}
# every function that may import it inside
ARROW_FUNCTIONS = TABLE_ARROW_FUNCTIONS | {"row_level_results", "row_level_results_as_dataset"}
# the methods that import pandas inside
PANDAS_FUNCTIONS = {"success_metrics_as_dataframe", "check_results_as_dataframe",
                    "get_success_metrics_as_dataframe"}


@pytest.mark.parametrize("path", sorted(PACKAGE.rglob("*.py")), ids=lambda p: str(p.relative_to(REPO)))
def test_pyarrow_only_in_from_arrow(path):
    rel = path.relative_to(PACKAGE)
    found = _pyarrow_imports(path)
    if rel in ARROW_MODULES:
        assert all(f is None for f, _ in found), found
        assert any(f is None for f, _ in found) == (rel in ARROW_AT_MODULE_LEVEL), found
    elif rel == Path("data/table.py"):
        assert found and {f for f, _ in found} == TABLE_ARROW_FUNCTIONS
    elif rel in ROW_LEVEL_ARROW_FUNCTIONS:
        assert {f for f, _ in found} <= ROW_LEVEL_ARROW_FUNCTIONS[rel], f"{rel} imports {found}"
    else:
        assert not found, f"{rel} imports {found}"
    assert {f for f, _ in found} - {None} <= ARROW_FUNCTIONS
    pandas = [(f, m) for f, m in _pyarrow_imports(path, "pandas")]
    assert {f for f, _ in pandas} <= PANDAS_FUNCTIONS, f"{rel} imports {pandas}"


def test_importing_the_package_imports_neither_pyarrow_nor_pandas():
    code = ("import sys, deequ_tpu_torch, deequ_tpu_torch.repository; "
            "print(sorted(m for m in ('pyarrow', 'pandas') if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO, check=True, timeout=120)
    assert out.stdout.strip() == "[]", out.stdout + out.stderr


def test_scan_finds_forbidden_imports():
    assert _forbidden("jax.numpy") and _forbidden("deequ_tpu.sketches.hll")
    assert not _forbidden("deequ_tpu_torch.sketches.hll")


def test_default_engine_refuses_to_run_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.AnalysisEngine()
    data = T.Dataset.from_pydict({"x": np.arange(10)})
    check = T.Check(T.CheckLevel.ERROR, "c").has_size(lambda n: n == 10)
    with pytest.raises(RuntimeError, match="CUDA"):
        T.VerificationSuite().on_data(data).add_check(check).run()
    with pytest.raises(RuntimeError, match="CUDA"):
        T.AnalysisEngine(device="cuda")
    # an explicit request for the host runs there
    assert T.AnalysisEngine(device="cpu").device.type == "cpu"
    with tconfig.configure(device="cpu"):
        result = T.VerificationSuite().on_data(data).add_check(check).run()
    assert result.status == T.CheckStatus.SUCCESS


def _ok_args(cols=2, rows=64):
    idx = torch.arange(cols * rows, dtype=torch.int32).reshape(cols, rows) % 100
    rho = torch.ones((cols, rows), dtype=torch.int32)
    return idx, rho


BAD_ARGS = {
    "idx int64": (lambda i, r: (i.long(), r, 128), TypeError),
    "rho float": (lambda i, r: (i, r.float(), 128), TypeError),
    "1-D idx": (lambda i, r: (i.reshape(-1), r.reshape(-1), 128), ValueError),
    "non-contiguous": (lambda i, r: (i.t(), r.t(), 128), ValueError),
    "shape mismatch": (lambda i, r: (i, r[:, :10].contiguous(), 128), ValueError),
    "idx negative": (lambda i, r: (i - 1, r, 128), ValueError),
    "idx >= m": (lambda i, r: (i, r, 50), ValueError),
    "rho negative": (lambda i, r: (i, r - 2, 128), ValueError),
    "rho >= 64": (lambda i, r: (i, r + 63, 128), ValueError),
    "m too large": (lambda i, r: (i, r, sm.MAX_REGISTERS + 1), ValueError),
    "meta device": (lambda i, r: (i.to("meta"), r.to("meta"), 128), ValueError),
}


@pytest.mark.parametrize("case", sorted(BAD_ARGS))
def test_scatter_max_refuses_bad_arguments_before_any_launch(case, monkeypatch):
    calls = []
    monkeypatch.setattr(sm, "_launch", lambda *a: calls.append("kernel"))
    monkeypatch.setattr(sm, "scatter_max_plain", lambda *a: calls.append("plain"))
    make, exc = BAD_ARGS[case]
    launches = sm.launches
    with pytest.raises(exc):
        sm.scatter_max(*make(*_ok_args()))
    assert calls == [] and sm.launches == launches


def test_scatter_max_on_cpu_is_the_plain_version():
    idx, rho = _ok_args()
    launches = sm.launches
    out = sm.scatter_max(idx, rho, 128)
    assert out.dtype == torch.int32 and out.shape == (2, 128)
    assert torch.equal(out, sm.scatter_max_plain(idx, rho, 128))
    assert sm.launches == launches  # the CPU never launches the kernel


def _ok_update_args(cols=2, rows=64):
    values = torch.arange(cols * rows, dtype=torch.int64).reshape(cols, rows)
    mask = torch.ones((cols, rows), dtype=torch.bool)
    row_mask = torch.ones(rows, dtype=torch.bool)
    registers = torch.zeros((cols, sm.hll_hash.M), dtype=torch.int8)
    return values, mask, row_mask, registers


BAD_UPDATE_ARGS = {
    "values float16": (lambda v, m, r, g: (v.half(), m, r, g), TypeError),
    "values complex": (lambda v, m, r, g: (v.to(torch.complex64), m, r, g), TypeError),
    "mask int8": (lambda v, m, r, g: (v, m.to(torch.int8), r, g), TypeError),
    "row_mask int32": (lambda v, m, r, g: (v, m, r.int(), g), TypeError),
    "registers int32": (lambda v, m, r, g: (v, m, r, g.int()), TypeError),
    "registers too few columns": (lambda v, m, r, g: (v, m, r, g[:, :100].contiguous()), ValueError),
    "registers too many rows": (lambda v, m, r, g: (v, m, r, torch.cat([g, g])), ValueError),
    "1-D values": (lambda v, m, r, g: (v[0], m[0], r, g), ValueError),
    "no columns": (lambda v, m, r, g: (v[:0], m[:0], r, g[:0]), ValueError),
    "mask shape mismatch": (lambda v, m, r, g: (v, m[:, :10].contiguous(), r, g), ValueError),
    "row_mask wrong length": (lambda v, m, r, g: (v, m, r[:10].contiguous(), g), ValueError),
    "row_mask 2-D": (lambda v, m, r, g: (v, m, r[None, :], g), ValueError),
    "non-contiguous values": (lambda v, m, r, g: (v.t().contiguous().t(), m, r, g), ValueError),
    "non-contiguous mask": (lambda v, m, r, g: (v, m.t().contiguous().t(), r, g), ValueError),
    "non-contiguous registers": (
        lambda v, m, r, g: (v, m, r, g.t().contiguous().t()), ValueError),
    "meta device": (
        lambda v, m, r, g: (v.to("meta"), m.to("meta"), r.to("meta"), g.to("meta")), ValueError),
    "devices differ": (lambda v, m, r, g: (v, m, r, g.to("meta")), ValueError),
}


@pytest.mark.parametrize("case", sorted(BAD_UPDATE_ARGS))
def test_hll_update_refuses_bad_arguments_before_any_launch(case, monkeypatch):
    calls = []
    monkeypatch.setattr(sm, "_launch_update", lambda *a: calls.append("kernel"))
    monkeypatch.setattr(sm, "hll_update_plain", lambda *a: calls.append("plain"))
    make, exc = BAD_UPDATE_ARGS[case]
    launches = sm.fused_launches
    with pytest.raises(exc):
        sm.hll_update(*make(*_ok_update_args()))
    assert calls == [] and sm.fused_launches == launches


@pytest.mark.parametrize("row_mask", [True, False], ids=["row_mask", "no_row_mask"])
def test_hll_update_on_cpu_is_the_plain_version(row_mask):
    values, mask, rows, registers = _ok_update_args()
    rows = rows if row_mask else None
    launches, fused = sm.launches, sm.fused_launches
    out = sm.hll_update(values, mask, rows, registers)
    assert out.dtype == torch.int8 and out.shape == registers.shape
    assert torch.equal(out, sm.hll_update_plain(values, mask, rows, registers))
    assert out.any()
    # the CPU never launches either K1 entry
    assert (sm.launches, sm.fused_launches) == (launches, fused)


def test_no_fallback_around_the_kernel():
    """No module of the port catches an exception around the kernel
    path: the wrappers and the HLL register functions hold no try statement, and
    only the wrapper's CPU branch reaches the plain version."""
    for rel in (
        "sketches/scatter_max.py",
        "sketches/hll.py",
        "sketches/hll_hash.py",
        "tools/probe_kernels.py",
    ):
        tree = ast.parse((PACKAGE / rel).read_text())
        assert not any(isinstance(n, ast.Try) for n in ast.walk(tree)), rel
    users = [
        p.relative_to(PACKAGE)
        for p in PACKAGE.rglob("*.py")
        if "scatter_max_plain" in p.read_text()
    ]
    assert users == [Path("sketches/scatter_max.py")]
    functions = {
        n.name: ast.unparse(n)
        for n in ast.walk(ast.parse((PACKAGE / "sketches/scatter_max.py").read_text()))
        if isinstance(n, ast.FunctionDef)
    }
    for entry in ("scatter_max", "scatter_max_derived"):
        assert (
            "if idx.device.type == 'cuda':\n        return _launch(idx, rho, m)\n"
            "    return scatter_max_plain(idx, rho, m)"
        ) in functions[entry], entry
    assert (
        "if values.device.type == 'cuda':\n"
        "        return _launch_update(values, mask, row_mask, registers)\n"
        "    return hll_update_plain(values, mask, row_mask, registers)"
    ) in functions["hll_update"]
    # only the checked entry reads idx/rho back to the host
    assert "_check_ranges" in functions["_check_args"]
    assert "_check_ranges" not in functions["scatter_max_derived"]


RESILIENCE_MODULES = ["engine/resilience.py", "engine/memory.py", "engine/deadline.py",
                      "testing/faults.py"]
# the functions of engine/scan.py between a batch's arrival and its states
DISPATCH_PATH = {"update", "_run_scan", "_stream_dispatch", "_host_slices", "_dispatch",
                 "_subdispatch"}


def test_resilience_modules_are_scanned():
    scanned = {str(p.relative_to(PACKAGE)) for p in PORT_FILES if PACKAGE in p.parents}
    assert set(RESILIENCE_MODULES) <= scanned


def _is_bare_raise(node) -> bool:
    return isinstance(node, ast.Raise) and node.exc is None


def _reraises_unclassified(handler: ast.ExceptHandler) -> bool:
    """The handler ends in a bare raise, or calls the classifier and
    re-raises (bare) under ``if <classified> is None``."""
    if handler.body and _is_bare_raise(handler.body[-1]):
        return True
    calls = {n.func.id for n in ast.walk(handler)
             if isinstance(n, ast.Call) and isinstance(n.func, ast.Name)}
    if "classify_memory_pressure" not in calls:
        return False
    for node in ast.walk(handler):
        if (isinstance(node, ast.If) and isinstance(node.test, ast.Compare)
                and isinstance(node.test.ops[0], ast.Is)
                and isinstance(node.test.comparators[0], ast.Constant)
                and node.test.comparators[0].value is None
                and len(node.body) == 1 and _is_bare_raise(node.body[0])):
            return True
    return False


def test_dispatch_path_swallows_no_unclassified_exception():
    tree = ast.parse((PACKAGE / "engine/scan.py").read_text())
    functions = {n.name: n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)
                 and n.name in DISPATCH_PATH}
    assert set(functions) == DISPATCH_PATH
    handlers = 0
    for name, fn in functions.items():
        for handler in (n for n in ast.walk(fn) if isinstance(n, ast.ExceptHandler)):
            handlers += 1
            caught = ast.unparse(handler.type) if handler.type is not None else "everything"
            if caught == "ScanInterrupted":
                continue  # the clean exit of a cancel or a deadline
            assert _reraises_unclassified(handler), (
                f"engine/scan.py::{name} line {handler.lineno}: except {caught} can swallow "
                "an exception that classify_memory_pressure does not classify")
    assert handlers >= 5


@pytest.mark.parametrize("budget", [1 << 30, 0], ids=["resident", "streaming"])
def test_an_update_error_propagates_out_of_the_scan(monkeypatch, budget):
    from deequ_tpu_torch.analyzers.base import ScanOps
    from deequ_tpu_torch.engine.vectorize import plan_scan_units

    def broken(self, state, batch, consts):
        raise ValueError("an update that is not memory pressure")

    monkeypatch.setattr(ScanOps, "apply_update", broken)
    ds = T.Dataset.from_pydict({"v": np.arange(500.0)})
    with tconfig.configure(device="cpu", device_cache_bytes=budget, batch_size=100):
        units, _ = plan_scan_units(ds, [T.Size(), T.Mean("v")])
        engine = T.AnalysisEngine()
        with pytest.raises(ValueError, match="not memory pressure"):
            engine.run_scan(ds, [(u, u.ops) for u in units])
    assert engine.last_degradation is None


def test_mesh_rank_bodies_import_neither_jax_nor_reference():
    """The module a spawned rank imports (besides the port) is scanned
    like the port's own."""
    path = REPO / "tests" / "test_torch_mesh_ranks.py"
    bad = sorted(m for m in _imported_modules(path) if _forbidden(m))
    assert bad == [], bad


def test_a_spawned_rank_imports_neither_jax_nor_reference():
    """Two ranks run a mesh scan; each reports the jax and ``deequ_tpu``
    modules in its ``sys.modules``: none."""
    sys.path.insert(0, str(REPO / "tests"))
    try:
        import test_torch_mesh_ranks as ranks
    finally:
        sys.path.remove(str(REPO / "tests"))
    from deequ_tpu_torch.testing.mesh import run_ranks

    assert run_ranks(ranks.rank_imports, 2, timeout=120.0) == [[], []]


TELEMETRY_FILES = sorted((PACKAGE / "telemetry").glob("*.py"))
# calls that would make a telemetry module ask whether there is a GPU
GPU_PROBES = {"is_available", "device_count", "get_device_name", "get_device_properties"}


@pytest.mark.parametrize("path", TELEMETRY_FILES, ids=lambda p: p.name)
def test_telemetry_imports_neither_jax_nor_reference_and_probes_no_gpu(path):
    """The telemetry layer imports no JAX and nothing of the JAX package,
    and no call of it asks for a GPU: an annotation never picks a path
    (NVTX ranges and the profiler's CUDA activity follow the configured
    device and the build, not the card)."""
    assert not [m for m in _imported_modules(path) if _forbidden(m)]
    tree = ast.parse(path.read_text(), filename=str(path))
    probes = [node.attr for node in ast.walk(tree)
              if isinstance(node, ast.Attribute) and node.attr in GPU_PROBES]
    assert not probes, f"{path.name} calls {probes}"


def test_telemetry_exports_the_reference_names():
    import deequ_tpu_torch.telemetry as port_telemetry

    reference = REPO / "deequ_tpu" / "telemetry" / "__init__.py"
    tree = ast.parse(reference.read_text())
    (names,) = [ast.literal_eval(node.value) for node in tree.body
                if isinstance(node, ast.Assign) and node.targets[0].id == "__all__"]
    assert sorted(port_telemetry.__all__) == sorted(names)
    assert all(hasattr(port_telemetry, n) for n in names)
    assert "profiler_trace" in T.__all__ and T.profiler_trace is not None


SUBPROC_FILES = [PACKAGE / "engine" / "subproc.py",
                 REPO / "tests" / "test_torch_subproc_children.py"]


@pytest.mark.parametrize("path", SUBPROC_FILES, ids=lambda p: p.name)
def test_subproc_imports_neither_jax_nor_reference_and_probes_no_gpu(path):
    """Crash isolation and the children of its tests import no JAX and
    nothing of the JAX package, and ask no question of the GPU: a child
    runs on the device its parent was configured for, and raises where
    that device is missing."""
    assert not [m for m in _imported_modules(path) if _forbidden(m)]
    tree = ast.parse(path.read_text(), filename=str(path))
    probes = [node.attr for node in ast.walk(tree)
              if isinstance(node, ast.Attribute) and node.attr in GPU_PROBES
              and not (isinstance(node.ctx, ast.Store))]
    assert not probes, f"{path.name} calls {probes}"


def test_an_isolated_child_imports_neither_jax_nor_reference():
    sys.path.insert(0, str(REPO / "tests"))
    try:
        import test_torch_subproc_children as children
    finally:
        sys.path.remove(str(REPO / "tests"))
    from deequ_tpu_torch.engine.subproc import IsolatedRunner

    with tconfig.configure(device="cpu"):
        got = IsolatedRunner(key="imports", use_breaker=False).run(children.child_imports, {})
    assert got == []


def test_engine_exports_the_reference_names():
    import deequ_tpu_torch.engine as port_engine

    reference = REPO / "deequ_tpu" / "engine" / "__init__.py"
    tree = ast.parse(reference.read_text())
    (names,) = [ast.literal_eval(node.value) for node in tree.body
                if isinstance(node, ast.Assign) and node.targets[0].id == "__all__"]
    assert sorted(port_engine.__all__) == sorted(names)
    assert all(hasattr(port_engine, n) for n in names)
