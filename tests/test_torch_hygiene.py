"""Hygiene of the PyTorch port: what it imports, where it runs, and how
its kernel wrapper refuses input.

- ``deequ_tpu_torch`` and ``chip_smoke.py`` import neither JAX nor
  anything of the JAX package (an AST scan of every module), and
  ``pyarrow`` is imported only by ``Dataset.from_arrow``: never on the
  grouping path.
- With no CUDA device, the default engine raises instead of running on
  the CPU; only an explicit ``device="cpu"`` runs on the host.
- ``scatter_max`` checks dtype, shape, contiguity, device and the
  idx/rho ranges before any launch, and no code path catches a kernel
  error to fall back to the plain version.
- K1's fused entry ``hll_update`` checks dtypes, shapes, contiguity and
  devices before any launch, and the CPU takes its plain version
  without launching.
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

import deequ_tpu_torch as T
from deequ_tpu_torch import config as tconfig
from deequ_tpu_torch.sketches import scatter_max as sm

REPO = Path(__file__).resolve().parents[1]
PACKAGE = REPO / "deequ_tpu_torch"
PORT_FILES = sorted(PACKAGE.rglob("*.py")) + [REPO / "chip_smoke.py"]


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


def _pyarrow_imports(path: Path):
    """(function name or None, module) of every pyarrow import."""
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
            out.extend((name, m) for m in mods if m.split(".")[0] == "pyarrow")
            visit(child, name)

    visit(tree, None)
    return out


@pytest.mark.parametrize("path", sorted(PACKAGE.rglob("*.py")), ids=lambda p: str(p.relative_to(REPO)))
def test_pyarrow_only_in_from_arrow(path):
    found = _pyarrow_imports(path)
    if path.name == "table.py" and path.parent.name == "data":
        assert found and {f for f, _ in found} == {"from_arrow"}
    else:
        assert not found, f"{path.relative_to(REPO)} imports {found}"


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
