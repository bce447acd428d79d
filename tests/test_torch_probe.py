"""The port's scatter probe against the JAX package's probe tool.

- The plain versions of P1, P2 and P3 (``tools/probe_kernels.py``)
  equal the reference probe's ``xla_scatter`` (``tools/scatter_probe.py``)
  bit for bit, on the same numpy-seeded inputs: random, all-collision,
  all-masked and ragged B, and for P3 warm ``regs_in`` that are zero,
  warm, or warm with one zero register (which holds gmin at 0).
- On CPU tensors the wrappers are the plain versions and launch
  nothing; bad arguments raise before any launch.
- The probe's CLI runs to its end with ``--device cpu`` in both modes.
"""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tools import scatter_probe as ref_probe

from deequ_tpu_torch.tools import probe_kernels as pk
from deequ_tpu_torch.tools import scatter_probe as port_probe

REPO = Path(__file__).resolve().parents[1]
M = 1 << 14


def _inputs(kind, rows, seed=0):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, M, rows, dtype=np.int32)
    rho = np.minimum(rng.geometric(0.5, rows), 33).astype(np.int32)
    if kind == "collision":
        idx[:] = 7
    elif kind == "masked":
        idx[:], rho[:] = 0, 0
    return idx, rho


def _regs(kind, seed=1):
    rng = np.random.default_rng(seed)
    if kind == "zero":
        return np.zeros(M, np.int32)
    regs = rng.integers(1, 12, M).astype(np.int32)
    if kind == "one-zero":
        regs[1234] = 0
    return regs


CASES = [
    ("random", 1 << 12), ("collision", 1 << 12), ("masked", 1 << 12),
    ("random", 1000), ("random", 4097), ("random", 3), ("random", 0),
]


def _reference(regs, idx, rho):
    return np.asarray(ref_probe.xla_scatter(jnp.asarray(regs), jnp.asarray(idx), jnp.asarray(rho)))


@pytest.mark.parametrize("kind, rows", CASES)
def test_plain_p1_p2_equal_xla_scatter(kind, rows):
    idx, rho = _inputs(kind, rows)
    want = _reference(np.zeros(M, np.int32), idx, rho)
    ti, tr = torch.from_numpy(idx), torch.from_numpy(rho)
    assert np.array_equal(pk.two_stream_plain(ti, tr, M).numpy(), want)
    assert np.array_equal(pk.packed_plain(pk.pack(ti, tr), M).numpy(), want)


@pytest.mark.parametrize("regs_kind", ["zero", "warm", "one-zero"])
@pytest.mark.parametrize("kind, rows", CASES)
def test_plain_p3_equals_xla_scatter_on_warm_registers(kind, rows, regs_kind):
    idx, rho = _inputs(kind, rows)
    regs = _regs(regs_kind)
    want = _reference(regs, idx, rho)
    got = pk.gmin_plain(torch.from_numpy(regs), pk.pack(torch.from_numpy(idx), torch.from_numpy(rho)))
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("regs_kind", ["zero", "warm"])
def test_wrappers_on_cpu_are_the_plain_versions(regs_kind):
    idx, rho = (torch.from_numpy(a) for a in _inputs("random", 5000))
    regs = torch.from_numpy(_regs(regs_kind))
    want = torch.from_numpy(_reference(regs.numpy(), idx.numpy(), rho.numpy()).copy())
    before = dict(pk.launches)
    packed = pk.pack(idx, rho)
    outs = [
        pk.scatter_two_stream(regs, idx, rho, skip_cold=False),
        pk.scatter_two_stream(regs, idx, rho, skip_cold=True),
        pk.scatter_packed(regs, packed),
        pk.scatter_packed(regs, packed, skip_cold=False, vec=False),
        pk.scatter_gmin(regs, packed),
    ]
    for out in outs:
        assert out.dtype == torch.int32 and torch.equal(out, want)
    assert pk.launches == before  # the CPU never launches a kernel


def _ok():
    idx, rho = (torch.from_numpy(a) for a in _inputs("random", 64))
    return torch.zeros(M, dtype=torch.int32), idx, rho


BAD = {
    "idx int64": lambda r, i, v: (r, i.long(), v),
    "rho float": lambda r, i, v: (r, i, v.float()),
    "2-D idx": lambda r, i, v: (r, i.reshape(8, 8), v.reshape(8, 8)),
    "non-contiguous": lambda r, i, v: (r, i[::2], v[::2]),
    "shape mismatch": lambda r, i, v: (r, i, v[:10].contiguous()),
    "idx negative": lambda r, i, v: (r, i - M, v),
    "idx >= m": lambda r, i, v: (r[:100].contiguous(), i, v),
    "rho >= 64": lambda r, i, v: (r, i, v + 64),
    "regs too long": lambda r, i, v: (torch.zeros(M + 1, dtype=torch.int32), i, v),
    "meta device": lambda r, i, v: (r, i.to("meta"), v.to("meta")),
}


BAD_PACKED = {
    "words int64": lambda r, w: (r, w.long()),
    "words float": lambda r, w: (r, w.float()),
    "2-D words": lambda r, w: (r, w.reshape(8, 8)),
    "non-contiguous": lambda r, w: (r, w[::2]),
    "negative word": lambda r, w: (r, w - (M << 6)),
    "idx >= m": lambda r, w: (r[:100].contiguous(), w),
    "regs int64": lambda r, w: (r.long(), w),
    "meta device": lambda r, w: (r, w.to("meta")),
}


@pytest.fixture
def no_launch(monkeypatch):
    calls = []
    for name in ("_launch_two_stream", "_launch_packed", "_launch_gmin",
                 "two_stream_plain", "packed_plain", "gmin_plain"):
        monkeypatch.setattr(pk, name, lambda *a, name=name: calls.append(name))
    yield calls
    assert calls == []


@pytest.mark.parametrize("case", sorted(BAD))
def test_two_stream_refuses_bad_arguments_before_any_launch(case, no_launch):
    with pytest.raises((TypeError, ValueError)):
        pk.scatter_two_stream(*BAD[case](*_ok()))


@pytest.mark.parametrize("wrapper", ["scatter_packed", "scatter_gmin"])
@pytest.mark.parametrize("case", sorted(BAD_PACKED))
def test_packed_wrappers_refuse_bad_arguments_before_any_launch(case, wrapper, no_launch):
    regs, idx, rho = _ok()
    with pytest.raises((TypeError, ValueError)):
        getattr(pk, wrapper)(*BAD_PACKED[case](regs, pk.pack(idx, rho)))


def test_probe_cli_runs_to_its_end_on_cpu():
    proc = subprocess.run(
        [sys.executable, "-m", "deequ_tpu_torch.tools.scatter_probe",
         "--device", "cpu", "--b", "12", "--reps", "2", "--iters", "1"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert "plain versions" in proc.stdout
    for name in ("two_stream", "two_stream_skip", "packed", "packed_nosk", "gmin"):
        line = next(ln for ln in proc.stdout.splitlines() if ln.strip().startswith(name + ":"))
        assert line.endswith("[OK]"), line


def test_probe_prod_mode_record_on_cpu(capsys):
    record = port_probe.run(["--device", "cpu", "--prod", "--cols", "3", "--b", "10",
                             "--reps", "2", "--iters", "1"])
    keys = {"mode", "C", "b_log2", "M", "reps", "backend", "roundtrip_ms", "variants",
            "pallas_speedup"}
    assert keys <= set(record)
    assert all(v["bit_identical"] for v in record["variants"].values())
    assert "PROD_JSON: " in capsys.readouterr().out


def test_probe_refuses_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        port_probe.run(["--b", "4"])
