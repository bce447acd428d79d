"""The launch plan and launch path of the probe's P3 (``scatter_gmin``),
on the CPU.

P3 is one cluster launch: each cluster's blocks min-reduce slices of the
warm registers into the cluster's gate, and every row that passes the
gate and ``rho > regs_in[idx]`` raises ``out`` (a copy of ``regs_in``)
with an atomic. Here:

- the gate slices of a cluster's blocks cover [0, m) exactly once, the
  plan fills the card with GMIN_BLOCKS_PER_SM blocks an SM in whole
  clusters, never more clusters than fit at once, and the planner's
  copies of the kernel's constants equal the kernel's;
- a numpy emulation of the kernel (the gate from the slices, the two
  tests, the atomics into a copy of ``regs_in``) equals ``gmin_plain``
  and, at m = 2^14, the JAX probe's ``xla_scatter``, into zeroed, warm
  and one-zero registers;
- the launch path, run against a stand-in for the kernels' library, is
  one library call into a new register file (the launch copies
  ``regs_in`` into it) with no other PyTorch launch and no host sync;
  no rows launch nothing; a failed launch raises uncounted.
"""

import contextlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tools import scatter_probe as ref_probe

from deequ_tpu_torch.tools import probe_kernels as pk

M = 1 << 14


def _covered(n, ranges):
    counts = np.zeros(n, np.int64)
    for lo, hi in ranges:
        assert 0 <= lo <= hi <= n
        counts[lo:hi] += 1
    return counts


def test_planner_constants_equal_the_kernels():
    source = pk.SOURCE.read_text()

    def constant(name):
        found = re.search(rf"constexpr int {name} = ([0-9]+);", source)
        assert found, name
        return int(found.group(1))

    assert constant("kGminCluster") == pk.GMIN_CLUSTER
    assert constant("kGminBlocksPerSm") == pk.GMIN_BLOCKS_PER_SM


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("rows", [1, 3, 1000, (1 << 21) + 12345])
@pytest.mark.parametrize("m", [1, 7, 100, 16383, 16384])
def test_plan_gmin_covers_the_registers_once_and_fills_the_card(m, rows, sms):
    p = pk.plan_gmin(rows, m, sms)
    assert p.blocks == pk.GMIN_CLUSTER * p.clusters
    assert 1 <= p.clusters <= max(1, pk.GMIN_BLOCKS_PER_SM * sms // pk.GMIN_CLUSTER)
    assert p.clusters == 1 or rows / p.clusters >= pk.MIN_ROWS_PER_CLUSTER
    slices = [p.gate_slice(rank) for rank in range(pk.GMIN_CLUSTER)]
    assert (_covered(m, slices) == 1).all()
    assert pk.plan_gmin(rows, m, sms, fit=3).clusters == min(p.clusters, 3)


def test_plan_gmin_at_the_probe_shape():
    p = pk.plan_gmin(1 << 21, M, 132)
    assert (p.clusters, p.blocks) == (33, 264)  # two blocks on every SM
    assert pk.plan_gmin(5, M, 132).clusters == 1


@pytest.mark.parametrize("m", [0, -1, M + 1], ids=["m=0", "m negative", "m too large"])
def test_plan_gmin_refuses_what_the_kernel_does_not_take(m):
    with pytest.raises(ValueError):
        pk.plan_gmin(10, m, 132)


def _stream(kind, rows, m, seed=0):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, m, rows, dtype=np.int32)
    rho = np.minimum(rng.geometric(0.5, rows), 33).astype(np.int32)
    if kind == "collision":
        idx[:] = min(7, m - 1)
    elif kind == "masked":
        idx[:], rho[:] = 0, 0
    return idx, rho


def _registers(kind, m, rng):
    if kind == "zero":
        return np.zeros(m, np.int32)
    warm = rng.integers(1, 12, m).astype(np.int32)
    if kind == "one-zero":
        warm[min(1234, m - 1)] = 0
    return warm


def _emulate(p, regs_in, idx, rho):
    """P3 in numpy: each cluster's gate from its blocks' slices, then
    every row that passes both tests raises a copy of ``regs_in``."""
    slices = [regs_in[lo:hi] for lo, hi in map(p.gate_slice, range(pk.GMIN_CLUSTER)) if hi > lo]
    gate = min(part.min() for part in slices)  # a cluster's gate, from its blocks' slices
    assert gate == regs_in.min()
    out = regs_in.copy()
    keep = (rho > gate) & (rho > regs_in[idx])
    np.maximum.at(out, idx[keep], rho[keep])
    return out


@pytest.mark.parametrize("m", [16384, 16383, 100, 1])
@pytest.mark.parametrize("kind", ["random", "collision", "masked"])
@pytest.mark.parametrize("regs_kind", ["zero", "warm", "one-zero"])
def test_emulated_kernel_equals_the_plain_versions(kind, m, regs_kind):
    rng = np.random.default_rng(11)
    for rows, sms in (((1 << 18) + 12345, 132), (1000, 114), (5, 132)):
        idx, rho = _stream(kind, rows, m)
        regs = _registers(regs_kind, m, rng)
        got = _emulate(pk.plan_gmin(rows, m, sms), regs, idx, rho)
        plain = pk.gmin_plain(torch.from_numpy(regs), pk.pack(torch.from_numpy(idx),
                                                              torch.from_numpy(rho)))
        assert np.array_equal(got, plain.numpy())
        if m == M:
            want = ref_probe.xla_scatter(jnp.asarray(regs), jnp.asarray(idx), jnp.asarray(rho))
            assert np.array_equal(got, np.asarray(want))


class _Library:
    def __init__(self, err=0, fit=17):
        self.err = err
        self.fit = fit
        self.calls = []

    def __getattr__(self, name):
        if name == "probe_cuda_error_string":
            return lambda err: b"stand-in error"
        if name == "probe_gmin_max_active_clusters":
            return lambda: self.fit

        def launch(*args):
            self.calls.append((name, args))
            return self.err

        return launch


def _refuse(name):
    def refused(*args, **kwargs):
        raise AssertionError(f"the launch path called {name}")

    return refused


@pytest.fixture
def stand_in(monkeypatch):
    lib = _Library()
    monkeypatch.setattr(pk, "_library", lambda: lib)
    monkeypatch.setattr(pk, "_on", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(pk, "_stream", lambda t: 0)
    monkeypatch.setattr(pk.config, "sm_count", lambda device: 132)
    pk.plan_gmin_on.cache_clear()
    for name in ("zeros", "zeros_like", "maximum"):
        monkeypatch.setattr(torch, name, _refuse(f"torch.{name}"))
    monkeypatch.setattr(torch.Tensor, "clone", _refuse("Tensor.clone"))
    monkeypatch.setattr(torch.cuda, "synchronize", _refuse("torch.cuda.synchronize"))
    monkeypatch.setattr(torch.Tensor, "item", _refuse("Tensor.item"))
    monkeypatch.setattr(torch.Tensor, "tolist", _refuse("Tensor.tolist"))
    monkeypatch.setitem(pk.launches, "P3", 0)
    yield lib
    pk.plan_gmin_on.cache_clear()


def test_launch_path_is_one_library_call_into_a_new_register_file(stand_in):
    rows, m = 1_000_000, 100
    idx, rho = (torch.from_numpy(a) for a in _stream("random", rows, m))
    packed = pk.pack(idx, rho)
    regs = torch.arange(m, dtype=torch.int32)
    out = pk._launch_gmin(regs, packed, True)
    [(name, args)] = stand_in.calls
    assert name == "probe_gmin_launch"
    p = pk.plan_gmin(rows, m, 132, stand_in.fit)
    assert args[:3] == (regs.data_ptr(), packed.data_ptr(), out.data_ptr())
    # a new tensor, which the launch fills with a copy of regs_in
    assert out.data_ptr() != regs.data_ptr()
    assert (out.shape, out.dtype) == (regs.shape, regs.dtype)
    assert args[3:] == (rows, m, int(packed.data_ptr() % 16 == 0), p.clusters, 0)
    assert p.clusters == stand_in.fit  # capped at the clusters that fit at once
    assert pk.launches["P3"] == 1


def test_launch_path_of_no_rows_launches_nothing(stand_in):
    regs = torch.arange(10, dtype=torch.int32)
    with pytest.raises(AssertionError, match="Tensor.clone"):  # no rows: a copy of regs_in
        pk._launch_gmin(regs, torch.arange(0, dtype=torch.int32), True)
    assert stand_in.calls == [] and pk.launches["P3"] == 0


def test_a_failed_launch_raises_and_is_not_counted(stand_in):
    stand_in.err = 1
    regs = torch.from_numpy(np.zeros(100, np.int32))
    idx, rho = (torch.from_numpy(a) for a in _stream("random", 1000, 100))
    with pytest.raises(RuntimeError, match="P3 gmin kernel launch failed"):
        pk._launch_gmin(regs, pk.pack(idx, rho), True)
    assert len(stand_in.calls) == 1 and pk.launches["P3"] == 0
