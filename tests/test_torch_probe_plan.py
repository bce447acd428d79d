"""The launch plan of the probe's cluster kernels P1 and P2, on the CPU.

``probe_kernels.plan`` decides how the kernels cover their input; the
kernels compute the same partition from the plan's fields. Here:

- the owner spans of a cluster's blocks cover [0, m) exactly once, and
  every row falls in exactly one block's share, each share starting
  16-byte aligned for the kernels' int4 loads; the shared memory a
  block asks for fits an H100's 227 KB and keeps one block an SM, and
  the planner's copies of the kernel's constants equal the kernel's;
- a numpy emulation of the planned partition (each cluster's file built
  slice by slice from its blocks' rows, then folded into ``regs``)
  equals ``max(regs, two_stream_plain)`` and, at m = 2^14, the JAX
  probe's ``xla_scatter``, on random, all-collision and all-masked
  streams;
- the SM count is queried once per device, and the launch path of P1
  and P2, run against a stand-in for the kernels' library, makes one
  library call into a copy of ``regs`` and no other PyTorch launch.
"""

import contextlib
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tools import scatter_probe as ref_probe

from deequ_tpu_torch import config
from deequ_tpu_torch.tools import probe_kernels as pk

PACKAGE = Path(pk.__file__).resolve().parents[1]
H100_SMEM = 232_448  # bytes a block may use on an H100 (227 KB)
H100_SM_SMEM = 233_472  # bytes of shared memory an H100 SM holds (228 KB)
RESERVED_SMEM = 1024  # bytes the card reserves for each block
M = 1 << 14


def _covered(n, ranges):
    counts = np.zeros(n, np.int64)
    for lo, hi in ranges:
        assert 0 <= lo <= hi <= n
        counts[lo:hi] += 1
    return counts


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("rows", [1, 3, 1000, (1 << 21) + 12345])
@pytest.mark.parametrize("m", [1, 100, 16383, 16384])
def test_plan_covers_registers_and_rows_once(m, rows, sms):
    p = pk.plan(rows, m, sms)
    assert p.blocks == pk.CLUSTER * p.clusters <= max(sms, pk.CLUSTER)
    assert p.share % 4 == 0 and p.share >= 4
    assert 4 << p.span_log2 <= pk.BLOCK_SMEM  # the block's slice of the file
    # every register has exactly one owner, the block k >> span_log2
    spans = [p.owned(rank) for rank in range(pk.CLUSTER)]
    assert (_covered(m, spans) == 1).all()
    assert (m - 1) >> p.span_log2 < pk.CLUSTER
    for rank, (lo, hi) in enumerate(spans):
        assert all(k >> p.span_log2 == rank for k in (lo, hi - 1) if hi > lo)
    # every row in exactly one block's share, and every share starts on a
    # multiple of 4 rows, where an int4 load of an aligned stream is aligned
    shares = [p.rows_of(b) for b in range(p.blocks)]
    assert (_covered(rows, shares) == 1).all()
    assert all(begin % 4 == 0 for begin, end in shares if end > begin)


def test_block_shared_memory_fits_and_keeps_one_block_an_sm():
    assert pk.BLOCK_SMEM <= H100_SMEM
    assert 2 * (pk.BLOCK_SMEM + RESERVED_SMEM) > H100_SM_SMEM


def test_planner_constants_equal_the_kernels():
    source = pk.SOURCE.read_text()

    def constant(name):
        found = re.search(rf"constexpr int {name} = ([0-9 *]+);", source)
        assert found, name
        return eval(found.group(1), {})  # a product of integer literals

    assert constant("kCluster") == pk.CLUSTER
    assert constant("kBlockSmem") == pk.BLOCK_SMEM
    assert constant("kMaxRegisters") == pk.MAX_REGISTERS


def test_plan_fills_the_card_once_at_the_probe_shape():
    p = pk.plan(1 << 21, M, 132)
    assert (p.clusters, p.blocks, p.share, 1 << p.span_log2) == (8, 128, 16384, 1024)
    small = pk.plan(5, M, 132)
    assert small.clusters == 1 and small.rows_of(1) == (4, 5) and small.rows_of(7) == (5, 5)


@pytest.mark.parametrize("m", [0, -1, M + 1], ids=["m=0", "m negative", "m too large"])
def test_plan_refuses_what_the_kernel_does_not_take(m):
    with pytest.raises(ValueError):
        pk.plan(10, m, 132)


def _stream(kind, rows, m, seed=0):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, m, rows, dtype=np.int32)
    rho = np.minimum(rng.geometric(0.5, rows), 33).astype(np.int32)
    if kind == "collision":
        idx[:] = min(7, m - 1)
    elif kind == "masked":
        idx[:], rho[:] = 0, 0
    return idx, rho


def _emulate(p, regs, idx, rho):
    """The kernels' partition in numpy: each cluster's file, built slice
    by slice (block ``rank`` keeps the rows of its blocks' shares whose
    register it owns), then folded into a copy of ``regs``, raising
    only the registers above it."""
    m = regs.shape[0]
    files = []
    for c in range(p.clusters):
        rows = np.concatenate(
            [np.arange(*p.rows_of(c * pk.CLUSTER + q)) for q in range(pk.CLUSTER)]
        ).astype(np.int64)
        slices = []
        for rank in range(pk.CLUSTER):
            lo, hi = p.owned(rank)
            mine = rows[(idx[rows] >> p.span_log2) == rank]
            part = np.zeros(hi - lo, np.int32)
            np.maximum.at(part, idx[mine] - lo, rho[mine])
            slices.append(part)
        files.append(np.concatenate(slices))
        assert files[-1].shape == (m,)
    out = regs.copy()
    for f in files:
        raise_ = f > regs
        out[raise_] = np.maximum(out[raise_], f[raise_])
    return out


@pytest.mark.parametrize("m", [16384, 16383, 100, 1])
@pytest.mark.parametrize("kind", ["random", "collision", "masked"])
def test_emulated_partition_equals_the_plain_versions(kind, m):
    rng = np.random.default_rng(7)
    for rows, sms in (((1 << 18) + 12345, 132), (1000, 114), (5, 132)):
        idx, rho = _stream(kind, rows, m)
        regs = rng.integers(0, 12, m).astype(np.int32)
        p = pk.plan(rows, m, sms)
        got = _emulate(p, regs, idx, rho)
        plain = pk.two_stream_plain(torch.from_numpy(idx), torch.from_numpy(rho), m)
        assert np.array_equal(got, np.maximum(regs, plain.numpy()))
        if m == M:
            want = ref_probe.xla_scatter(jnp.asarray(regs), jnp.asarray(idx), jnp.asarray(rho))
            assert np.array_equal(got, np.asarray(want))


def test_sm_count_is_read_once_per_device(monkeypatch):
    calls = []

    class Props:
        multi_processor_count = 132

    def props(index):
        calls.append(index)
        return Props()

    monkeypatch.setattr(torch.cuda, "get_device_properties", props)
    config._sm_count.cache_clear()
    try:
        for _ in range(3):
            assert config.sm_count(torch.device("cuda", 0)) == 132
            assert config.sm_count(torch.device("cuda", 1)) == 132
    finally:
        config._sm_count.cache_clear()
    assert calls == [0, 1]


def test_only_config_reads_the_device_properties():
    users = sorted(
        str(p.relative_to(PACKAGE))
        for p in PACKAGE.rglob("*.py")
        if "get_device_properties" in p.read_text()
    )
    assert users == ["config.py"]


class _Library:
    """A stand-in for the kernels' library: records each launch and
    returns ``err``."""

    def __init__(self, err=0):
        self.err = err
        self.calls = []

    def _record(self, name):
        def launch(*args):
            self.calls.append((name, args))
            return self.err

        return launch

    def __getattr__(self, name):
        if name == "probe_cuda_error_string":
            return lambda err: b"stand-in error"
        return self._record(name)


def _refuse(name):
    def refused(*args, **kwargs):
        raise AssertionError(f"the launch path called {name}")

    return refused


@pytest.fixture
def stand_in(monkeypatch):
    """The launch path of P1 and P2 on CPU tensors, against a stand-in
    library: no device switch, stream 0, the plan of a 132-SM card, and
    every PyTorch call that would add a launch or a host sync refused."""
    lib = _Library()
    monkeypatch.setattr(pk, "_library", lambda: lib)
    monkeypatch.setattr(pk, "_on", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(pk, "_stream", lambda t: 0)
    monkeypatch.setattr(pk, "plan_on", lambda index, two, skip, rows, m: pk.plan(rows, m, 132))
    for name in ("zeros", "zeros_like", "maximum", "empty_like"):
        monkeypatch.setattr(torch, name, _refuse(f"torch.{name}"))
    monkeypatch.setattr(torch.cuda, "synchronize", _refuse("torch.cuda.synchronize"))
    monkeypatch.setattr(torch.Tensor, "item", _refuse("Tensor.item"))
    monkeypatch.setattr(torch.Tensor, "tolist", _refuse("Tensor.tolist"))
    monkeypatch.setitem(pk.launches, "P1", 0)
    monkeypatch.setitem(pk.launches, "P2", 0)
    return lib


@pytest.mark.parametrize("kernel", ["P1", "P2"])
def test_launch_path_is_one_library_call_into_a_copy_of_regs(stand_in, kernel):
    rows, m = 1000, 100
    idx, rho = (torch.from_numpy(a) for a in _stream("random", rows, m))
    regs = torch.arange(m, dtype=torch.int32)
    if kernel == "P1":
        out = pk._launch_two_stream(regs, idx, rho, True)
        streams = (idx, rho)
    else:
        packed = pk.pack(idx, rho)
        out = pk._launch_packed(regs, packed, False, True)
        streams = (packed,)
    [(name, args)] = stand_in.calls
    assert name == ("probe_two_stream_launch" if kernel == "P1" else "probe_packed_launch")
    p = pk.plan(rows, m, 132)
    n = len(streams)
    assert args[:n] == tuple(t.data_ptr() for t in streams)
    assert args[n] == regs.data_ptr() and args[n + 1] == out.data_ptr() != regs.data_ptr()
    skip = int(kernel == "P1")
    vec = int(all(t.data_ptr() % 16 == 0 for t in streams))
    assert args[n + 2:] == (rows, m, skip, vec, p.clusters, p.share, p.span_log2, 0)
    assert torch.equal(out, regs)  # the kernel folds into this copy of regs
    assert (pk.launches["P1"], pk.launches["P2"]) == (int(kernel == "P1"), int(kernel == "P2"))


def test_launch_path_reads_unaligned_words_one_at_a_time(stand_in):
    regs = torch.from_numpy(np.zeros(M, np.int32))
    words = torch.arange(1008, dtype=torch.int32)
    aligned = words[(-words.data_ptr() % 16) // 4:][:1000]
    unaligned = words[(-words.data_ptr() % 16) // 4 + 1:][:1000]
    pk._launch_packed(regs, aligned, True, True)
    pk._launch_packed(regs, unaligned, True, True)
    pk._launch_packed(regs, aligned, True, False)
    assert [args[6] for _, args in stand_in.calls] == [1, 0, 0]  # vec


def test_launch_path_of_no_rows_launches_nothing(stand_in):
    regs = torch.arange(10, dtype=torch.int32)
    out = pk._launch_packed(regs, torch.arange(0, dtype=torch.int32), True, True)
    assert stand_in.calls == [] and torch.equal(out, regs) and pk.launches["P2"] == 0


def test_a_failed_launch_raises_and_is_not_counted(stand_in):
    stand_in.err = 1
    regs = torch.from_numpy(np.zeros(100, np.int32))
    idx, rho = (torch.from_numpy(a) for a in _stream("random", 1000, 100))
    with pytest.raises(RuntimeError, match="P1 two_stream kernel launch failed"):
        pk._launch_two_stream(regs, idx, rho, True)
    assert len(stand_in.calls) == 1 and pk.launches["P1"] == 0
