"""Differential tests of K1's fused entry, ``scatter_max.hll_update``,
against the JAX package.

On the CPU the fused entry is its plain version (hash, rank,
scatter-max, then the max with the carried registers). The same numpy
inputs (fixed seeds) go through ``jnp.maximum(prev,
registers_from_hash_pair_stacked(*hash_pair_numeric(x), mask))`` of
``deequ_tpu.sketches.hll``: on its default XLA scatter, and on its
Pallas kernel run in interpret mode (``DEEQU_TPU_PALLAS_INTERPRET=1``),
as tests/test_torch_hll.py runs it. The contract is BIT identity.

Through the engines: a filtered and an unfiltered numeric HLL group and
a single ApproxCountDistinct, at a batch size that carries the
registers over many batches, against the JAX engine's states.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deequ_tpu as R
from deequ_tpu import config as rconfig
from deequ_tpu.io.state_provider import InMemoryStateProvider
from deequ_tpu.sketches import hll as rhll
from deequ_tpu.sketches import pallas_scatter

import deequ_tpu_torch as T
from deequ_tpu_torch import config as tconfig
from deequ_tpu_torch.sketches import hll as thll
from deequ_tpu_torch.sketches import scatter_max as sm

DTYPES = [np.int8, np.int16, np.int32, np.int64, np.float32, np.float64, np.bool_]
ROWS = [3, 1001, (1 << 12) + 7]
COLS = 3

# float edges beyond tests/test_torch_hll.py's: float32-subnormal hi and
# residual words (subnormal inputs, too, in a float32 column), either
# side of where x86 calls a float32 result tiny, float64 subnormals,
# values past float32's range, values whose hi rounds to -0.0, NaN, the
# infinities and -0.0. The JAX package on the CPU reads subnormal
# inputs as zero and flushes subnormal words to zero; the port follows.
FLOAT_EDGES = [
    0.0, -0.0, np.inf, -np.inf, np.nan, 1.0, -1.0,
    1e-40, -1e-40, 1.0000001e-37, 2.0**-126 * (1 - 2.0**-24), -(2.0**-126) * (1 - 2.0**-25),
    1e300, -1e300, 1e-50, -1e-50, 1e-310, -5e-324,
    3.4028235e38, 3.4028236e38, 2.0**53 + 1,
]


@pytest.fixture
def pallas_interpret(monkeypatch):
    monkeypatch.setenv("DEEQU_TPU_PALLAS_INTERPRET", "1")
    pallas_scatter._reset_probe_for_tests()
    yield
    monkeypatch.delenv("DEEQU_TPU_PALLAS_INTERPRET", raising=False)
    pallas_scatter._reset_probe_for_tests()


def _values(dtype, rows, seed):
    """(COLS, rows) values of ``dtype``, led by its edge values."""
    rng = np.random.default_rng(seed)
    shape = (COLS, rows)
    if dtype == np.bool_:
        return rng.random(shape) < 0.5
    if np.issubdtype(dtype, np.integer):
        info = np.iinfo(dtype)
        x = rng.integers(info.min, info.max, shape, dtype=dtype, endpoint=True)
        edges = np.array([info.min, info.min + 1, -1, 0, 1, info.max - 1, info.max], dtype)
    else:
        x = (rng.standard_normal(shape) * 10.0 ** rng.integers(-8, 9, shape)).astype(dtype)
        with np.errstate(over="ignore"):
            edges = np.array(FLOAT_EDGES, dtype=np.float64).astype(dtype)
    n = min(rows, len(edges))
    x[:, :n] = edges[:n]
    return x


def _registers(kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "zero":
        return np.zeros((COLS, rhll.M), np.int8)
    regs = rng.integers(0, 20, (COLS, rhll.M)).astype(np.int8)
    if kind == "one_zero":
        regs[:] = 9
        regs[:, 1234] = 0
    return regs


def _reference(values, mask, row_mask, prev):
    valid = mask if row_mask is None else mask & row_mask[None, :]
    h1, h2 = rhll.hash_pair_numeric(jnp.asarray(values))
    regs = rhll.registers_from_hash_pair_stacked(h1, h2, jnp.asarray(valid))
    return np.asarray(jnp.maximum(jnp.asarray(prev), regs))


def _port(values, mask, row_mask, prev):
    out = sm.hll_update(
        torch.from_numpy(values),
        torch.from_numpy(mask),
        None if row_mask is None else torch.from_numpy(row_mask),
        torch.from_numpy(prev),
    )
    assert out.dtype == torch.int8 and out.shape == prev.shape
    return out.numpy()


def _compare_all(dtype, rows, seed):
    values = _values(dtype, rows, seed)
    rng = np.random.default_rng(seed + 1)
    mask = rng.random((COLS, rows)) < 0.9
    row_mask = rng.random(rows) < 0.6
    for regs_kind in ("zero", "random", "one_zero"):
        prev = _registers(regs_kind, seed + 2)
        for rm in (None, row_mask):
            want = _reference(values, mask, rm, prev)
            got = _port(values, mask, rm, prev)
            np.testing.assert_array_equal(
                got, want, err_msg=f"registers {regs_kind}, row mask {rm is not None}"
            )


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_hll_update_matches_xla_scatter(dtype, rows):
    with rconfig.configure(pallas_scatter=False):
        _compare_all(dtype, rows, seed=rows)


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_hll_update_matches_pallas_kernel(dtype, pallas_interpret):
    with rconfig.configure(pallas_scatter=True):
        assert pallas_scatter.impl_token() == "pallas"
        _compare_all(dtype, 1001, seed=5)


def test_hll_update_all_masked_keeps_the_carry():
    values = _values(np.int64, 1001, 3)
    prev = _registers("random", 4)
    got = _port(values, np.zeros(values.shape, bool), None, prev)
    np.testing.assert_array_equal(got, prev)


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=lambda d: np.dtype(d).name)
def test_float_hash_flushes_subnormals_as_the_reference_does(dtype):
    """Magnitudes across the whole float64 range, 1e-330 to 1e4, both
    signs: every hash pair equals the JAX package's, subnormal inputs
    and subnormal float32 words included."""
    rng = np.random.default_rng(17)
    n = 50_000
    x = rng.choice([-1.0, 1.0], n) * 10.0 ** rng.uniform(-330, 4, n) * rng.uniform(1, 10, n)
    tiny = 2.0**-126
    x[:6] = [tiny * (1 - 2.0**-24), tiny * (1 - 2.0**-25), -tiny, 1e-40, -1e-40, -5e-324]
    with np.errstate(over="ignore", under="ignore"):
        x = x.astype(dtype)
    r1, r2 = (np.asarray(h) for h in rhll.hash_pair_numeric(jnp.asarray(x)))
    t1, t2 = thll.hash_pair_numeric(torch.from_numpy(x))
    np.testing.assert_array_equal(t1.numpy(), r1.astype(np.int64))
    np.testing.assert_array_equal(t2.numpy(), r2.astype(np.int64))


# -- through the engines ------------------------------------------------------


class _Keep:
    def __init__(self):
        self.states = {}

    def persist(self, analyzer, state):
        self.states[repr(analyzer)] = state


def _engine_data(n, seed):
    rng = np.random.default_rng(seed)
    f = rng.standard_normal(n) * 1e3
    f[rng.random(n) < 0.02] = np.nan
    f[:6] = [np.inf, -np.inf, -0.0, 1e-40, -1e-40, -5e-324]
    g = np.round(rng.standard_normal(n), 1)
    return {
        "a": rng.integers(-(2**62), 2**62, n),
        "b": rng.integers(0, 3000, n),
        "f": np.ma.array(f, mask=rng.random(n) < 0.05),
        "g": np.ma.array(g, mask=rng.random(n) < 0.05),
        "q": rng.integers(0, 100, n).astype(np.int32),
    }


def _engine_analyzers(pkg):
    where = "q > 40"
    return [
        pkg.ApproxCountDistinct("a"),  # an unfiltered int64 group
        pkg.ApproxCountDistinct("b"),
        pkg.ApproxCountDistinct("f", where=where),  # a filtered float64 group
        pkg.ApproxCountDistinct("g", where=where),
        pkg.ApproxCountDistinct("q"),  # a single int32 analyzer
    ]


def test_engine_registers_carry_over_many_batches():
    data = _engine_data(6000, 31)
    rkeep = InMemoryStateProvider()
    with rconfig.configure(batch_size=500):
        R.AnalysisRunner.do_analysis_run(
            R.Dataset.from_pydict(data), _engine_analyzers(R), save_states_with=rkeep
        )
    tkeep = _Keep()
    with tconfig.configure(device="cpu", batch_size=500):
        T.AnalysisRunner.do_analysis_run(
            T.Dataset.from_pydict(data), _engine_analyzers(T), save_states_with=tkeep
        )
    for ra, ta in zip(_engine_analyzers(R), _engine_analyzers(T)):
        want = np.asarray(rkeep.load(ra).registers)
        got = tkeep.states[repr(ta)].registers.numpy()
        np.testing.assert_array_equal(got, want, err_msg=repr(ta))
        assert got.any(), repr(ta)
