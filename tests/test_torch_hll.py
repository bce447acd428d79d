"""HLL differential tests: deequ_tpu_torch against the JAX package.

The same numpy inputs (fixed seeds) go through ``deequ_tpu.sketches.hll``
and ``deequ_tpu_torch.sketches.hll`` (on the CPU, where the port's
scatter-max is its plain PyTorch version). The contract is BIT identity:
a value hashed to another register or rank on either side would be
counted twice when states from the two packages max-merge.

Register builds are compared against the JAX package twice: on its
default XLA scatter, and on its Pallas kernel run in interpret mode
(``DEEQU_TPU_PALLAS_INTERPRET=1``), as tests/test_fastpath_differential.py
runs it.
"""

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
from deequ_tpu_torch.sketches import scatter_max as tsm


@pytest.fixture
def pallas_interpret(monkeypatch):
    monkeypatch.setenv("DEEQU_TPU_PALLAS_INTERPRET", "1")
    pallas_scatter._reset_probe_for_tests()
    yield
    monkeypatch.delenv("DEEQU_TPU_PALLAS_INTERPRET", raising=False)
    pallas_scatter._reset_probe_for_tests()


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _u32(a: np.ndarray) -> torch.Tensor:
    """numpy uint32 words as the port carries them: int64 in [0, 2^32)."""
    return _t(a.astype(np.int64))


# -- hashing ------------------------------------------------------------------


def _int_values(dtype, rng):
    info = np.iinfo(dtype)
    edges = [info.min, info.min + 1, -1, 0, 1, info.max - 1, info.max]
    if dtype == np.int64:
        edges += [2**53 + 1, -(2**53) - 1, 2**53, 2**32, -(2**32), 2**31]
    rand = rng.integers(info.min, info.max, 500, dtype=dtype, endpoint=True)
    return np.concatenate([np.array(edges, dtype=dtype), rand])


def _float_values(dtype, rng):
    info = np.finfo(dtype)
    edges = [
        0.0, -0.0, np.inf, -np.inf, np.nan, 1.0, -1.0,
        info.max, -info.max, info.tiny, -info.tiny, info.eps,
        np.float64(2**53 + 1), 1e-300 if dtype == np.float64 else 1e-30,
    ]
    rand = rng.standard_normal(500) * 10.0 ** rng.integers(-8, 9, 500)
    return np.concatenate([np.array(edges, dtype=dtype), rand.astype(dtype)])


@pytest.mark.parametrize(
    "dtype",
    [np.int8, np.int16, np.int32, np.int64, np.float32, np.float64, np.bool_],
    ids=lambda d: np.dtype(d).name,
)
def test_hash_pair_numeric_bit_equal(dtype):
    rng = np.random.default_rng(7)
    if dtype == np.bool_:
        values = np.array([True, False, True, True, False])
    elif np.issubdtype(dtype, np.integer):
        values = _int_values(dtype, rng)
    else:
        values = _float_values(dtype, rng)
    r1, r2 = (np.asarray(h) for h in rhll.hash_pair_numeric(values))
    t1, t2 = thll.hash_pair_numeric(_t(values))
    np.testing.assert_array_equal(t1.numpy(), r1.astype(np.int64))
    np.testing.assert_array_equal(t2.numpy(), r2.astype(np.int64))


def test_fmix32_matches_reference():
    words = np.random.default_rng(3).integers(0, 1 << 32, 4096, dtype=np.uint64)
    words = np.concatenate([words.astype(np.uint32), np.array([0, 1, 2**32 - 1], np.uint32)])
    want = np.asarray(rhll.fmix32(words))
    np.testing.assert_array_equal(thll.fmix32(_u32(words)).numpy(), want.astype(np.int64))


# -- register builds ----------------------------------------------------------


def _hash_inputs(shape, seed):
    rng = np.random.default_rng(seed)
    h1 = rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)
    h2 = rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)
    # rank edge cases: h2 == 0 ranks 33, a top bit ranks 1
    h2.flat[:4] = [0, 1, 2**31, 2**32 - 1]
    mask = rng.random(shape) < 0.9
    return h1, h2, mask


def _collision_inputs(shape, seed):
    rng = np.random.default_rng(seed)
    h1 = np.full(shape, 7 << (32 - rhll.P), dtype=np.uint32)
    h2 = rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)
    return h1, h2, np.ones(shape, bool)


def _masked_inputs(shape, seed):
    h1, h2, _ = _hash_inputs(shape, seed)
    return h1, h2, np.zeros(shape, bool)


CASES = {
    "random": _hash_inputs,
    "all_collision": _collision_inputs,
    "all_masked": _masked_inputs,
}


def _port_stacked(h1, h2, mask):
    return thll.registers_from_hash_pair_stacked(_u32(h1), _u32(h2), _t(mask)).numpy()


@pytest.mark.parametrize("case", sorted(CASES))
def test_stacked_registers_match_xla_scatter(case):
    h1, h2, mask = CASES[case]((3, 2048), 11)
    with rconfig.configure(pallas_scatter=False):
        want = np.asarray(rhll.registers_from_hash_pair_stacked(h1, h2, mask))
    got = _port_stacked(h1, h2, mask)
    assert got.dtype == want.dtype == np.int8
    np.testing.assert_array_equal(got, want)
    if case == "all_collision":
        assert (np.count_nonzero(got, axis=1) == 1).all()
    if case == "all_masked":
        assert not got.any()


@pytest.mark.parametrize("case", sorted(CASES))
def test_stacked_registers_match_pallas_kernel(case, pallas_interpret):
    h1, h2, mask = CASES[case]((3, 2048), 12)
    with rconfig.configure(pallas_scatter=True):
        assert pallas_scatter.impl_token() == "pallas"
        want = np.asarray(rhll.registers_from_hash_pair_stacked(h1, h2, mask))
    np.testing.assert_array_equal(_port_stacked(h1, h2, mask), want)


def test_single_column_registers_match():
    h1, h2, mask = _hash_inputs(5000, 13)
    want = np.asarray(rhll.registers_from_hash_pair(h1, h2, mask))
    got = thll.registers_from_hash_pair(_u32(h1), _u32(h2), _t(mask)).numpy()
    np.testing.assert_array_equal(got, want)


def _port_code_registers(codes, mask, lut1, lut2):
    """The port's registers of dictionary-encoded columns: the codes
    entry's plain version into zeroed registers."""
    zero = torch.zeros((codes.shape[0], thll.M), dtype=thll.REGISTER_DTYPE)
    return tsm.hll_update_codes_plain(
        _t(codes), _t(mask), None, _u32(lut1), _u32(lut2), zero
    ).numpy()


def _code_inputs(cols, rows, dict_size, seed):
    rng = np.random.default_rng(seed)
    codes = rng.integers(-1, dict_size, (cols, rows)).astype(np.int32)
    mask = (codes >= 0) & (rng.random((cols, rows)) < 0.95)
    lut1 = rng.integers(0, 1 << 32, (cols, dict_size), dtype=np.uint64).astype(np.uint32)
    lut2 = rng.integers(0, 1 << 32, (cols, dict_size), dtype=np.uint64).astype(np.uint32)
    return codes, mask, lut1, lut2


@pytest.mark.parametrize("dict_size", [16, 300, 4096])
def test_code_presence_registers_match(dict_size):
    codes, mask, lut1, lut2 = _code_inputs(2, 3000, dict_size, dict_size)
    want = np.asarray(rhll.registers_from_code_presence(codes, mask, lut1, lut2))
    got = _port_code_registers(codes, mask, lut1, lut2)
    np.testing.assert_array_equal(got, want)


def test_lut_gather_registers_match():
    """D > PRESENCE_DICT_CAP: the JAX package's inline gather + stacked
    scatter (engine/vectorize.py _build_hll_group, codes branch)."""
    dict_size = 2 * rhll.PRESENCE_DICT_CAP
    codes, mask, lut1, lut2 = _code_inputs(2, 6000, dict_size, 5)
    clipped = np.clip(codes, 0, dict_size - 1)
    want = np.asarray(
        rhll.registers_from_hash_pair_stacked(
            np.take_along_axis(lut1, clipped, axis=1),
            np.take_along_axis(lut2, clipped, axis=1),
            mask,
        )
    )
    got = _port_code_registers(codes, mask, lut1, lut2)
    np.testing.assert_array_equal(got, want)


def test_dictionary_hash_pairs_match():
    values = np.array(["a", "", "Books", "日本語", None, "x" * 100], dtype=object)
    for r, t in zip(rhll.dictionary_hash_pairs(values), thll.dictionary_hash_pairs(values)):
        np.testing.assert_array_equal(t, r)


# -- estimate -----------------------------------------------------------------


@pytest.mark.parametrize("fill", [0.0, 0.01, 0.5, 1.0])
def test_estimate_equal_on_equal_registers(fill):
    rng = np.random.default_rng(int(fill * 100))
    ranks = np.minimum(rng.geometric(0.5, rhll.M), 33)
    registers = np.where(rng.random(rhll.M) < fill, ranks, 0).astype(np.int8)
    assert thll.estimate(registers) == rhll.estimate(registers)
    assert thll.estimate(torch.from_numpy(registers)) == rhll.estimate(registers)


# -- through the engines ------------------------------------------------------


class _Keep:
    def __init__(self):
        self.states = {}

    def persist(self, analyzer, state):
        self.states[repr(analyzer)] = state


def test_engine_registers_match_for_large_dictionaries():
    """String columns past PRESENCE_DICT_CAP, stacked (two columns) and
    single, plus a numeric stacked pair, at two batches."""
    rng = np.random.default_rng(21)
    n = 6000
    words = np.array([f"w{i}" for i in range(5000)], dtype=object)
    data = {
        "s1": [None if rng.random() < 0.05 else w for w in words[rng.integers(0, 5000, n)]],
        "s2": list(words[rng.integers(0, 5000, n)]),
        "s3": list(words[rng.integers(0, 5000, n)]),
        "a": rng.integers(0, 1000, n),
        "b": rng.integers(-(2**62), 2**62, n),
    }
    analyzers_of = lambda pkg: [  # noqa: E731
        pkg.ApproxCountDistinct("s1"),
        pkg.ApproxCountDistinct("s2"),
        pkg.ApproxCountDistinct("a"),
        pkg.ApproxCountDistinct("b"),
    ]
    rkeep = InMemoryStateProvider()
    with rconfig.configure(batch_size=3500):
        R.AnalysisRunner.do_analysis_run(
            R.Dataset.from_pydict(data), analyzers_of(R), save_states_with=rkeep
        )
        R.AnalysisRunner.do_analysis_run(
            R.Dataset.from_pydict(data), [R.ApproxCountDistinct("s3")],
            save_states_with=rkeep,
        )
    tkeep = _Keep()
    with tconfig.configure(device="cpu", batch_size=3500):
        T.AnalysisRunner.do_analysis_run(
            T.Dataset.from_pydict(data),
            analyzers_of(T) + [T.ApproxCountDistinct("s3")],
            save_states_with=tkeep,
        )
    for name in ["s1", "s2", "s3", "a", "b"]:
        key = repr(T.ApproxCountDistinct(name))
        want = np.asarray(rkeep.load(R.ApproxCountDistinct(name)).registers)
        np.testing.assert_array_equal(tkeep.states[key].registers.numpy(), want, err_msg=name)
