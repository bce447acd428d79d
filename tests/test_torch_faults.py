"""Two faults of the port's Dataset, repaired, against the JAX package on
the CPU.

1. A uint64 column used to fail the Dataset's construction, and with it
   every analyzer of the table. Torch has no uint64 arithmetic, so the
   port keeps the unsigned value as float64 for the analyzers that read
   values (as the JAX package converts it for sums and extrema) and the
   int64 bit view for the HLL hash (the JAX package's registers of a
   uint64 column are those of its raw 64 bits). Integer state (counts,
   min, max, HLL registers) must equal the reference exactly; Sum, Mean
   and StandardDeviation sum float64 in another order, so they must sit
   within FLOAT_RTOL of the reference.
2. A null-typed column under ApproxCountDistinct used to fail every
   analyzer of the fused scan. It now has an all-masked ``values``
   repr, so its estimate is 0.0 (the reference's answer for a column
   with no value). The reference itself zeroes the whole pass on such a
   table, so the other analyzers are held against the reference's run
   without ``ApproxCountDistinct("s")``.
"""

import math

import numpy as np
import pyarrow as pa
import pytest

import deequ_tpu as R
from deequ_tpu.io.state_provider import InMemoryStateProvider

import deequ_tpu_torch as T
from deequ_tpu_torch.data import ColumnRequest, Kind
from deequ_tpu_torch import config as tconfig

# float64 sums of up to 5,000 values near 2^64, taken in another order
# than XLA's: a few ulp of the result
FLOAT_RTOL = 1e-12
NAMES = ["Size", "Completeness", "Sum", "Mean", "Minimum", "Maximum",
         "StandardDeviation", "ApproxCountDistinct"]
EXACT = {"Size", "Completeness", "Minimum", "Maximum", "ApproxCountDistinct"}


class _Keep:
    def __init__(self):
        self.states = {}

    def persist(self, analyzer, state):
        self.states[repr(analyzer)] = state


def _analyzers(pkg, column, where=None):
    out = []
    for name in NAMES:
        cls = getattr(pkg, name)
        out.append(cls(where=where) if name == "Size" else cls(column, where=where))
    return out


def _metrics(pkg, dataset, analyzers, **kwargs):
    ctx = pkg.AnalysisRunner.do_analysis_run(dataset, analyzers, **kwargs)
    return {repr(a): ctx.metric(a).value.get() for a in analyzers}


def _compare(got, want):
    assert got.keys() == want.keys()
    for key, w in want.items():
        g = got[key]
        if any(key.startswith(name + "(") for name in EXACT):
            assert g == w, key
        else:
            assert math.isclose(g, w, rel_tol=FLOAT_RTOL), (key, g, w)


def _uint64_columns():
    rng = np.random.default_rng(64)
    odd = rng.integers(0, 2**63, 5000, dtype=np.uint64) * np.uint64(2) + np.uint64(1)
    masked = np.ma.array(odd, mask=rng.random(5000) < 0.1)
    return {
        "tiny": np.array([0, 2**64 - 1, 5], dtype=np.uint64),
        "odd": odd,
        "nullable": masked,
    }


@pytest.mark.parametrize("column", ["tiny", "odd", "nullable"])
def test_uint64_column_runs_every_ported_analyzer_as_the_reference(column):
    values = _uint64_columns()[column]
    data = {"u": values, "i": np.arange(len(values))}
    analyzers = lambda pkg: _analyzers(pkg, "u") + [pkg.Mean("i")]  # noqa: E731
    want = _metrics(R, R.Dataset.from_pydict(data), analyzers(R))
    with tconfig.configure(device="cpu"):
        got = _metrics(T, T.Dataset.from_pydict(data), analyzers(T))
    _compare(got, want)
    assert all(v == v for v in got.values())  # no failure, no NaN
    if column == "tiny":
        assert got[repr(T.Maximum("u"))] == 1.8446744073709552e19
        assert got[repr(T.Sum("u"))] == 1.8446744073709552e19
        assert got[repr(T.Mean("u"))] == 6.148914691236517e18


def test_uint64_hll_registers_equal_the_reference_stacked_single_and_filtered():
    """Two uint64 columns stack into one HLL group, a third stays single,
    and a fourth analyzer filters on a uint64 column, over three batches:
    registers equal the reference's exactly."""
    cols = _uint64_columns()
    rng = np.random.default_rng(3)
    n = 5000
    table = pa.table({
        "a": pa.array(cols["odd"]),
        "b": pa.array(rng.integers(0, 2**64 - 1, n, dtype=np.uint64, endpoint=True)),
        "c": pa.array(cols["nullable"].data, mask=np.ma.getmaskarray(cols["nullable"])),
        "q": pa.array(rng.integers(0, 100, n)),
    })
    analyzers = lambda pkg: [  # noqa: E731
        pkg.ApproxCountDistinct("a"), pkg.ApproxCountDistinct("b"),
        pkg.ApproxCountDistinct("c"), pkg.ApproxCountDistinct("a", where="q > 40"),
        pkg.ApproxCountDistinct("b", where="q > 40"),
    ]
    rkeep = InMemoryStateProvider()
    from deequ_tpu import config as rconfig

    with rconfig.configure(batch_size=2048):
        R.AnalysisRunner.do_analysis_run(
            R.Dataset.from_arrow(table), analyzers(R), save_states_with=rkeep)
    tkeep = _Keep()
    with tconfig.configure(device="cpu", batch_size=2048):
        T.AnalysisRunner.do_analysis_run(
            T.Dataset.from_arrow(table), analyzers(T), save_states_with=tkeep)
    for r, t in zip(analyzers(R), analyzers(T)):
        want = np.asarray(rkeep.load(r).registers)
        assert want.any()
        np.testing.assert_array_equal(tkeep.states[repr(t)].registers.numpy(), want,
                                      err_msg=repr(t))


def test_uint64_values_never_reach_torch_as_uint64():
    ds = T.Dataset.from_pydict({"u": _uint64_columns()["tiny"]})
    assert ds.schema.kind_of("u") == Kind.INTEGRAL
    assert ds.hll_repr("u") == "bits"
    values = ds.materialize(ColumnRequest("u", "values"))
    bits = ds.materialize(ColumnRequest("u", "bits"))
    assert values.dtype == np.float64 and bits.dtype == np.int64
    assert values.tolist() == [0.0, 2.0**64, 5.0]
    assert bits.tolist() == [0, -1, 5]


NULL_TABLE = {"s": [None, None, None], "x": [1.0, 2.0, 3.0], "y": [5, 6, 7]}


@pytest.mark.parametrize("source", ["pydict", "arrow"])
def test_null_typed_column_under_approx_count_distinct(source):
    others = lambda pkg: [pkg.Size(), pkg.Mean("y"), pkg.ApproxCountDistinct("x")]  # noqa: E731
    # the reference zeroes its whole pass with ApproxCountDistinct("s")
    # in it, so the port is held to the reference's run without it
    want = _metrics(R, R.Dataset.from_pydict(NULL_TABLE), others(R))
    if source == "pydict":
        dataset = T.Dataset.from_pydict(NULL_TABLE)
    else:
        dataset = T.Dataset.from_arrow(pa.table({
            "s": pa.nulls(3), "x": pa.array(NULL_TABLE["x"]), "y": pa.array(NULL_TABLE["y"]),
        }))
    assert dataset.schema.kind_of("s") == Kind.UNKNOWN
    with tconfig.configure(device="cpu"):
        got = _metrics(T, dataset, others(T) + [T.ApproxCountDistinct("s")])
    assert got.pop(repr(T.ApproxCountDistinct("s"))) == 0.0
    assert got == want
    assert want == {
        repr(T.Size()): 3.0,
        repr(T.Mean("y")): 6.0,
        repr(T.ApproxCountDistinct("x")): 3.000279510809919,
    }
