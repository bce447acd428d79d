"""The engine's host-fold contract (``ScanOps.host_init``/``host_fold``).

- Every batch's output is folded on the host in batch order, whether the
  retained outputs are fetched once at the end or drained every
  ``DRAIN_EVERY`` batches; each drain is one more device fetch, and a
  drained scan folds to the same sketches as an undrained one.
- A suite that mixes KLL sketches with device-carried groups (stats,
  completeness, HLL, DataType) makes one pass over the data and one
  device fetch, and its quantiles equal the JAX package's.
- A float HLL column that a same-filter KLL group covers (the JAX
  package builds its registers from the KLL sort) stays on K1's fused
  entry in the port, and its registers equal the JAX package's.
"""

from dataclasses import dataclass

import numpy as np
import pytest
import torch

import deequ_tpu as R
from deequ_tpu import config as rconfig
from deequ_tpu.engine import vectorize as rvec
from deequ_tpu.io.state_provider import InMemoryStateProvider

import deequ_tpu_torch as T
from deequ_tpu_torch import config as tconfig
from deequ_tpu_torch.analyzers.base import ScanOps, ScanShareableAnalyzer
from deequ_tpu_torch.data.table import ColumnRequest
from deequ_tpu_torch.engine import scan as tscan
from deequ_tpu_torch.engine import vectorize as tvec
from deequ_tpu_torch.sketches import scatter_max

ROWS = 700
BATCH = 100  # 7 batches


@dataclass(frozen=True)
class FirstValues(ScanShareableAnalyzer):
    """Test analyzer: each batch emits its first value; the host folds
    them into a list, so the state shows the order of the folds."""

    column: str

    @property
    def instance(self):
        return self.column

    def device_requests(self, dataset):
        return [ColumnRequest(self.column, "values")]

    def make_ops(self, dataset):
        col = self.column
        return ScanOps(
            lambda: (torch.zeros(1, dtype=torch.float64),),
            lambda _state, batch: (batch[f"{col}::values"][:1].to(torch.float64),),
            lambda a, b: a + b,
            host_init=list,
            host_fold=lambda acc, out: acc + [float(out[0][0])],
        )


@pytest.mark.parametrize("drain_every, fetches", [(1, 7), (2, 4), (6, 2), (7, 1), (64, 1)])
def test_outputs_fold_in_batch_order(monkeypatch, drain_every, fetches):
    monkeypatch.setattr(tscan, "DRAIN_EVERY", drain_every)
    data = T.Dataset.from_pydict({"x": np.arange(ROWS, dtype=np.float64)})
    engine = T.AnalysisEngine(device="cpu", batch_size=BATCH)
    analyzer = FirstValues("x")
    size = T.Size()
    states = engine.run_scan(data, [(analyzer, analyzer.make_ops(data)), (size, size.make_ops(data))])
    assert states[0] == [float(b) for b in range(0, ROWS, BATCH)]
    assert int(states[1].num_matches) == ROWS  # the carried state beside it
    assert engine.device_fetches == fetches and engine.data_passes == 1
    # the JAX package's PhaseClock buckets, then the port's own split
    assert set(engine.phase_times) == {"resident_s", "scan_s", "fold_s", "host_wait_s", "put_s",
                                       "dispatch_s", "first_step_s", "sync_s", "mode"}


def test_drained_sketches_equal_undrained(monkeypatch):
    rng = np.random.default_rng(0)
    data = T.Dataset.from_pydict({"x": rng.standard_normal(ROWS), "y": rng.integers(0, 99, ROWS)})
    params = T.KLLParameters(sketch_size=16)
    analyzers = [T.KLLSketch("x", params), T.KLLSketch("y", params), T.ApproxQuantile("x", 0.5)]

    def sketches(drain_every):
        monkeypatch.setattr(tscan, "DRAIN_EVERY", drain_every)
        keep = InMemoryStateProvider()
        T.AnalysisRunner.do_analysis_run(
            data, analyzers, save_states_with=keep,
            engine=T.AnalysisEngine(device="cpu", batch_size=BATCH),
        )
        return [keep.load(a).to_arrays() for a in analyzers]

    for drained, whole in zip(sketches(3), sketches(64)):
        for key in whole:
            np.testing.assert_array_equal(drained[key], whole[key])


def _mixed(pkg):
    return (
        pkg.Check(pkg.CheckLevel.ERROR, "mixed")
        .has_size(lambda n: n == 5000)
        .has_mean("x", lambda v: v == v)
        .has_max("x", lambda v: v == v)
        .is_complete("k")
        .has_completeness("s", lambda v: v > 0.5)
        .has_approx_count_distinct("k", lambda v: v > 0)
        .has_approx_count_distinct("x", lambda v: v > 0)
        .has_approx_quantile("x", 0.5, lambda v: -1 < v < 1)
        .has_approx_quantile("k", 0.9, lambda v: v > 0)
        .has_approx_quantile("x", 0.1, lambda v: v < 0).where("s = 'a'")
        .kll_sketch_satisfies("x", lambda d: len(d.buckets) == 100)
        .has_data_type("s", pkg.checks.ConstrainableDataTypes.STRING, lambda v: v > 0.5)
        .has_data_type("k", pkg.checks.ConstrainableDataTypes.INTEGRAL)
        .has_pattern("s", "a", lambda v: v > 0)
        .has_column_count(lambda c: c == 3)
    )


def test_one_pass_and_one_fetch_for_a_mixed_suite():
    rng = np.random.default_rng(1)
    data = {
        "x": rng.standard_normal(5000),
        "k": rng.integers(0, 10**6, 5000),
        "s": list(np.array(["a", "b", None], dtype=object)[rng.integers(0, 3, 5000)]),
    }
    engine = T.AnalysisEngine(device="cpu", batch_size=1024)
    port = (
        T.VerificationSuite().on_data(T.Dataset.from_pydict(data))
        .add_check(_mixed(T)).with_engine(engine).run()
    )
    assert engine.data_passes == 1 and engine.device_fetches == 1
    with rconfig.configure(batch_size=1024):
        ref = R.VerificationSuite().on_data(R.Dataset.from_pydict(data)).add_check(_mixed(R)).run()
    assert port.status.value == ref.status.value == "Success"
    port_metrics = {repr(a): m for a, m in port.metrics.items()}
    for a, m in ref.metrics.items():
        if type(a).__name__ in ("ApproxQuantile", "ApproxCountDistinct", "Size", "Completeness"):
            assert port_metrics[repr(a)].value.get() == m.value.get(), a


def test_kll_covered_float_hll_column_stays_on_the_fused_entry(monkeypatch):
    rng = np.random.default_rng(2)
    data = {
        "x": rng.standard_normal(3000).astype(np.float32),
        "y": np.round(rng.random(3000) * 50).astype(np.float32),
    }
    data["x"][::17] = data["x"][0]  # repeats, as the sorted-dedup path sees them

    def analyzers(pkg):
        return [
            pkg.ApproxCountDistinct("x"), pkg.ApproxCountDistinct("y"),
            pkg.KLLSketch("x"), pkg.ApproxQuantile("x", 0.5), pkg.KLLSketch("y"),
        ]

    # the JAX package pools this HLL group into the KLL group's sort (its
    # unit's token names the pooled columns)
    runits, _ = rvec.plan_scan_units(R.Dataset.from_pydict(data), analyzers(R))
    assert [u.ops.cache_token[4][1] for u in runits if u.ops.cache_token[1] == "hll"] == [("x", "y")]

    dataset = T.Dataset.from_pydict(data)
    units, _ = tvec.plan_scan_units(dataset, analyzers(T))
    hll_units = [u for u in units if type(u.members[0]).__name__ == "ApproxCountDistinct"]
    assert len(hll_units) == 1 and len(hll_units[0].members) == 2
    assert hll_units[0].ops.host_fold is None

    calls = []
    fused = scatter_max.hll_update

    def counting(values, *args):
        calls.append(tuple(values.shape))
        return fused(values, *args)

    monkeypatch.setattr(scatter_max, "hll_update", counting)
    rkeep, tkeep = InMemoryStateProvider(), InMemoryStateProvider()
    with tconfig.configure(device="cpu", batch_size=1000):
        T.AnalysisRunner.do_analysis_run(dataset, analyzers(T), save_states_with=tkeep)
    with rconfig.configure(batch_size=1000):
        R.AnalysisRunner.do_analysis_run(R.Dataset.from_pydict(data), analyzers(R), save_states_with=rkeep)
    assert calls == [(2, 1000)] * 3  # one fused update of both columns a batch
    for a in analyzers(R)[:2]:
        np.testing.assert_array_equal(
            tkeep.load(a).registers.numpy(), np.asarray(rkeep.load(a).registers), err_msg=repr(a)
        )
