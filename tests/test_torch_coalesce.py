"""Coalesced runs of the port: many suites, one scan.

Counterparts of ``tests/test_coalesce.py::TestContextSubset`` and
``TestPlanMergeDiff``, on the CPU:

- ``AnalyzerContext.subset`` of a superset run equals each member's solo
  run, resident and streamed, over grouping (dense and device spill),
  KLL, HLL and ``where=``-filtered members; the run's provenance rides
  every slice;
- ``AnalysisRunner.do_coalesced_analysis_run`` and
  ``VerificationSuite.do_coalesced_verification_run`` make ONE data pass
  and one fetch (two with a spill plan), like a solo run of the union,
  and every member equals its solo run bit for bit and the JAX package's
  solo run (floats within 1e-12 relative, ROADMAP's tolerance);
- ``merge_plans`` deduplicates ops by their behaviour token and a merged
  plan executes equal to the solo plan; ``plan_compatibility`` and
  ``plan_diff`` name what differs; ``coalesce_key_surface`` tracks the
  config. The port keeps no plan cache, so a merged plan has no cache
  key (a divergence ROADMAP names);
- ``Analyzer.identity_key`` equals the JAX package's for every analyzer
  type of the goldens.
"""

import math

import numpy as np
import pytest
import torch

import deequ_tpu as R
from deequ_tpu import config as rconfig

import deequ_tpu_torch as T
from deequ_tpu_torch import config as tconfig
from deequ_tpu_torch.analyzers.runner import _plan_fused_pass
from deequ_tpu_torch.engine.scan import (
    coalesce_key_surface,
    merge_plans,
    plan_compatibility,
    plan_diff,
)

import test_torch_goldens as goldens
from tools import goldens_spec

ROWS = 4000
RTOL = 1e-12


@pytest.fixture(autouse=True)
def _cpu():
    with tconfig.configure(device="cpu"):
        yield


def _data(n=ROWS, seed=11):
    rng = np.random.default_rng(seed)
    return {
        "a": rng.integers(0, 500, n, dtype=np.int64).tolist(),
        "b": rng.normal(10.0, 3.0, n).tolist(),
        "g": (np.arange(n) % 13).tolist(),
        # a wide integer key: its frequency plans take the device spill
        "u": rng.integers(0, 1 << 40, n, dtype=np.int64).tolist(),
        "s": [f"v{i % 97}" for i in range(n)],
    }


def _table(n=ROWS, seed=11):
    return T.Dataset.from_pydict(_data(n, seed))


def _values(context):
    out = {}
    for analyzer, metric in context.metric_map.items():
        assert metric.value.is_success, (analyzer, metric.value)
        out[analyzer.identity_key] = metric.value.get()
    return out


def _assert_bit_equal(sliced, solo):
    assert sliced.keys() == solo.keys()
    for key, want in solo.items():
        got = sliced[key]
        if isinstance(want, float):
            assert (math.isnan(got) and math.isnan(want)) or got == want, (key, got, want)
        else:
            assert got == want, (key, got, want)


def _assert_close(got, want):
    assert got.keys() == want.keys()
    for key, w in want.items():
        g = got[key]
        if isinstance(w, float):
            assert g == pytest.approx(w, rel=RTOL, abs=0), key
        elif hasattr(w, "values") and hasattr(w, "number_of_bins"):  # distributions
            assert g.number_of_bins == w.number_of_bins, key
            assert {k: v.absolute for k, v in g.values.items()} == \
                {k: v.absolute for k, v in w.values.items()}, key
        else:
            assert g == w, key


SUITE = [T.Completeness("a"), T.Mean("b"), T.Minimum("b"), T.Size()]
EXTRA = [T.Maximum("b"), T.Sum("a"), T.StandardDeviation("b"), T.Compliance("pos", "b >= 0")]
STATEFUL = [T.Uniqueness(["a"]), T.ApproxQuantile("b", 0.5), T.ApproxCountDistinct("s"),
            T.Histogram("g"), T.Uniqueness(["u"])]
STATEFUL_EXTRA = [T.Uniqueness(["g"]), T.ApproxQuantile("b", 0.9), T.Mean("b"),
                  T.ApproxCountDistinct("a"), T.CountDistinct(["u"])]


class TestContextSubset:
    @pytest.mark.parametrize("streamed", [False, True])
    def test_subset_of_superset_equals_solo(self, streamed):
        data = _table()
        overrides = {"device_cache_bytes": 0, "batch_size": 1024} if streamed else {}
        with tconfig.configure(**overrides):
            superset = T.AnalysisRunner.do_analysis_run(data, SUITE + EXTRA,
                                                        engine=T.AnalysisEngine())
            solo = T.AnalysisRunner.do_analysis_run(data, SUITE, engine=T.AnalysisEngine())
        _assert_bit_equal(_values(superset.subset(SUITE)), _values(solo))

    @pytest.mark.parametrize("streamed", [False, True])
    def test_subset_grouping_spill_kll_hll(self, streamed):
        """Slicing is by identity, whatever computed the metric: dense
        and spilled frequency plans, KLL and HLL sketches."""
        data = _table()
        overrides = dict(batch_size=1024)
        if streamed:
            overrides["device_cache_bytes"] = ROWS * 64
        with tconfig.configure(**overrides):
            superset = T.AnalysisRunner.do_analysis_run(data, STATEFUL + STATEFUL_EXTRA,
                                                        engine=T.AnalysisEngine())
            solo = T.AnalysisRunner.do_analysis_run(data, STATEFUL, engine=T.AnalysisEngine())
        paths = [e.get("path") for e in superset.run_metadata.events
                 if e.get("event") == "grouping_spill"]
        assert paths == ["device-sort"]
        sliced = _values(superset.subset(STATEFUL))
        want = _values(solo)
        assert sliced.keys() == want.keys()
        for key in want:
            if hasattr(want[key], "values"):
                _assert_close({key: sliced[key]}, {key: want[key]})
            else:
                _assert_bit_equal({key: sliced[key]}, {key: want[key]})

    def test_subset_where_filtered_analyzers_distinct(self):
        data = _table()
        plain = T.Completeness("a")
        filtered = T.Completeness("a", where="b >= 10")
        superset = T.AnalysisRunner.do_analysis_run(data, [plain, filtered, T.Mean("b")],
                                                    engine=T.AnalysisEngine())
        only_filtered = superset.subset([filtered])
        assert list(only_filtered.metric_map) == [filtered]
        solo = T.AnalysisRunner.do_analysis_run(data, [filtered], engine=T.AnalysisEngine())
        _assert_bit_equal(_values(only_filtered), _values(solo))
        assert _values(superset.subset([plain]))[plain.identity_key] == 1.0

    def test_identity_key_parameter_complete(self):
        assert T.Completeness("a").identity_key != T.Completeness("b").identity_key
        assert (T.Completeness("a").identity_key
                != T.Completeness("a", where="b > 0").identity_key)
        assert T.ApproxQuantile("b", 0.5).identity_key != T.ApproxQuantile("b", 0.9).identity_key
        assert T.Mean("a").identity_key == T.Mean("a").identity_key

    def test_subset_carries_scan_provenance(self):
        full = T.AnalysisRunner.do_analysis_run(_table(n=256), [T.Mean("b"), T.Size()],
                                                engine=T.AnalysisEngine())
        marker = object()
        full.degradation = marker
        full.interruption = marker
        sliced = full.subset([T.Size()])
        assert sliced.degradation is marker
        assert sliced.interruption is marker
        assert sliced.run_metadata is full.run_metadata
        assert sliced.telemetry is full.telemetry

    def test_subset_keys_by_the_members_own_objects(self):
        full = T.AnalysisRunner.do_analysis_run(_table(n=256), [T.Mean("b"), T.Size()],
                                                engine=T.AnalysisEngine())
        mine = T.Mean("b")
        sliced = full.subset([mine, mine, T.Maximum("b")])
        assert list(sliced.metric_map) == [mine]
        assert next(iter(sliced.metric_map)) is mine


SUITES = [
    [T.Completeness("a"), T.Mean("b")],
    [T.Mean("b"), T.Maximum("b"), T.ApproxCountDistinct("s")],
    [T.Size(), T.Uniqueness(["u"]), T.ApproxQuantile("b", 0.25)],
    [T.Completeness("a", where="g > 3"), T.Histogram("g")],
]


def _reference_suite(suite):
    return [goldens_like(a) for a in suite]


def goldens_like(analyzer):
    """The JAX package's analyzer of a port analyzer (the frozen
    dataclasses share their reprs: ``identity_key``)."""
    namespace = {name: getattr(R, name) for name in dir(R) if not name.startswith("_")}
    return eval(analyzer.identity_key, namespace)  # noqa: S307 — our own reprs


class TestCoalescedRuns:
    @pytest.mark.parametrize("streamed", [False, True])
    def test_coalesced_analysis_run_slices_per_suite(self, streamed):
        data = _table()
        overrides = dict(batch_size=1024)
        if streamed:
            overrides["device_cache_bytes"] = ROWS * 64
        with tconfig.configure(**overrides):
            engine = T.AnalysisEngine()
            contexts = T.AnalysisRunner.do_coalesced_analysis_run(data, SUITES, engine=engine)
            union = T.AnalysisEngine()
            T.AnalysisRunner.do_analysis_run(
                data, [a for suite in SUITES for a in suite], engine=union)
            solos = [T.AnalysisRunner.do_analysis_run(data, suite, engine=T.AnalysisEngine())
                     for suite in SUITES]
        assert len(contexts) == len(SUITES)
        # one traversal and the union's fetches: the spill's scalars are
        # the second fetch
        assert engine.data_passes == union.data_passes == 1
        assert engine.device_fetches == union.device_fetches == 2
        for context, solo in zip(contexts, solos):
            got, want = _values(context), _values(solo)
            for key in want:
                if hasattr(want[key], "values"):
                    _assert_close({key: got[key]}, {key: want[key]})
                else:
                    _assert_bit_equal({key: got[key]}, {key: want[key]})

    def test_members_equal_the_reference_solo_runs(self):
        data = _data()
        with tconfig.configure(batch_size=1024), rconfig.configure(batch_size=1024):
            contexts = T.AnalysisRunner.do_coalesced_analysis_run(
                T.Dataset.from_pydict(data), SUITES, engine=T.AnalysisEngine())
            for suite, context in zip(SUITES, contexts):
                ref = R.AnalysisRunner.do_analysis_run(R.Dataset.from_pydict(data),
                                                       _reference_suite(suite))
                _assert_close(_values(context), _values(ref))

    def test_coalesced_verification_run(self):
        data = _table()
        members = [
            ([T.Check(T.CheckLevel.ERROR, "one").is_complete("a").has_mean("b", lambda m: m > 9)],
             [T.Maximum("b")]),
            ([T.Check(T.CheckLevel.WARNING, "two").has_size(lambda n: n == ROWS)
              .is_unique("u").is_unique("g").has_min("b", lambda m: m > 0)], []),
            ([T.Check(T.CheckLevel.ERROR, "three").has_approx_count_distinct(
                "s", lambda d: d > 200)], [T.Mean("b")]),
        ]
        engine = T.AnalysisEngine()
        with tconfig.configure(batch_size=1024):
            results = T.VerificationSuite.do_coalesced_verification_run(data, members,
                                                                        engine=engine)
            solos = [T.VerificationSuite.do_verification_run(data, checks, list(required),
                                                             engine=T.AnalysisEngine())
                     for checks, required in members]
        assert engine.data_passes == 1
        assert [r.status for r in results] == [s.status for s in solos]
        assert [r.status.value for r in results] == ["Success", "Warning", "Error"]
        for result, solo in zip(results, solos):
            assert result.check_results_as_records() == solo.check_results_as_records()
            got = {a.identity_key: m.value.get() for a, m in result.metrics.items()}
            want = {a.identity_key: m.value.get() for a, m in solo.metrics.items()}
            _assert_bit_equal(got, want)


def _prepare(data, analyzers, engine=None):
    engine = engine or T.AnalysisEngine()
    fused = _plan_fused_pass(data, list(analyzers), [], engine)
    plan = engine.prepare_scan(data, fused.scan_pairs)
    assert plan is not None
    return plan


class TestPlanMergeDiff:
    def test_merge_dedups_shared_ops(self):
        data = _table()
        plan_a = _prepare(data, [T.Completeness("a"), T.Mean("b")])
        plan_b = _prepare(data, [T.Mean("b"), T.Completeness("g")])
        assert plan_compatibility(plan_a, plan_b) is None
        merged = merge_plans(plan_a, plan_b)
        diff = plan_diff(plan_a, plan_b)
        assert diff.mergeable and diff.savings >= 1
        assert len(merged.ops) == len(plan_a.ops) + len(plan_b.ops) - diff.savings
        assert not hasattr(merged, "cache_key")
        assert {r.key for r in merged.requests} == \
            {r.key for r in plan_a.requests} | {r.key for r in plan_b.requests}

    def test_fused_and_solo_units_do_not_share_a_token(self):
        """Mean("b") alone and Mean("b") fused with Minimum("b") are
        different ops (the vectorizer's group): no dedup."""
        data = _table()
        plan_a = _prepare(data, [T.Mean("b")])
        plan_b = _prepare(data, [T.Mean("b"), T.Minimum("b")])
        assert plan_diff(plan_a, plan_b).savings == 0

    def test_untokened_ops_are_kept(self):
        data = _table()
        plan = _prepare(data, [T.Mean("b")])
        for op in plan.ops:
            op.behaviour_token = None
        merged = merge_plans(plan, plan)
        assert len(merged.ops) == 2 * len(plan.ops)
        diff = plan_diff(plan, plan)
        assert diff.savings == 0 and diff.opaque_a == len(plan.ops)

    def test_merge_incompatible_raises(self):
        data = _table()
        plan_a = _prepare(data, [T.Mean("b")], T.AnalysisEngine(batch_size=512))
        plan_b = _prepare(data, [T.Mean("b")], T.AnalysisEngine(batch_size=1024))
        reason = plan_compatibility(plan_a, plan_b)
        assert reason is not None and "batch_size" in reason
        assert not plan_diff(plan_a, plan_b).mergeable
        with pytest.raises(ValueError, match="batch_size"):
            merge_plans(plan_a, plan_b)

    @pytest.mark.parametrize("field,configure", [
        ("mode", dict(device_cache_bytes=64)),
        ("cache_budget", dict(device_cache_bytes=1 << 31)),
        ("wire_codecs", dict(wire_codecs=True)),
    ])
    def test_compatibility_names_the_field(self, field, configure):
        data = _table()
        plan_a = _prepare(data, [T.Mean("b")])
        with tconfig.configure(**configure):
            plan_b = _prepare(data, [T.Mean("b")])
        assert plan_compatibility(plan_a, plan_b).startswith(field)

    @pytest.mark.parametrize("streamed", [False, True])
    def test_merged_plan_executes_identically(self, streamed):
        data = _table()
        overrides = {"device_cache_bytes": 0, "batch_size": 1024} if streamed else {}
        with tconfig.configure(**overrides):
            engine = T.AnalysisEngine()
            plan_a = _prepare(data, [T.Mean("b"), T.Size(), T.ApproxCountDistinct("s")],
                              engine)
            plan_b = _prepare(data, [T.Mean("b"), T.Size(), T.ApproxCountDistinct("s")],
                              engine)
            merged = merge_plans(plan_a, plan_b)
            assert len(merged.ops) == len(plan_a.ops)
            states_merged = engine.execute_plan(merged, data)
            states_solo = T.AnalysisEngine().execute_plan(plan_a, data)
        assert engine.data_passes == 1
        leaves_g = torch.utils._pytree.tree_leaves(states_merged)
        leaves_w = torch.utils._pytree.tree_leaves(states_solo)
        assert len(leaves_g) == len(leaves_w)
        for got, want in zip(leaves_g, leaves_w):
            np.testing.assert_array_equal(np.asarray(got), np.asarray(want))

    def test_coalesce_key_surface_tracks_config(self):
        base = coalesce_key_surface()
        hash(base)
        for option in (dict(batch_size=77), dict(device="cuda"), dict(wire_codecs=True),
                       dict(device_cache_bytes=5), dict(one_pass_spill=False)):
            with tconfig.configure(**option):
                assert coalesce_key_surface() != base, option
        assert coalesce_key_surface() == base


GOLDEN_TYPES = sorted({c["analyzer"]["type"] for c in goldens.GOLDEN["cases"]})


@pytest.mark.parametrize("kind", GOLDEN_TYPES)
def test_identity_key_equals_the_reference(kind):
    """Every analyzer of the goldens has the JAX package's identity key
    in the port (no divergence)."""
    specs = [c["analyzer"] for c in goldens.GOLDEN["cases"] if c["analyzer"]["type"] == kind]
    for spec in specs:
        assert goldens.PORTED[kind](spec).identity_key == \
            goldens_spec.build_analyzer(spec).identity_key, spec
