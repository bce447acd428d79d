"""Rank bodies of the mesh tests and the seeded data they share with the
parent test process.

``deequ_tpu_torch.testing.mesh.run_ranks`` starts fresh processes that
import this module and call one of the ``rank_*`` functions as
``fn(rank, world, mesh, *args)``. A rank must import neither ``jax`` nor
``deequ_tpu``, so this module imports only numpy, torch and the port;
the parent builds the JAX package's side of each comparison from the
same data builders. Analyzers travel as ``(class name, args, kwargs)``
specs that both packages resolve by name. The module holds no tests.
"""

from __future__ import annotations

import sys
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

Spec = tuple  # (analyzer class name, args, kwargs)


# -- seeded data, as the JAX package's tests build it ----------------------


def mixed(seed: int, n: int = 40_000) -> Dict[str, list]:
    """``tests/test_differential.py::_mixed_dataset``."""
    rng = np.random.default_rng(seed)
    x = rng.normal(5.0, 2.0, n).astype(object)
    x[:: rng.integers(5, 20)] = None
    return {
        "x": list(x),
        "y": list(rng.normal(-1.0, 1.0, n)),
        "k": list(rng.integers(0, n // 2, n, dtype=np.int64)),
        "s": list(np.array(["red", "green", "blue", "17", ""])[rng.integers(0, 5, n)]),
    }


def big_numeric(n: int = 50_000, seed: int = 7) -> Dict[str, Any]:
    """``tests/fixtures.py::big_numeric``."""
    rng = np.random.default_rng(seed)
    return {"x": rng.normal(10.0, 3.0, n), "y": rng.integers(0, 50, n)}


def grouping_gh(n: int = 40_000) -> Dict[str, Any]:
    """``tests/test_mesh.py::test_mesh_grouping_equals_single_device``."""
    rng = np.random.default_rng(9)
    return {"g": rng.integers(0, 500, n), "h": rng.choice(["a", "b", "c"], n)}


def sketches(n: int = 40_000) -> Dict[str, Any]:
    """``tests/test_mesh.py::test_mesh_sketches_equal_single_device``."""
    rng = np.random.default_rng(21)
    return {
        "x": rng.normal(50.0, 9.0, n),
        "k": rng.integers(0, 30_000, n),
        "s": rng.choice(["1", "2.5", "x", "true", ""], n),
    }


def profile_like(n: int = 8192, seed: int = 3) -> Dict[str, Any]:
    """``tests/test_fastpath_differential.py::_profile_like_data``."""
    rng = np.random.default_rng(seed)
    return {
        "x": rng.normal(size=n).astype(np.float32),
        "y": rng.normal(size=n).astype(np.float32),
        "id": rng.integers(0, 1 << 30, n),
    }


def widened_gate(n: int = 65536, seed: int = 8) -> Dict[str, Any]:
    """``tests/test_fastpath_differential.py::_widened_gate_data`` (its
    mispredicting form)."""
    rng = np.random.default_rng(seed)
    half = n // 2
    lo = rng.choice(np.arange(0, 200_000, 7), 1000, replace=False)
    batch1 = lo[rng.integers(0, 1000, half)]
    batch2 = np.arange(half) * 7 + rng.integers(0, 3, half)
    return {f"c{i}": np.concatenate([batch1, np.roll(batch2, rot)]).astype(np.int32)
            for i, rot in enumerate((0, half // 3))}


def spill_ids(n: int = 64_000) -> Dict[str, list]:
    """``tests/test_spill.py::test_sharded_spill_equals_single_device``:
    nulls, and int64.max keys on the sentinel's lane."""
    rng = np.random.default_rng(21)
    ids = rng.integers(0, 40_000, n, dtype=np.int64)
    ids[::513] = np.iinfo(np.int64).max
    vals = ids.astype(object)
    vals[::97] = None
    return {"id": list(vals)}


def spill_where(n: int = 16_000) -> Dict[str, list]:
    """``tests/test_spill.py::test_sharded_spill_with_where_filter``."""
    rng = np.random.default_rng(33)
    return {"id": list(rng.integers(0, 4_000, n, dtype=np.int64)),
            "flag": list(rng.integers(0, 2, n, dtype=np.int64))}


def spill_persist(n: int = 8_000) -> Dict[str, list]:
    """``tests/test_spill.py::test_sharded_state_persists_and_reloads``."""
    rng = np.random.default_rng(41)
    return {"id": list(rng.integers(0, 2_000, n, dtype=np.int64))}


def joint_ab(n: int = 24_000) -> Dict[str, list]:
    """``tests/test_spill.py::test_meshed_joint_spill_equals_host``."""
    rng = np.random.default_rng(41)
    a = rng.integers(0, 3_000, n, dtype=np.int64)
    b = np.where(rng.random(n) < 0.5, a, rng.integers(0, 3_000, n))
    return {"a": list(a), "b": list(b)}


def one_pass(n: int = 40_000) -> Dict[str, list]:
    """``tests/test_one_pass_spill.py::TestDifferentialMesh``."""
    rng = np.random.default_rng(9)
    return {"id": rng.integers(0, 2**40, n).tolist(), "x": rng.normal(size=n).tolist()}


def cross_host(n: int = 200_000) -> Dict[str, Any]:
    """``examples/multihost_grouping.py`` at a CPU size: a high-cardinality
    int64 key, float64 keys, and a constant (float64) key."""
    rng = np.random.default_rng(5)
    return {
        "k": rng.integers(0, 4 * n, n, dtype=np.int64),
        "f": np.round(rng.normal(0.0, 1e3, n), 1),
        # a float column: no integral range sends it to the dense path
        "c": np.full(n, 7.5),
    }


DATA = {f.__name__: f for f in (mixed, big_numeric, grouping_gh, sketches, profile_like,
                                widened_gate, spill_ids, spill_where, spill_persist,
                                joint_ab, one_pass, cross_host)}


def data_of(spec) -> Dict[str, Any]:
    """``(builder name, kwargs)`` -> the builder's columns."""
    name, kwargs = spec
    return DATA[name](**kwargs)


# -- values that both packages' metrics reduce to --------------------------


def encode(value) -> Any:
    """A metric's value as plain Python: a number; a distribution as
    ``("dist", {label: absolute}, bins)``; a failure as ``("failure",
    message)``; anything else as its ``str``."""
    if hasattr(value, "is_success"):
        if not value.is_success:
            return ("failure", type(value.exception).__name__)
        value = value.get()
    if isinstance(value, (bool, int, float, np.integer, np.floating)):
        return float(value)
    if hasattr(value, "number_of_bins") and hasattr(value, "values"):
        return ("dist", {str(k): int(v.absolute) for k, v in value.values.items()},
                int(value.number_of_bins))
    if isinstance(value, dict):
        return {str(k): float(v) for k, v in value.items()}
    return str(value)


def make_analyzers(package, specs: Sequence[Spec]) -> List[Any]:
    """Analyzers of ``package`` (the port's top module, or the JAX
    package's ``analyzers``) from ``(name, args, kwargs)`` specs."""
    return [getattr(package, name)(*args, **kwargs) for name, args, kwargs in specs]


# -- rank bodies ------------------------------------------------------------


def _engine(mesh, **kwargs):
    from deequ_tpu_torch.engine import AnalysisEngine

    return AnalysisEngine(device="cpu", mesh=mesh, **kwargs)


def _dataset(source):
    import deequ_tpu_torch as dq

    if isinstance(source, str):
        return dq.Dataset.from_parquet(source)
    return dq.Dataset.from_pydict(data_of(source))


def rank_analysis(rank, world, mesh, source, specs, opts=None, engine_kwargs=None,
                  persist_dir=None):
    """One ``AnalysisRunner`` run on the mesh: every metric encoded, the
    run's events, and the engine's counters."""
    import deequ_tpu_torch as dq
    from deequ_tpu_torch import config

    analyzers = make_analyzers(dq, specs)
    engine = _engine(mesh, **(engine_kwargs or {}))
    kwargs = {}
    if persist_dir is not None:
        kwargs["save_states_with"] = dq.FileSystemStateProvider(persist_dir)
    with config.configure(**(opts or {})):
        ctx = dq.AnalysisRunner.do_analysis_run(_dataset(source), analyzers, engine=engine,
                                                **kwargs)
    return {
        "metrics": [encode(ctx.metric(a).value) for a in analyzers],
        "events": list(ctx.run_metadata.events),
        "data_passes": engine.data_passes,
        "passes": [(p.name, p.rows) for p in ctx.run_metadata.passes],
        "phase_times": dict(engine.phase_times or {}),
    }


def rank_frequencies(rank, world, mesh, source, columns, opts=None):
    """``compute_many_frequencies`` of one plan on the mesh: the path the
    planner took, the groups as {key: count} (a collective read on every
    rank) and the count scalars."""
    from deequ_tpu_torch import config
    from deequ_tpu_torch.analyzers.grouping import FrequencyPlan, compute_many_frequencies

    plan = FrequencyPlan(tuple(columns), None, False)
    events: List[dict] = []
    with config.configure(**(opts or {})):
        state = compute_many_frequencies(_dataset(source), [plan], engine=_engine(mesh),
                                         events=events)[plan]
    groups = {tuple(k): int(c) for k, c in zip(state.keys.tolist(), state.counts.tolist())}
    return {"paths": [e.get("path") for e in events if e.get("event") == "grouping_spill"],
            "groups": groups, "num_groups": state.num_groups, "num_rows": state.num_rows,
            "type": type(state).__name__}


def rank_profile(rank, world, mesh, source):
    """``ColumnProfilerRunner`` on the mesh: each column's profile fields."""
    import deequ_tpu_torch as dq

    profiles = dq.ColumnProfilerRunner().on_data(_dataset(source)).with_engine(
        _engine(mesh)).run()
    out = {"num_records": profiles.num_records}
    for column, p in profiles.profiles.items():
        fields = {
            "completeness": p.completeness,
            "approx_distinct": p.approximate_num_distinct_values,
            "data_type": p.data_type.value,
            "histogram": None if p.histogram is None else encode(p.histogram),
        }
        for name in ("mean", "maximum", "minimum", "sum", "std_dev", "approx_percentiles"):
            if hasattr(p, name):
                fields[name] = getattr(p, name)
        out[column] = fields
    return out


def rank_suite(rank, world, mesh, source, repo_dir):
    """A ``VerificationSuite`` with a multi-constraint check on the mesh,
    saving its metrics to a repository (rank 0 writes once)."""
    import deequ_tpu_torch as dq

    repo = dq.FileSystemMetricsRepository(repo_dir + "/metrics.json")
    check = (dq.Check(dq.CheckLevel.ERROR, "mesh")
             .has_size(lambda s: s == 40_000)
             .is_complete("y")
             .has_mean("y", lambda m: -1.1 < m < -0.9)
             .has_uniqueness(["k"], lambda u: u < 0.5)
             .has_approx_count_distinct("k", lambda d: d > 10_000)
             .is_contained_in("s", ["red", "green", "blue", "17", ""]))
    result = (dq.VerificationSuite().on_data(_dataset(source)).add_check(check)
              .with_engine(_engine(mesh)).use_repository(repo)
              .save_or_append_result(dq.ResultKey.of(1, {"rank": "all"})).run())
    return {"status": str(result.status),
            "constraints": [(r["constraint"], r["constraint_status"])
                            for r in result.check_results_as_records()],
            "metrics": {repr(a): encode(m.value) for a, m in result.metrics.items()}}


def rank_tree_merge(rank, world, mesh, parts):
    """Each rank folds its own datasets' states, then ``monoid_all_reduce``
    merges the ranks' (``tests/test_mesh.py::test_incremental_tree_
    merge_many_states`` over a mesh): the merged metrics."""
    import deequ_tpu_torch as dq
    from deequ_tpu_torch.engine import AnalysisEngine, monoid_all_reduce

    analyzers = [dq.Size(), dq.Mean("x"), dq.Sum("x"), dq.Maximum("x")]
    one = AnalysisEngine(device="cpu")
    states = None
    for i in parts[rank]:
        ds = dq.Dataset.from_pydict({"x": list(np.arange(i * 10.0, i * 10.0 + 10.0))})
        provider = dq.InMemoryStateProvider()
        dq.AnalysisRunner.do_analysis_run(ds, analyzers, engine=one, save_states_with=provider)
        mine = [provider.load(a) for a in analyzers]
        states = mine if states is None else [type(a).merge(a, b) for a, b in zip(states, mine)]
    ctx = _engine(mesh).mesh_context
    merged = monoid_all_reduce(states, [type(s).merge for s in states], ctx)
    return [encode(a.compute_metric_from_state(s).value) for a, s in zip(analyzers, merged)]


def rank_multihost_spill(rank, world, mesh, shard_paths, columns, where=None):
    """``multihost_spill_frequencies`` of each column over this rank's OWN
    parquet shard: the count scalars, Histogram's top groups and the
    whole groups read on every rank (the collective contract)."""
    import deequ_tpu_torch as dq
    from deequ_tpu_torch.analyzers.grouping import FrequencyPlan
    from deequ_tpu_torch.analyzers.spill import multihost_spill_frequencies

    ds = dq.Dataset.from_parquet(shard_paths[rank])
    engine = _engine(mesh)
    out = {}
    for column, include_nulls in ((c, n) for c in columns for n in (False, True)):
        state = multihost_spill_frequencies(ds, FrequencyPlan((column,), where, include_nulls),
                                            mesh, engine=engine)
        keys, counts = state.top_groups(12)
        out[column, include_nulls] = {
            "type": type(state).__name__,
            "num_groups": state.num_groups, "num_rows": state.num_rows,
            "unique": state.count_unique_groups(), "entropy": state.entropy_nats(),
            "top": [(None if k is None else float(k), int(c)) for k, c in zip(keys, counts)],
            "groups": dict(zip((float(k[0]) if k[0] is not None else None
                                for k in state.keys.tolist()), state.counts.tolist())),
        }
    return out


def rank_failure(rank, world, mesh, source, specs, opts=None, fail_rank=None,
                 predicate=None):
    """A run that must raise on EVERY rank: the exception each rank saw.
    With ``predicate``, the where-predicate ``predicate`` fails to compile
    on ``fail_rank`` only (as a shard's own dictionaries can make it)."""
    import deequ_tpu_torch as dq
    from deequ_tpu_torch import config
    from deequ_tpu_torch.sql import predicate as predicate_mod

    if predicate is not None and rank == fail_rank:
        real = predicate_mod.compile_predicate

        def compile_predicate(expression, dataset, *a, **k):
            if expression == predicate:
                raise ValueError(f"cannot compile {expression!r} against this shard")
            return real(expression, dataset, *a, **k)

        predicate_mod.compile_predicate = compile_predicate
        # the analyzers' modules bound the name at import
        for name, module in list(sys.modules.items()):
            if name.startswith("deequ_tpu_torch.") and getattr(
                    module, "compile_predicate", None) is real:
                module.compile_predicate = compile_predicate
    try:
        with config.configure(**(opts or {})):
            dq.AnalysisRunner.do_analysis_run(_dataset(source), make_analyzers(dq, specs),
                                              engine=_engine(mesh))
    except Exception as exc:  # noqa: BLE001 — the test reads it
        return (type(exc).__name__, str(exc))
    return None


def rank_scan_fault(rank, world, mesh, source, specs):
    """Rank 1's updates raise from its second batch on; every rank's
    encoded metrics."""
    import deequ_tpu_torch as dq
    from deequ_tpu_torch.analyzers.base import ScanOps

    if rank == 1:
        real = ScanOps.apply_update
        seen = {"n": 0}

        def apply_update(self, state, batch, consts):
            seen["n"] += 1
            if seen["n"] > len(specs):
                raise RuntimeError("a corrupt batch on rank 1")
            return real(self, state, batch, consts)

        ScanOps.apply_update = apply_update
    analyzers = make_analyzers(dq, specs)
    ctx = dq.AnalysisRunner.do_analysis_run(_dataset(source), analyzers,
                                            engine=_engine(mesh, batch_size=1_000))
    return [encode(ctx.metric(a).value) for a in analyzers]


def rank_imports(rank, world, mesh):
    """The modules of the JAX package or of jax a rank holds after a
    mesh run."""
    rank_analysis(rank, world, mesh, ("big_numeric", {"n": 1000}),
                  [("Size", (), {}), ("Mean", ("x",), {})])
    return sorted(m for m in sys.modules
                  if m in ("jax", "jaxlib", "deequ_tpu") or m.startswith(("jax.", "jaxlib.",
                                                                          "deequ_tpu.")))
