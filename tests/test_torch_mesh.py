"""The port's ``dp`` mesh against the JAX package's mesh and one device.

Each test spawns W ranks of CPU torch over gloo
(``deequ_tpu_torch.testing.mesh.run_ranks``, every group under a 120 s
join timeout), runs the same analyzers on the same seeded data in every
rank (``tests/test_torch_mesh_ranks.py``), and holds every rank's result
against the JAX package's 8-device ``cpu_mesh`` run and its one-device
run, in this process:

- counts, HLL estimates (registers), histogram and DataType counts and
  min/max are equal;
- float states are within 1e-12 relative (float64);
- quantiles are within 0.02 of their target rank (the envelope of
  ``tests/test_mesh.py``), as a KLL sketch merged over ranks is another
  valid sketch than one device's.

Every rank must return the same result, bit for bit: the states are
merged once, in rank order, by each state's own ``merge``.
"""

import os

import numpy as np
import pytest

import test_torch_mesh_ranks as R
from deequ_tpu_torch.testing.mesh import run_ranks

TIMEOUT = 120.0
REL = 1e-12
QUANTILE_RANK_BOUND = 0.02
FLOAT_STATES = {"Mean", "Sum", "StandardDeviation", "Correlation", "Entropy",
                "MutualInformation", "CustomSql"}
QUANTILES = {"ApproxQuantile"}


def spec(name, *args, **kwargs):
    return (name, args, kwargs)


def reference(source, specs, engine=None, **options):
    """The JAX package's encoded metrics of ``specs`` over ``source``."""
    import deequ_tpu
    from deequ_tpu import analyzers as ref_analyzers
    from deequ_tpu import config as ref_config

    analyzers = R.make_analyzers(ref_analyzers, specs)
    ds = (deequ_tpu.Dataset.from_parquet(source) if isinstance(source, str)
          else deequ_tpu.Dataset.from_pydict(R.data_of(source)))
    with ref_config.configure(**options):
        ctx = ref_analyzers.AnalysisRunner.do_analysis_run(
            ds, analyzers, **({"engine": engine} if engine is not None else {}))
    return [R.encode(ctx.metric(a).value) for a in analyzers]


def quantile_rank(values: np.ndarray, q: float) -> float:
    srt = np.sort(values[~np.isnan(values)])
    return np.searchsorted(srt, q) / len(srt)


def assert_same_metrics(specs, got, want, column_values=None, label=""):
    for (name, args, _kw), g, w in zip(specs, got, want):
        what = (label, name, args, g, w)
        if name in QUANTILES:
            target = args[1]
            values = np.asarray(column_values[args[0]], dtype=np.float64)
            assert abs(quantile_rank(values, g) - target) < QUANTILE_RANK_BOUND, what
            assert abs(quantile_rank(values, w) - target) < QUANTILE_RANK_BOUND, what
        elif name in FLOAT_STATES and isinstance(w, float):
            assert g == pytest.approx(w, rel=REL, abs=1e-12), what
        else:
            assert g == w, what


def column_values(source):
    out = {}
    for k, v in R.data_of(source).items():
        arr = np.asarray([np.nan if e is None else e for e in v], dtype=object)
        try:
            out[k] = arr.astype(np.float64)
        except (TypeError, ValueError):
            pass
    return out


def mesh_run(world, source, specs, **kwargs):
    results = run_ranks(R.rank_analysis, world, source, specs, *(
        [kwargs.get("opts"), kwargs.get("engine_kwargs"), kwargs.get("persist_dir")]),
        timeout=TIMEOUT)
    first = results[0]["metrics"]
    for r in results[1:]:
        assert r["metrics"] == first  # every rank holds the same bits
    return results


SCALARS = [spec("Size"), spec("Completeness", "x"), spec("Mean", "x"), spec("Sum", "x"),
           spec("Minimum", "x"), spec("Maximum", "x"), spec("StandardDeviation", "x")]


@pytest.mark.parametrize("world", [2, 3])
def test_mesh_equals_single_device(world, cpu_mesh):
    """``tests/test_mesh.py:35``: scalars over 50,000 rows (3 ranks do not
    divide them evenly)."""
    from deequ_tpu.engine import AnalysisEngine

    source = ("big_numeric", {"n": 50_000})
    results = mesh_run(world, source, SCALARS, engine_kwargs={"batch_size": 8_192})
    got = results[0]["metrics"]
    assert_same_metrics(SCALARS, got, reference(source, SCALARS), label="one device")
    assert_same_metrics(SCALARS, got, reference(
        source, SCALARS, AnalysisEngine(mesh=cpu_mesh, batch_size=8_192)), label="jax mesh")
    phases = [e for e in results[0]["events"] if e["event"] == "scan_phases"]
    assert phases and phases[0]["placement"] == f"mesh{world}"
    assert results[0]["passes"] == [("scan", 50_000)]  # the whole table's rows
    assert phases[0]["merge_s"] >= 0 and phases[0]["merge_bytes"] > 0


def test_mesh_grouping_equals_single_device(cpu_mesh):
    """``tests/test_mesh.py:72``: dense grouping over the mesh; the ranks
    share the table's dictionaries, so the counts add up."""
    from deequ_tpu.engine import AnalysisEngine

    source = ("grouping_gh", {})
    specs = [spec("CountDistinct", "g"), spec("Uniqueness", "g"), spec("Histogram", "h")]
    got = mesh_run(2, source, specs, engine_kwargs={"batch_size": 8_192})[0]["metrics"]
    assert_same_metrics(specs, got, reference(source, specs))
    assert_same_metrics(specs, got, reference(
        source, specs, AnalysisEngine(mesh=cpu_mesh, batch_size=8_192)))


def test_mesh_sketches_equal_single_device(cpu_mesh):
    """``tests/test_mesh.py:98``: HLL (numeric and string), DataType and
    CustomSql equal; the quantile within its rank bound."""
    from deequ_tpu.engine import AnalysisEngine

    source = ("sketches", {})
    specs = [spec("ApproxCountDistinct", "x"), spec("ApproxCountDistinct", "k"),
             spec("ApproxCountDistinct", "s"), spec("DataType", "s"),
             spec("CustomSql", "SUM(x) / COUNT(*)"), spec("ApproxQuantile", "x", 0.5)]
    got = mesh_run(3, source, specs, engine_kwargs={"batch_size": 8_192})[0]["metrics"]
    values = column_values(source)
    assert_same_metrics(specs, got, reference(source, specs), values)
    assert_same_metrics(specs, got, reference(
        source, specs, AnalysisEngine(mesh=cpu_mesh, batch_size=8_192)), values)


def test_tree_merge_of_many_states_over_the_mesh(tmp_path):
    """``tests/test_mesh.py:156``: nine datasets' states, three on each of
    three ranks, merged by ``monoid_all_reduce``, equal the JAX package's
    ``run_on_aggregated_states`` over nine providers."""
    from deequ_tpu import Dataset, FileSystemStateProvider
    from deequ_tpu.analyzers import AnalysisRunner, Maximum, Mean, Size, Sum

    parts = [[0, 3, 6], [1, 4, 7], [2, 5, 8]]
    results = run_ranks(R.rank_tree_merge, 3, parts, timeout=TIMEOUT)
    assert results[0] == results[1] == results[2]
    analyzers = [Size(), Mean("x"), Sum("x"), Maximum("x")]
    providers = []
    for i in range(9):
        p = FileSystemStateProvider(os.path.join(tmp_path, f"s{i}"))
        AnalysisRunner.do_analysis_run(
            Dataset.from_pydict({"x": list(np.arange(i * 10.0, i * 10.0 + 10.0))}),
            analyzers, save_states_with=p)
        providers.append(p)
    schema = Dataset.from_pydict({"x": [1.0]}).schema
    ctx = AnalysisRunner.run_on_aggregated_states(schema, analyzers, providers)
    want = [R.encode(ctx.metric(a).value) for a in analyzers]
    assert results[0][0] == want[0] == 90.0
    assert results[0][1] == pytest.approx(want[1], rel=REL) == 44.5
    assert results[0][2] == pytest.approx(want[2], rel=REL)
    assert results[0][3] == want[3]


MIXED = [spec("Mean", "x"), spec("Sum", "y"), spec("Minimum", "x"), spec("Maximum", "y"),
         spec("StandardDeviation", "x"), spec("Completeness", "x"),
         spec("Correlation", "x", "y"), spec("Compliance", "pos", "x > 5"),
         spec("MinLength", "s"), spec("MaxLength", "s"), spec("DataType", "s"),
         spec("ApproxCountDistinct", "k"), spec("CountDistinct", "k"), spec("Uniqueness", "k")]


@pytest.mark.parametrize("seed", [3, 11])
def test_resident_streaming_mesh_agree(seed, cpu_mesh):
    """``tests/test_differential.py:79``: the same analyzers resident,
    streamed and over the mesh, the mesh's ranks streaming their shares
    (budget 0) on seed 11."""
    from deequ_tpu.engine import AnalysisEngine

    source = ("mixed", {"seed": seed})
    opts = {"device_cache_bytes": 0, "batch_size": 4_096} if seed == 11 else None
    got = mesh_run(2, source, MIXED, opts=opts)[0]["metrics"]
    resident = reference(source, MIXED)
    streaming = reference(source, MIXED, device_cache_bytes=0, batch_size=4_096)
    meshed = reference(source, MIXED, AnalysisEngine(mesh=cpu_mesh, batch_size=8_192))
    for want, label in ((resident, "resident"), (streaming, "streaming"), (meshed, "mesh")):
        assert_same_metrics(MIXED, got, want, label=label)


PALLAS_SET = [spec("ApproxCountDistinct", "x"), spec("ApproxCountDistinct", "y"),
              spec("ApproxCountDistinct", "id"), spec("ApproxQuantile", "x", 0.5),
              spec("ApproxQuantile", "y", 0.5), spec("Mean", "x")]
GATE_SET = [spec("ApproxCountDistinct", "c0"), spec("ApproxCountDistinct", "c1"),
            spec("ApproxQuantile", "c0", 0.5), spec("ApproxQuantile", "c1", 0.5)]


@pytest.mark.parametrize("source,specs,batch", [
    (("profile_like", {}), PALLAS_SET, None),
    (("widened_gate", {}), GATE_SET, 32_768),
], ids=["pallas_scatter", "widened_gate"])
def test_fastpath_sets_on_the_mesh(source, specs, batch, cpu_mesh):
    """``tests/test_fastpath_differential.py:187`` and ``:275``: the K1
    register sets on the mesh (its fused entry on every rank) equal the
    JAX package's mesh and one-device runs; Mean is float32 columns
    summed in float32 a batch, held at 1e-5."""
    from deequ_tpu.engine import AnalysisEngine

    engine_kwargs = {"batch_size": batch} if batch else None
    got = mesh_run(2, source, specs, engine_kwargs=engine_kwargs)[0]["metrics"]
    values = column_values(source)
    for want in (reference(source, specs, **({"batch_size": batch} if batch else {})),
                 reference(source, specs, AnalysisEngine(mesh=cpu_mesh))):
        for (name, args, _), g, w in zip(specs, got, want):
            if name == "Mean":
                assert g == pytest.approx(w, rel=1e-5), (name, g, w)
            elif name in QUANTILES:
                v = np.asarray(values[args[0]], dtype=np.float64)
                assert abs(quantile_rank(v, g) - args[1]) < QUANTILE_RANK_BOUND
            else:
                assert g == w, (name, args, g, w)


@pytest.mark.parametrize("world", [2, 3])
def test_column_profiler_on_the_mesh(world):
    """``ColumnProfilerRunner`` with a mesh engine: every pass merged,
    every rank's profiles equal the JAX package's one-device profile."""
    import deequ_tpu

    source = ("mixed", {"seed": 5, "n": 12_000})
    results = run_ranks(R.rank_profile, world, source, timeout=TIMEOUT)
    assert all(r == results[0] for r in results[1:])
    got = results[0]
    ref = deequ_tpu.ColumnProfilerRunner().on_data(
        deequ_tpu.Dataset.from_pydict(R.data_of(source))).run()
    assert got["num_records"] == ref.num_records == 12_000
    values = column_values(source)
    for column, p in ref.profiles.items():
        g = got[column]
        assert g["completeness"] == p.completeness, column
        assert g["approx_distinct"] == p.approximate_num_distinct_values, column
        assert g["data_type"] == p.data_type.value, column
        assert g["histogram"] == (None if p.histogram is None else R.encode(p.histogram))
        for name in ("mean", "sum", "std_dev"):
            if getattr(p, name, None) is not None:
                assert g[name] == pytest.approx(getattr(p, name), rel=REL), (column, name)
        for name in ("minimum", "maximum"):
            if getattr(p, name, None) is not None:
                assert g[name] == getattr(p, name), (column, name)
        if getattr(p, "approx_percentiles", None):
            v = values[column]
            for q, value in zip(np.arange(1, 101) / 100.0, g["approx_percentiles"]):
                assert abs(quantile_rank(v, value) - q) < QUANTILE_RANK_BOUND, (column, q)


@pytest.mark.parametrize("world", [2, 3])
def test_verification_suite_on_the_mesh(world, tmp_path):
    """``VerificationSuite`` with a mesh engine through ``with_engine``:
    the same constraint results on every rank as the JAX package's run,
    and the repository written once (rank 0), readable by the JAX
    package."""
    import deequ_tpu

    source = ("mixed", {"seed": 3})
    results = run_ranks(R.rank_suite, world, source, str(tmp_path), timeout=TIMEOUT)
    assert all(r == results[0] for r in results[1:])
    got = results[0]
    check = (deequ_tpu.Check(deequ_tpu.CheckLevel.ERROR, "mesh")
             .has_size(lambda s: s == 40_000)
             .is_complete("y")
             .has_mean("y", lambda m: -1.1 < m < -0.9)
             .has_uniqueness(["k"], lambda u: u < 0.5)
             .has_approx_count_distinct("k", lambda d: d > 10_000)
             .is_contained_in("s", ["red", "green", "blue", "17", ""]))
    ref = deequ_tpu.VerificationSuite().on_data(
        deequ_tpu.Dataset.from_pydict(R.data_of(source))).add_check(check).run()
    assert got["status"].split(".")[-1] == str(ref.status).split(".")[-1]
    assert [c[1] for c in got["constraints"]] == [
        r["constraint_status"] for r in ref.check_results_as_records()]
    stored = deequ_tpu.FileSystemMetricsRepository(
        str(tmp_path) + "/metrics.json").load().get()
    assert len(stored) == 1  # one write, by rank 0
