"""The ColumnProfiler of deequ_tpu_torch against the JAX package.

The same seeded numpy/Arrow columns go through ``ColumnProfiler.profile``
of both packages at the same ``batch_size``, so the KLL sketches behind
the percentiles agree bit for bit. Held exactly: the profiled columns
and their order, the record count, completeness, the HLL estimate, the
type and whether it was inferred, the type counts, the histograms (bins
in order, counts, ratios, bin count), min, max, all 99 percentiles and
the KLL bucket distribution; and which passes ran (each pass's name,
rows and analyzer count). Mean, sum and standard deviation agree within
1e-12 relative (float32 columns 1e-5): both sum a batch in their own
order. The fixtures are those of ``tests/test_profiles.py`` (mixed
types, nulls, a numeric string column promoted, mixed strings not
promoted, a bool column, ``restrict_to_columns``, the histogram
threshold, ``kll_profiling``, the empty dataset) and a small table
shaped like TPC-DS ``store_sales`` that runs all three passes.
"""

import math

import numpy as np
import pyarrow as pa
import pytest

import deequ_tpu as R
from deequ_tpu import config as rconfig
from deequ_tpu.profiles.profiler import ColumnProfiler as RProfiler
from deequ_tpu.sketches.kll import KLLParameters as RParams

import deequ_tpu_torch as T
from deequ_tpu_torch import config as tconfig
from deequ_tpu_torch.profiles import ColumnProfilerRunner as TRunner
from deequ_tpu_torch.profiles.profiler import ColumnProfiler as TProfiler

BATCH = 256
RTOL = {"f64": 1e-12, "f32": 1e-5}
FLOAT_STATS = ("mean", "sum", "std_dev")


def _bits(v):
    return np.float64(v).view(np.uint64)


def mixed():
    return {
        "ints": [1, 2, 3, 4, 5, 6],
        "floats": [1.0, 2.0, 3.0, 4.0, 5.0, None],
        "cat": ["a", "b", "a", "a", "b", "a"],
        "numeric_strings": ["1", "2", "3", "4", "5", "6"],
        "mixed_strings": ["x", "2", "y", "z", "w", "v"],
        "flag": [True, False, None, True, True, False],
    }


def store_sales_table(rows=3000, seed=5):
    """store_sales-shaped: int64 keys, int32 quantity (pass 1 histogram),
    float32 and float64 prices, a dictionary-typed category, item ids
    past the histogram threshold, five-digit zip strings (promoted to
    numeric: pass 2) and a two-valued integer column whose range is too
    wide to speculate on (pass 3); about 4% nulls."""
    rng = np.random.default_rng(seed)

    def nulls():
        return rng.random(rows) < 0.04

    cats = np.array(["Books", "Home", "Music", "Shoes"], dtype=object)
    zips = np.array([f"{z:05d}" for z in rng.integers(0, 99999, 300)], dtype=object)
    items = np.array([f"AAAAAAAA{i:08d}" for i in range(800)], dtype=object)
    wholesale = np.round(rng.uniform(1.0, 100.0, rows), 2)
    return pa.table({
        "ss_item_sk": pa.array(rng.integers(1, 800, rows)),
        "ss_ticket_number": pa.array(np.arange(rows, dtype=np.int64) // 12 + 1),
        "ss_quantity": pa.array(rng.integers(1, 101, rows).astype(np.int32), mask=nulls()),
        "ss_wholesale_cost": pa.array(wholesale.astype(np.float32), mask=nulls()),
        "ss_net_profit": pa.array(np.round(rng.normal(0, 500, rows), 2), mask=nulls()),
        "ss_promo_flag": pa.array(rng.choice([0, 1000], rows), mask=nulls()),
        "i_category": pa.DictionaryArray.from_arrays(
            pa.array(rng.integers(0, 4, rows).astype(np.int32), mask=nulls()), pa.array(cats)),
        "i_item_id": pa.array(items[rng.integers(0, 800, rows)]),
        "ca_zip": pa.array(zips[rng.integers(0, 300, rows)], mask=nulls()),
    })


def _profile_both(data, batch=BATCH, **kwargs):
    """(reference profiles, port profiles) of the same columns: ``data``
    is a dict for ``from_pydict`` or an Arrow table."""
    rkw = dict(kwargs)
    tkw = dict(kwargs)
    if "kll_parameters" in kwargs:
        rkw["kll_parameters"] = RParams(**kwargs["kll_parameters"])
        tkw["kll_parameters"] = T.KLLParameters(**kwargs["kll_parameters"])
    arrow = isinstance(data, pa.Table)
    with rconfig.configure(batch_size=batch):
        rds = R.Dataset.from_arrow(data) if arrow else R.Dataset.from_pydict(data)
        ref = RProfiler.profile(rds, **rkw)
    with tconfig.configure(device="cpu", batch_size=batch):
        tds = T.Dataset.from_arrow(data) if arrow else T.Dataset.from_pydict(data)
        port = TProfiler.profile(tds, **tkw)
    return ref, port


def _passes(profiles):
    return [(p["pass"], p["rows"], p["num_analyzers"]) for p in profiles.run_metadata.as_records()]


def assert_histogram_equal(rh, th, key):
    if rh is None:
        assert th is None, key
        return
    assert list(th.values) == list(rh.values), key  # bins in order
    for k, v in rh.values.items():
        assert (th.values[k].absolute, th.values[k].ratio) == (v.absolute, v.ratio), (key, k)
    assert th.number_of_bins == rh.number_of_bins, key


def assert_kll_equal(rk, tk, key):
    if rk is None:
        assert tk is None, key
        return
    assert [(b.low_value, b.high_value, b.count) for b in tk.buckets] == [
        (b.low_value, b.high_value, b.count) for b in rk.buckets
    ], key
    assert tk.parameters == rk.parameters, key
    assert len(tk.data) == len(rk.data), key
    for lr, lt in zip(rk.data, tk.data):
        np.testing.assert_array_equal(np.asarray(lt), np.asarray(lr), err_msg=key)


def assert_profiles_equal(ref, port, float32_columns=()):
    assert port.num_records == ref.num_records
    assert list(port.profiles) == list(ref.profiles)
    assert _passes(port) == _passes(ref)
    for c, rp in ref.profiles.items():
        tp = port.profiles[c]
        assert type(tp).__name__ == type(rp).__name__, c
        assert tp.completeness == rp.completeness, c
        assert _bits(tp.approximate_num_distinct_values) == _bits(
            rp.approximate_num_distinct_values), c
        assert tp.data_type.value == rp.data_type.value, c
        assert tp.is_data_type_inferred == rp.is_data_type_inferred, c
        assert tp.type_counts == rp.type_counts, c
        assert_histogram_equal(rp.histogram, tp.histogram, c)
        if type(rp).__name__ != "NumericColumnProfile":
            continue
        assert (tp.minimum, tp.maximum) == (rp.minimum, rp.maximum), c
        rtol = RTOL["f32" if c in float32_columns else "f64"]
        for stat in FLOAT_STATS:
            want, got = getattr(rp, stat), getattr(tp, stat)
            if want is None:
                assert got is None, (c, stat)
            else:
                assert math.isclose(got, want, rel_tol=rtol, abs_tol=1e-300), (c, stat, got, want)
        if rp.approx_percentiles is None:
            assert tp.approx_percentiles is None, c
        else:
            assert [_bits(v) for v in tp.approx_percentiles] == [
                _bits(v) for v in rp.approx_percentiles], c
        assert_kll_equal(rp.kll, tp.kll, c)


def test_mixed_fixture_matches_reference():
    ref, port = _profile_both(mixed())
    assert_profiles_equal(ref, port)
    # the numeric strings were promoted and the mixed ones not
    assert port["numeric_strings"].data_type == T.data.table.Kind.INTEGRAL
    assert port["mixed_strings"].data_type == T.data.table.Kind.STRING
    assert len(port.run_metadata.passes) == 2


@pytest.mark.parametrize("columns", [["ints"], ["ints", "cat"], ["flag", "numeric_strings"]])
def test_restrict_to_columns_matches_reference(columns):
    ref, port = _profile_both(mixed(), restrict_to_columns=columns)
    assert list(port.profiles) == columns
    assert_profiles_equal(ref, port)


def test_unknown_column_raises_as_reference():
    with tconfig.configure(device="cpu"):
        with pytest.raises(KeyError):
            TProfiler.profile(T.Dataset.from_pydict(mixed()), restrict_to_columns=["nope"])


@pytest.mark.parametrize("threshold", [1, 2, 6, 120])
def test_histogram_threshold_matches_reference(threshold):
    ref, port = _profile_both(mixed(), low_cardinality_histogram_threshold=threshold)
    assert_profiles_equal(ref, port)


@pytest.mark.parametrize("params", [None, {"sketch_size": 64}])
def test_kll_profiling_matches_reference(params):
    data = {"x": list(np.arange(1000.0)), "y": list(np.random.default_rng(3).standard_normal(1000))}
    kwargs = {"kll_profiling": True}
    if params is not None:
        kwargs["kll_parameters"] = params
    ref, port = _profile_both(data, **kwargs)
    assert_profiles_equal(ref, port)
    assert port["x"].kll is not None and len(port["x"].approx_percentiles) == 99


def test_empty_dataset_matches_reference():
    ref, port = _profile_both({"x": []})
    assert_profiles_equal(ref, port)
    assert port.num_records == 0 and port["x"].completeness == 0.0


def test_store_sales_shaped_table_matches_reference():
    ref, port = _profile_both(store_sales_table(), kll_profiling=True)
    assert_profiles_equal(ref, port, float32_columns={"ss_wholesale_cost"})
    # all three passes ran: the promoted zip codes, then the two-valued
    # column whose range is too wide for pass 1
    assert len(port.run_metadata.passes) == 3
    assert port["ca_zip"].is_data_type_inferred and port["ca_zip"].data_type.value == "Integral"
    assert port["ss_quantity"].histogram is not None
    assert port["ss_promo_flag"].histogram is not None
    assert port["i_item_id"].histogram is None


def test_runner_builder_matches_profiler():
    with tconfig.configure(device="cpu", batch_size=BATCH):
        ds = T.Dataset.from_pydict(mixed())
        built = (
            TRunner().on_data(ds).restrict_to_columns(["ints", "cat"])
            .with_low_cardinality_histogram_threshold(1).with_kll_profiling().run()
        )
        direct = TProfiler.profile(
            ds, restrict_to_columns=["ints", "cat"], low_cardinality_histogram_threshold=1,
            kll_profiling=True,
        )
    assert list(built.profiles) == ["ints", "cat"]
    assert built["cat"].histogram is None and built["ints"].kll is not None
    assert built["ints"].approx_percentiles == direct["ints"].approx_percentiles


def test_rerun_on_the_same_dataset_is_identical():
    """A second profile of a dataset reuses its resident columns and
    built dictionaries; the profile is the same."""
    with tconfig.configure(device="cpu", batch_size=BATCH):
        ds = T.Dataset.from_arrow(store_sales_table(1000, seed=2))
        first = TProfiler.profile(ds)
        second = TProfiler.profile(ds)
    assert_profiles_equal(first, second, float32_columns={"ss_wholesale_cost"})
