"""The device-cache budget across datasets (``deequ_tpu_torch/data/table.py``).

The JAX package keeps one process-wide account of the datasets that hold
resident device columns and, before a resident scan copies more, evicts
other datasets' caches, least recently scanned first, then the scanning
dataset's own, until the copy fits ``config.device_cache_bytes``. The
port keeps the same ledger:

- three datasets scanned in turn under a budget that holds two leave the
  same datasets cached in both packages after every scan, and the port's
  ``Dataset.global_device_cache_bytes()`` stays within the budget;
- ``clear_device_cache`` drops every reference to the tensors;
- a view (``select``, ``filter_rows``, ``slice_rows``, ``row_share``)
  keeps its own entry, and evicting it frees nothing its parent holds;
- a dataset whose own earlier columns and new columns do not fit
  together evicts its own cache last;
- a collected dataset leaves the ledger, also when the collector runs
  while the ledger's lock is held.
"""

import gc
import threading
import weakref

import numpy as np
import pytest

import deequ_tpu as R
from deequ_tpu import config as rconfig

import deequ_tpu_torch as T
from deequ_tpu_torch import config as tconfig
from deequ_tpu_torch.analyzers import Mean, Minimum
from deequ_tpu_torch.data import table as ttable

ROWS = 4096
BATCH = 1024
# a resident scan of one dataset keeps 18 bytes a row in the port (x's
# values and mask, k's values, the row mask) and 14 in the JAX package:
# two datasets fit this budget in both, three in neither
BUDGET = 160_000
# scan orders: each step evicts what the least recently scanned rule says
ORDERS = [[0, 1, 2], [0, 1, 2, 0, 2, 1], [2, 2, 0, 1, 0, 2, 1]]


@pytest.fixture(autouse=True)
def _cpu():
    with tconfig.configure(device="cpu"):
        yield


def _data(seed):
    rng = np.random.default_rng(seed)
    values = rng.normal(size=ROWS)
    nulls = rng.random(ROWS) < 0.1
    return {
        "x": [None if null else float(v) for v, null in zip(values, nulls)],
        "k": rng.integers(0, 50, ROWS).tolist(),
    }


def _scan(P, ds, engine):
    return P.AnalysisRunner.do_analysis_run(
        ds, [P.analyzers.Mean("x"), P.analyzers.Completeness("x"), P.analyzers.Maximum("k")],
        engine=engine)


def _cached(datasets):
    return [i for i, ds in enumerate(datasets) if ds._device_cache]


@pytest.mark.parametrize("order", ORDERS, ids=["-".join(map(str, o)) for o in ORDERS])
def test_lru_eviction_matches_reference(order):
    """After every scan the same datasets hold a device cache in both
    packages, and the port's ledger stays within the budget."""
    ref = [R.Dataset.from_pydict(_data(i)) for i in range(3)]
    port = [T.Dataset.from_pydict(_data(i)) for i in range(3)]
    for ds in ref:
        ds.clear_device_cache()
    with rconfig.configure(device_cache_bytes=BUDGET, batch_size=BATCH), \
            tconfig.configure(device_cache_bytes=BUDGET, batch_size=BATCH):
        for step, index in enumerate(order):
            _scan(R, ref[index], R.AnalysisEngine())
            _scan(T, port[index], T.AnalysisEngine())
            assert _cached(port) == _cached(ref), (step, index)
            assert T.Dataset.global_device_cache_bytes() <= BUDGET
            held = sum(ds._device_cache_bytes() for ds in port)
            assert held <= T.Dataset.global_device_cache_bytes()
    assert len(_cached(port)) == min(2, len(set(order)))


def test_metrics_equal_after_eviction():
    """A dataset evicted and scanned again copies its columns anew and
    computes the same metrics."""
    datasets = [T.Dataset.from_pydict(_data(i)) for i in range(3)]
    with tconfig.configure(device_cache_bytes=BUDGET, batch_size=BATCH):
        first = _scan(T, datasets[0], T.AnalysisEngine())
        for ds in datasets[1:]:
            _scan(T, ds, T.AnalysisEngine())
        assert not datasets[0]._device_cache
        before = ttable.transfer_bytes()
        again = _scan(T, datasets[0], T.AnalysisEngine())
        assert ttable.transfer_bytes() - before == datasets[0].estimated_device_bytes(
            [ttable.ColumnRequest("x", "values"), ttable.ColumnRequest("x", "mask"),
             ttable.ColumnRequest("k", "values")]) - ROWS  # the row mask is made there
    for analyzer, metric in first.metric_map.items():
        assert again.metric(analyzer).value.get() == metric.value.get()


def test_ledger_counts_the_estimate():
    """The ledger holds a resident scan's ``estimated_device_bytes``."""
    ds = T.Dataset.from_pydict(_data(7))
    requests = [ttable.ColumnRequest("x", "values"), ttable.ColumnRequest("k", "values")]
    with tconfig.configure(device_cache_bytes=1 << 30, batch_size=BATCH):
        _scan(T, ds, T.AnalysisEngine())
    assert ds._device_cache_bytes() == ds.estimated_device_bytes(requests) == ROWS * 18


def test_clear_frees_every_tensor():
    ds = T.Dataset.from_pydict(_data(3))
    with tconfig.configure(device_cache_bytes=1 << 30, batch_size=BATCH):
        _scan(T, ds, T.AnalysisEngine())
    refs = [weakref.ref(t) for t in ds._device_cache.values()]
    assert refs and all(r() is not None for r in refs)
    total = T.Dataset.global_device_cache_bytes()
    held = ds._device_cache_bytes()
    ds.clear_device_cache()
    gc.collect()
    assert all(r() is None for r in refs)
    assert T.Dataset.global_device_cache_bytes() == total - held
    assert ds._device_cache_bytes() == 0


@pytest.mark.parametrize("view", ["select", "filter_rows", "slice_rows", "row_share"])
def test_view_eviction_spares_parent(view):
    parent = T.Dataset.from_pydict(_data(4))
    make = {
        "select": lambda: parent.select(["x", "k"]),
        "filter_rows": lambda: parent.filter_rows(np.arange(ROWS) % 3 != 0),
        "slice_rows": lambda: parent.slice_rows(100, ROWS - 100),
        "row_share": lambda: parent.row_share(1, 2),
    }[view]
    with tconfig.configure(device_cache_bytes=1 << 30, batch_size=BATCH):
        _scan(T, parent, T.AnalysisEngine())
        child = make()
        _scan(T, child, T.AnalysisEngine())
        assert child._cache_key != parent._cache_key
        assert child._device_cache_bytes() > 0 and parent._device_cache_bytes() > 0
        parent_refs = [weakref.ref(t) for t in parent._device_cache.values()]
        # the view's entries are tensors of its own (on the CPU a copy
        # to "cpu" may share the host array; on the card each is a copy)
        child_ids = {id(t) for t in child._device_cache.values()}
        assert not child_ids & {id(t) for t in parent._device_cache.values()}
        held = parent._device_cache_bytes()
        child.clear_device_cache()
        gc.collect()
        assert all(r() is not None for r in parent_refs)
        assert parent._device_cache_bytes() == held
        before = ttable.transfer_bytes()
        _scan(T, parent, T.AnalysisEngine())
        assert ttable.transfer_bytes() == before


def test_own_cache_evicted_last():
    """A dataset's earlier columns go when they and the new ones do not
    fit together, after every other dataset's."""
    other = T.Dataset.from_pydict(_data(5))
    ds = T.Dataset.from_pydict(_data(6))
    with tconfig.configure(device_cache_bytes=1 << 30, batch_size=BATCH):
        _scan(T, other, T.AnalysisEngine())
        T.AnalysisRunner.do_analysis_run(ds, [Mean("x")], engine=T.AnalysisEngine())
    # x's values and mask and the row mask are resident: 10 bytes a row;
    # k's values need 8 more, and 16 bytes a row are the budget
    with tconfig.configure(device_cache_bytes=ROWS * 16, batch_size=BATCH):
        ctx = T.AnalysisRunner.do_analysis_run(ds, [Minimum("k")], engine=T.AnalysisEngine())
        assert not other._device_cache
        assert set(k for k, _ in ds._device_cache) == {"k::values", ttable.ROW_MASK}
        assert T.Dataset.global_device_cache_bytes() <= ROWS * 16
    assert ctx.metric(Minimum("k")).value.get() == min(_data(6)["k"])


def test_collected_dataset_leaves_ledger():
    ds = T.Dataset.from_pydict(_data(8))
    with tconfig.configure(device_cache_bytes=1 << 30, batch_size=BATCH):
        _scan(T, ds, T.AnalysisEngine())
    key = ds._cache_key
    assert ttable._LEDGER.bytes_of(key) > 0
    del ds
    gc.collect()
    assert ttable._LEDGER.bytes_of(key) == 0
    assert key not in dict(ttable._LEDGER.lru())


def test_a_dataset_collected_inside_a_locked_section_does_not_deadlock():
    """The garbage collector may finalize a dataset while this thread
    holds the ledger's lock (inside ``touch``, say): the finalizer must
    neither wait for that lock nor change the ledger under it."""
    ds = T.Dataset.from_pydict(_data(10))
    with tconfig.configure(device_cache_bytes=1 << 30, batch_size=BATCH):
        _scan(T, ds, T.AnalysisEngine())
    key = ds._cache_key
    ds.cycle = ds  # only the cyclic collector frees it
    del ds

    def collect_under_the_lock():
        with ttable._LEDGER._lock:
            gc.collect()

    worker = threading.Thread(target=collect_under_the_lock, daemon=True)
    worker.start()
    worker.join(30)
    assert not worker.is_alive(), "the finalizer waited for the ledger's lock"
    assert ttable._LEDGER.bytes_of(key) == 0
    assert key not in dict(ttable._LEDGER.lru())


def test_streamed_scan_keeps_nothing():
    ds = T.Dataset.from_pydict(_data(9))
    total = T.Dataset.global_device_cache_bytes()
    with tconfig.configure(device_cache_bytes=0, batch_size=BATCH):
        _scan(T, ds, T.AnalysisEngine())
    assert not ds._device_cache
    assert T.Dataset.global_device_cache_bytes() == total
