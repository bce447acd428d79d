"""K1's codes entry (``scatter_max.hll_update_codes``), on the CPU.

The codes entry takes a batch of dictionary codes, the column masks, an
optional row mask, the dictionaries' hash words and the carried
registers to the new registers in one kernel on the card. Here:

- the port's string HLL registers, built through the engine (stacked
  groups and singles, with and without ``where=``, over several
  batches), equal the JAX package's at D = 16, 4096 (the presence cap)
  and 4097 (the gather branch), exactly;
- a numpy emulation of the kernel's planned partition (each block's
  presence bitmap, set from the rows it reads, then each present entry
  ranked and folded into a copy of the carry; or, in the gather branch,
  each block's register file) equals a per-row numpy reference and the
  entry's plain version; no padded slot is ever set;
- the planner's decisions and its copies of the kernel's constants;
- the wrapper refuses what the kernel does not take before any launch,
  takes its plain version for CPU tensors, and its launch path, run
  against a stand-in for the kernels' library, is one library call into
  a new register file (the launch copies the carry into it), with no
  other PyTorch launch and no host sync;
- every launcher of the port's CUDA sources raises a kernel's shared
  memory limit once per device, not on every launch, and no launch path
  switches the current device when it already is current.
"""

import ast
import contextlib
import re
from pathlib import Path

import numpy as np
import pyarrow as pa
import pytest
import torch

import deequ_tpu as R
from deequ_tpu import config as rconfig
from deequ_tpu.io.state_provider import InMemoryStateProvider
from deequ_tpu.sketches import hll as rhll

import deequ_tpu_torch as T
from deequ_tpu_torch import config as tconfig
from deequ_tpu_torch.sketches import hll as thll
from deequ_tpu_torch.sketches import scatter_max as sm

PACKAGE = Path(sm.__file__).resolve().parents[1]
M = thll.M


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# -- through both engines -----------------------------------------------------


class _Keep:
    def __init__(self):
        self.states = {}

    def persist(self, analyzer, state):
        self.states[repr(analyzer)] = state


def _dictionary_column(rng, rows, d, null_share=0.05):
    """A string column of ``d`` dictionary entries, some unused: codes
    drawn over the first 3/4 of the dictionary, nulls among them."""
    codes = rng.integers(0, max(1, 3 * d // 4), rows).astype(np.int32)
    null = rng.random(rows) < null_share
    dictionary = pa.array([f"v{d}-{i}" for i in range(d)])
    indices = pa.array(codes, mask=null, type=pa.int32())
    return pa.DictionaryArray.from_arrays(indices, dictionary)


@pytest.mark.parametrize("d", [16, 4096, 4097])
@pytest.mark.parametrize("where", [None, "q > 40"], ids=["no_where", "where"])
def test_string_registers_equal_the_reference(d, where):
    """Two string columns stacked into one group, a third single, and a
    numeric column beside them, over three batches (the last ragged)."""
    rng = np.random.default_rng(d)
    rows = 6000
    table = pa.table({
        "s1": _dictionary_column(rng, rows, d),
        "s2": _dictionary_column(rng, rows, d, null_share=0.0),
        "s3": _dictionary_column(rng, rows, d),
        "q": pa.array(rng.integers(0, 100, rows)),
    })
    columns = ["s1", "s2", "s3"]
    rkeep = InMemoryStateProvider()
    with rconfig.configure(batch_size=2500):
        R.AnalysisRunner.do_analysis_run(
            R.Dataset.from_arrow(table),
            [R.ApproxCountDistinct(c, where=where) for c in columns[:2]],
            save_states_with=rkeep,
        )
        R.AnalysisRunner.do_analysis_run(
            R.Dataset.from_arrow(table), [R.ApproxCountDistinct("s3", where=where)],
            save_states_with=rkeep,
        )
    tkeep = _Keep()
    with tconfig.configure(device="cpu", batch_size=2500):
        T.AnalysisRunner.do_analysis_run(
            T.Dataset.from_arrow(table),
            [T.ApproxCountDistinct(c, where=where) for c in columns]
            + [T.ApproxCountDistinct("q")],
            save_states_with=tkeep,
        )
    for c in columns:
        want = np.asarray(rkeep.load(R.ApproxCountDistinct(c, where=where)).registers)
        got = tkeep.states[repr(T.ApproxCountDistinct(c, where=where))].registers.numpy()
        assert want.any()
        np.testing.assert_array_equal(got, want, err_msg=c)


def test_engine_string_updates_take_the_codes_entry(monkeypatch):
    """The engine's string HLL updates, stacked and single, go through
    ``hll_update_codes`` once a batch, and never through the (idx, rho)
    entry."""
    calls = []
    entry = sm.hll_update_codes

    def counted(*args):
        calls.append(args[0].shape)
        return entry(*args)

    monkeypatch.setattr(sm, "hll_update_codes", counted)
    monkeypatch.setattr(sm, "scatter_max_derived", lambda *a: pytest.fail("(idx, rho) entry"))
    data = {"a": ["x", "y", None, "x"] * 5, "b": ["p", "q", "r", "s"] * 5, "c": ["u"] * 20}
    with tconfig.configure(device="cpu", batch_size=8):
        ctx = T.AnalysisRunner.do_analysis_run(
            T.Dataset.from_pydict(data),
            [T.ApproxCountDistinct("a"), T.ApproxCountDistinct("b"),
             T.ApproxCountDistinct("c", where="c = 'u'")],
        )
    assert sorted(calls) == [(1, 4), (1, 8), (1, 8), (2, 4), (2, 8), (2, 8)]
    values = {a.column: ctx.metric(a).value.get() for a in ctx.metric_map}
    assert round(values["a"]) == 2 and round(values["b"]) == 4 and round(values["c"]) == 1


# -- the kernel's partition, emulated -----------------------------------------

THREADS = 256  # the kernel's kThreadsCodes


def _owner_blocks(rows, splits, aligned):
    """Block of each row under the kernel's grid-strided reads: int4
    units (four rows) where the column is aligned, then the ragged tail
    one row a thread; one row a thread everywhere otherwise."""
    stride = splits * THREADS
    block = np.empty(rows, np.int64)
    head = rows // 4 * 4 if aligned else 0
    units = np.arange(head // 4)
    block[:head] = np.repeat(units % stride // THREADS, 4)
    tail = np.arange(rows - head)
    block[head:] = tail % stride // THREADS
    return block


def _emulate(plan, codes, mask, row_mask, lut1, lut2, regs, aligned=True):
    """The codes kernel in numpy: per column, per block, a bitmap of the
    slots its rows set (or, without the bitmap, a register file each row
    ranks into, seeded from ``regs``), then the fold into a copy of
    ``regs``. Returns the registers and every block's set of slots."""
    cols, rows = codes.shape
    d = lut1.shape[1]
    valid = mask if row_mask is None else mask & row_mask[None, :]
    out = regs.copy()
    owner = _owner_blocks(rows, plan.splits, aligned)
    slots_of = []
    for c in range(cols):
        code = codes[c].astype(np.int64)
        if not plan.bitmap:
            slot = np.where(valid[c], np.clip(code, 0, d - 1), -1)
        else:
            slot = np.where(valid[c] & (code >= 0) & (code < d), code, -1)
        k_all = (lut1[c] >> (32 - sm.hll_hash.P)).astype(np.int64)
        r_all = np.array([33 - int(h).bit_length() for h in lut2[c]], np.int64)
        for b in range(plan.splits):
            mine = slot[(owner == b) & (slot >= 0)]
            if plan.bitmap:
                bits = np.zeros((d + 31) // 32, np.uint32)
                np.bitwise_or.at(bits, mine >> 5, (np.uint32(1) << (mine & 31)).astype(np.uint32))
                present = np.flatnonzero(
                    (bits[np.arange(d) >> 5] >> (np.arange(d) & 31).astype(np.uint32)) & 1)
                slots_of.append(set(present.tolist()))
                np.maximum.at(out[c], k_all[present], r_all[present].astype(np.int8))
            else:
                file = regs[c].astype(np.int32)
                np.maximum.at(file, k_all[mine], r_all[mine].astype(np.int32))
                raised = file > regs[c]
                out[c][raised] = np.maximum(out[c][raised], file[raised].astype(np.int8))
                slots_of.append(set(mine.tolist()))
    return out, slots_of


def _row_registers(codes, valid, lut1, lut2, regs):
    """The carry max-merged with every valid row's rank, row by row, in
    numpy: the presence branch's slots up to PRESENCE_DICT_CAP entries
    (codes outside [0, D) count for nothing), clamped codes past it."""
    d = lut1.shape[1]
    out = regs.copy()
    for c in range(codes.shape[0]):
        code = codes[c].astype(np.int64)
        if d <= thll.PRESENCE_DICT_CAP:
            keep = valid[c] & (code >= 0) & (code < d)
        else:
            keep = valid[c]
            code = np.clip(code, 0, d - 1)
        slots = code[keep]
        k = (lut1[c][slots] >> (32 - sm.hll_hash.P)).astype(np.int64)
        r = np.array([33 - int(h).bit_length() for h in lut2[c][slots]], np.int8)
        np.maximum.at(out[c], k, r)
    return out


def _codes_inputs(cols, rows, d_used, seed, pad=True):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, d_used, (cols, rows)).astype(np.int32)
    null = rng.random((cols, rows)) < 0.05
    codes[null] = -1
    mask = ~null & (rng.random((cols, rows)) < 0.97)
    d = 1 << (d_used - 1).bit_length() if pad else d_used
    lut1 = np.zeros((cols, d), np.int64)
    lut2 = np.zeros((cols, d), np.int64)
    lut1[:, :d_used] = rng.integers(0, 1 << 32, (cols, d_used))
    lut2[:, :d_used] = rng.integers(0, 1 << 32, (cols, d_used))
    lut2[:, 0] = 0  # an entry of rank 33
    row_mask = rng.random(rows) < 0.6
    return codes, mask, row_mask, lut1, lut2


@pytest.mark.parametrize("d_used", [10, 16, 3000, 4096, 4097, 100_000])
@pytest.mark.parametrize("rows", [8192 + 3, 1001])
@pytest.mark.parametrize("row_mask", [False, True], ids=["no_row_mask", "row_mask"])
def test_emulated_kernel_equals_the_plain_versions(d_used, rows, row_mask):
    codes, mask, rows_kept, lut1, lut2 = _codes_inputs(2, rows, d_used, d_used + rows)
    rows_kept = rows_kept if row_mask else None
    d = lut1.shape[1]
    regs = np.random.default_rng(1).integers(0, 20, (2, M)).astype(np.int8)
    valid = mask if rows_kept is None else mask & rows_kept[None, :]
    want = _row_registers(codes, valid, lut1, lut2, regs)
    plain = sm.hll_update_codes_plain(
        _t(codes), _t(mask), None if rows_kept is None else _t(rows_kept), _t(lut1), _t(lut2),
        _t(regs))
    np.testing.assert_array_equal(plain.numpy(), want)
    for sms in (132, 7):
        plan = sm.plan_codes(2, rows, d, sms)
        assert plan.bitmap == (d <= thll.PRESENCE_DICT_CAP)
        for aligned in (True, False):
            got, slots = _emulate(plan, codes, mask, rows_kept, lut1, lut2, regs, aligned)
            np.testing.assert_array_equal(got, want)
            # no code points at a padded slot, so none is ever set
            assert all(max(s, default=-1) < d_used for s in slots)


def test_emulated_presence_sets_exactly_the_valid_codes():
    codes, mask, rows_kept, lut1, lut2 = _codes_inputs(1, 4000, 16, 3)
    codes[0, :8] = [15, 15, 20, -1, -7, 3, 3, 3]  # out of range and null codes
    mask[0, :8] = True
    plan = sm.plan_codes(1, 4000, 16, 1)
    assert plan.splits == 1 and plan.bitmap
    _, [slots] = _emulate(plan, codes, mask, rows_kept, lut1, lut2, np.zeros((1, M), np.int8))
    valid = mask[0] & rows_kept & (codes[0] >= 0) & (codes[0] < 16)
    assert slots == set(codes[0][valid].tolist())


# -- the planner --------------------------------------------------------------


def test_planner_constants_equal_the_kernels():
    source = sm.SOURCE.read_text()

    def constant(name):
        found = re.search(rf"constexpr int {name} = ([0-9 *<]+);", source)
        assert found, name
        return eval(found.group(1), {})  # integer literals, * and <<

    assert constant("kCodesBlocksPerSm") == sm.CODES_BLOCKS_PER_SM
    # the kernel's bitmap form ends where the presence branch ends
    assert constant("kMaxBitmapEntries") == thll.PRESENCE_DICT_CAP
    assert constant("kThreadsCodes") == THREADS
    # a bitmap fits the default 48 KB of dynamic shared memory, so its
    # launcher raises no limit
    assert thll.PRESENCE_DICT_CAP // 8 <= 48 * 1024


@pytest.mark.parametrize("cols", [1, 3, 40, 300])
@pytest.mark.parametrize("rows", [1, 4096, 1 << 21, (1 << 21) + 12345])
@pytest.mark.parametrize("d", [1, 16, 4096, 4097, 100_000, 1 << 20])
def test_plan_codes(cols, rows, d):
    p = sm.plan_codes(cols, rows, d, 132)
    assert p.bitmap == (d <= thll.PRESENCE_DICT_CAP)
    assert 1 <= p.splits <= max(1, sm.CODES_BLOCKS_PER_SM * 132 // cols)
    min_rows = sm.MIN_ROWS_PER_CODES_BLOCK if p.bitmap else sm.MIN_ROWS_PER_BLOCK
    assert p.splits == 1 or rows / p.splits >= min_rows * 0.99


def test_plan_codes_at_the_main_path_shape():
    assert sm.plan_codes(1, 1 << 21, 16, 132) == sm.CodesPlan(512, True)  # 4096 rows a block
    assert sm.plan_codes(1, 1 << 21, 4096, 132) == sm.CodesPlan(512, True)
    assert sm.plan_codes(3, 1 << 21, 16, 132) == sm.CodesPlan(176, True)  # 4 blocks an SM
    assert sm.plan_codes(3, 1 << 21, 4097, 132) == sm.CodesPlan(128, False)  # 2^14 rows a block
    assert sm.plan_codes(3, 1 << 21, 100_000, 132) == sm.CodesPlan(128, False)
    with pytest.raises(ValueError):
        sm.plan_codes(1, 10, 0, 132)


# -- the wrapper --------------------------------------------------------------


def _ok_codes_args(cols=2, rows=64, d=16):
    codes, mask, row_mask, lut1, lut2 = _codes_inputs(cols, rows, d, 5)
    regs = _t(np.zeros((cols, M), np.int8))
    return _t(codes), _t(mask), _t(row_mask), _t(lut1), _t(lut2), regs


BAD_CODES_ARGS = {
    "codes int64": (lambda c, m, r, a, b, g: (c.long(), m, r, a, b, g), TypeError),
    "mask int8": (lambda c, m, r, a, b, g: (c, m.to(torch.int8), r, a, b, g), TypeError),
    "row_mask int32": (lambda c, m, r, a, b, g: (c, m, r.int(), a, b, g), TypeError),
    "lut int32": (lambda c, m, r, a, b, g: (c, m, r, a.int(), b.int(), g), TypeError),
    "registers int32": (lambda c, m, r, a, b, g: (c, m, r, a, b, g.int()), TypeError),
    "1-D codes": (lambda c, m, r, a, b, g: (c[0], m[0], r, a, b, g), ValueError),
    "no columns": (lambda c, m, r, a, b, g: (c[:0], m[:0], r, a[:0], b[:0], g[:0]), ValueError),
    "mask shape mismatch": (
        lambda c, m, r, a, b, g: (c, m[:, :10].contiguous(), r, a, b, g), ValueError),
    "row_mask wrong length": (
        lambda c, m, r, a, b, g: (c, m, r[:10].contiguous(), a, b, g), ValueError),
    "lut columns differ": (lambda c, m, r, a, b, g: (c, m, r, a[:1], b[:1], g), ValueError),
    "luts differ in width": (
        lambda c, m, r, a, b, g: (c, m, r, a, b[:, :8].contiguous(), g), ValueError),
    "empty dictionary": (
        lambda c, m, r, a, b, g: (c, m, r, a[:, :0], b[:, :0], g), ValueError),
    "registers too few": (
        lambda c, m, r, a, b, g: (c, m, r, a, b, g[:, :100].contiguous()), ValueError),
    "non-contiguous codes": (
        lambda c, m, r, a, b, g: (c.t().contiguous().t(), m, r, a, b, g), ValueError),
    "meta device": (lambda c, m, r, a, b, g: tuple(
        t.to("meta") for t in (c, m, r, a, b, g)), ValueError),
    "devices differ": (lambda c, m, r, a, b, g: (c, m, r, a.to("meta"), b, g), ValueError),
}


@pytest.mark.parametrize("case", sorted(BAD_CODES_ARGS))
def test_hll_update_codes_refuses_bad_arguments_before_any_launch(case, monkeypatch):
    calls = []
    monkeypatch.setattr(sm, "_launch_codes", lambda *a: calls.append("kernel"))
    monkeypatch.setattr(sm, "hll_update_codes_plain", lambda *a: calls.append("plain"))
    make, exc = BAD_CODES_ARGS[case]
    launches = sm.codes_launches
    with pytest.raises(exc):
        sm.hll_update_codes(*make(*_ok_codes_args()))
    assert calls == [] and sm.codes_launches == launches


@pytest.mark.parametrize("row_mask", [True, False], ids=["row_mask", "no_row_mask"])
def test_hll_update_codes_on_cpu_is_the_plain_version(row_mask):
    codes, mask, rows, lut1, lut2, regs = _ok_codes_args()
    rows = rows if row_mask else None
    counts = (sm.launches, sm.fused_launches, sm.codes_launches)
    out = sm.hll_update_codes(codes, mask, rows, lut1, lut2, regs)
    assert out.dtype == torch.int8 and out.shape == regs.shape and out.any()
    assert torch.equal(out, sm.hll_update_codes_plain(codes, mask, rows, lut1, lut2, regs))
    assert (sm.launches, sm.fused_launches, sm.codes_launches) == counts


class _Library:
    """A stand-in for the kernels' library: records each launch and
    returns ``err``."""

    def __init__(self, err=0):
        self.err = err
        self.calls = []

    def __getattr__(self, name):
        if name == "hll_cuda_error_string":
            return lambda err: b"stand-in error"

        def launch(*args):
            self.calls.append((name, args))
            return self.err

        return launch


def _refuse(name):
    def refused(*args, **kwargs):
        raise AssertionError(f"the launch path called {name}")

    return refused


@pytest.fixture
def stand_in(monkeypatch):
    """The codes entry's launch path on CPU tensors, against a stand-in
    library: the device current, stream 0, a 132-SM card, and every
    PyTorch call that would add a launch or a host sync refused."""
    lib = _Library()
    monkeypatch.setattr(sm, "_library", lambda: lib)
    monkeypatch.setattr(tconfig, "on_device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(tconfig, "sm_count", lambda device: 132)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: type(
        "S", (), {"cuda_stream": 0})())
    for name in ("zeros", "zeros_like", "maximum", "cat", "arange"):
        monkeypatch.setattr(torch, name, _refuse(f"torch.{name}"))
    monkeypatch.setattr(torch.Tensor, "clone", _refuse("Tensor.clone"))
    monkeypatch.setattr(torch.cuda, "synchronize", _refuse("torch.cuda.synchronize"))
    monkeypatch.setattr(torch.Tensor, "item", _refuse("Tensor.item"))
    monkeypatch.setattr(torch.Tensor, "tolist", _refuse("Tensor.tolist"))
    monkeypatch.setattr(sm, "codes_launches", 0)
    return lib


@pytest.mark.parametrize("d", [16, 100_000])
def test_launch_path_is_one_library_call_into_a_new_register_file(stand_in, d):
    codes, mask, rows, _, _, regs = _ok_codes_args(rows=1000)
    lut1, lut2 = _t(np.zeros((2, d), np.int64)), _t(np.zeros((2, d), np.int64))
    regs += 3
    out = sm._launch_codes(codes, mask, rows, lut1, lut2, regs)
    [(name, args)] = stand_in.calls
    assert name == "hll_update_codes_launch"
    p = sm.plan_codes(2, 1000, d, 132)
    assert args[:7] == (codes.data_ptr(), mask.data_ptr(), rows.data_ptr(), lut1.data_ptr(),
                        lut2.data_ptr(), regs.data_ptr(), out.data_ptr())
    # a new tensor, which the launch fills with a copy of the carry
    assert out.data_ptr() != regs.data_ptr()
    assert (out.shape, out.dtype, out.device) == (regs.shape, regs.dtype, regs.device)
    assert args[7:] == (2, 1000, d, sm.hll_hash.P, p.splits, 0)
    assert sm.codes_launches == 1


def test_launch_path_passes_no_row_mask_as_null_and_no_rows_launches_nothing(stand_in):
    codes, mask, _, lut1, lut2, regs = _ok_codes_args(rows=100)
    sm._launch_codes(codes, mask, None, lut1, lut2, regs)
    assert stand_in.calls[0][1][2] is None
    with pytest.raises(AssertionError, match="Tensor.clone"):  # no rows: a copy of the carry
        sm._launch_codes(codes[:, :0], mask[:, :0], None, lut1, lut2, regs)
    assert len(stand_in.calls) == 1 and sm.codes_launches == 1


def test_a_failed_launch_raises_and_is_not_counted(stand_in):
    stand_in.err = 1
    with pytest.raises(RuntimeError, match="hll_update_codes kernel launch failed"):
        sm._launch_codes(*_ok_codes_args())
    assert len(stand_in.calls) == 1 and sm.codes_launches == 0


def test_no_fallback_around_the_codes_kernel():
    functions = {
        n.name: ast.unparse(n)
        for n in ast.walk(ast.parse(Path(sm.__file__).read_text()))
        if isinstance(n, ast.FunctionDef)
    }
    assert (
        "if codes.device.type == 'cuda':\n"
        "        return _launch_codes(codes, mask, row_mask, lut1, lut2, registers)\n"
        "    return hll_update_codes_plain(codes, mask, row_mask, lut1, lut2, registers)"
    ) in functions["hll_update_codes"]


# -- attributes once per device; no device switch when current ---------------

ALLOWED_SETTERS = {"set_smem_once", "configure_once", "gmin_configure_once"}


@pytest.mark.parametrize("source", ["scatter_max.cu", "scatter_probe.cu"])
def test_function_attributes_are_set_once_per_device(source):
    """Every cudaFuncSetAttribute of the sources sits in a function that
    returns early once its device is configured."""
    text = (PACKAGE / "csrc" / source).read_text()
    bodies = re.split(r"\n(?=\S)", text)  # top-level declarations
    found = 0
    for body in bodies:
        if "cudaFuncSetAttribute(" not in body:
            continue
        name = re.search(r"(\w+)\(", body.split("{")[0]).group(1)
        assert name in ALLOWED_SETTERS, (source, name)
        assert "if (configured[dev]) return cudaSuccess;" in body, name
        found += body.count("cudaFuncSetAttribute(")
    assert found >= 1


def test_on_device_switches_only_when_another_device_is_current(monkeypatch):
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    assert isinstance(tconfig.on_device(torch.device("cuda", 1)), contextlib.nullcontext)
    assert isinstance(tconfig.on_device(torch.device("cuda")), contextlib.nullcontext)
    assert isinstance(tconfig.on_device(torch.device("cuda", 0)), torch.cuda.device)


def test_no_launch_path_enters_torch_cuda_device():
    users = [
        str(p.relative_to(PACKAGE))
        for p in PACKAGE.rglob("*.py")
        if "torch.cuda.device(" in p.read_text()
    ]
    assert users == ["config.py"]


@pytest.mark.parametrize("d, rows_form", [(16, 0), (4096, 0), (4097, 1), (100_000, 1)])
def test_rows_form_launches_are_counted_apart(stand_in, monkeypatch, d, rows_form):
    monkeypatch.setattr(sm, "codes_rows_launches", 0)
    codes, mask, rows, _, _, regs = _ok_codes_args(rows=1000)
    lut1, lut2 = _t(np.zeros((2, d), np.int64)), _t(np.zeros((2, d), np.int64))
    sm._launch_codes(codes, mask, rows, lut1, lut2, regs)
    assert sm.plan_codes(2, 1000, d, 132).bitmap == (not rows_form)
    assert (sm.codes_launches, sm.codes_rows_launches) == (1, rows_form)
