"""The port's wire codecs (``deequ_tpu_torch/engine/wire.py``) against the
JAX package's ``engine/wire.py``.

Both modules are numpy on the host. On the same inputs they must make
the same decisions and produce the same bytes, exactly:

- ``narrowest_int_dtype`` at every step boundary;
- ``resolve_codecs`` over the same request dtypes and integral ranges
  (stats-decided, probe-deferred, no codec, disabled);
- ``CodecTable.encode`` over sequences of batches: the encoded bytes and
  dtype of every batch, each ``CodecViolation`` (and its required
  dtype), ``widen``'s versions and tokens, ``raw_bytes_of``; int ranges
  at every step, float64 with -0.0, NaN payloads, subnormals and a value
  that is not exact in float32 in a later batch, codes and lengths;
- on real datasets of both packages, the dtype each column ships at.
  The canonical dtypes differ (the JAX package narrows int64 values and
  dictionary codes when it materializes them; the port keeps int64 and
  int32), so a column the JAX package already narrowed has no codec
  there and a narrowing codec in the port, with the same wire dtype.
"""

import numpy as np
import pytest

import deequ_tpu as R
from deequ_tpu.data.table import ColumnRequest as RReq
from deequ_tpu.engine import wire as rwire

import deequ_tpu_torch as T
from deequ_tpu_torch.data.table import ColumnRequest as TReq
from deequ_tpu_torch.engine import wire as twire


@pytest.mark.parametrize("lo,hi", [
    (0, 0), (-128, 127), (-129, 0), (0, 128), (-32768, 32767), (-32769, 5), (0, 32768),
    (-2**31, 2**31 - 1), (-2**31 - 1, 0), (0, 2**31), (-2**63, 2**63 - 1), (5, 6),
])
def test_narrowest_int_dtype(lo, hi):
    assert twire.narrowest_int_dtype(lo, hi) == rwire.narrowest_int_dtype(lo, hi)


class StubDataset:
    """What ``resolve_codecs`` reads of a dataset: request dtypes and
    integral ranges."""

    def __init__(self, dtypes, ranges):
        self.dtypes, self.ranges = dtypes, ranges

    def request_dtype(self, req):
        return np.dtype(self.dtypes[req.key])

    def integral_range(self, column):
        return self.ranges.get(column)


STUB_DTYPES = {
    "a::values": np.int64, "b::values": np.int64, "c::values": np.int64,
    "d::values": np.int32, "e::values": np.int16, "g::values": np.int8,
    "f::values": np.float64, "h::values": np.float32, "s::codes": np.int32,
    "s::lengths": np.int32, "t::values": np.int64, "a::mask": np.bool_,
    "u::bits": np.int64, "u::u64bits": np.int64,
}
STUB_RANGES = {"a": (0, 100), "b": (-40_000, 40_000), "c": (0, 2**40), "d": (-5, 300)}
# the raw 64 bits of a uint64 column, which no codec narrows: the port's
# "bits" repr is the JAX package's "u64bits"
U64 = {RReq: "u::u64bits", TReq: "u::bits"}


def _requests(mod_req):
    keys = [k for k in STUB_DTYPES if not k.startswith("u::")] + [U64[mod_req]]
    return [mod_req(*k.split("::")) for k in keys] + [mod_req("a", "values")]


@pytest.mark.parametrize("enabled", [True, False])
def test_resolve_codecs_decides_as_the_reference(enabled):
    ds = StubDataset(STUB_DTYPES, STUB_RANGES)
    ref = rwire.resolve_codecs(ds, _requests(RReq), enabled)
    port = twire.resolve_codecs(ds, _requests(TReq), enabled)
    assert port.token() == ref.token()
    assert {k: c.origin for k, c in port.codecs.items()} == {k: c.origin for k, c in ref.codecs.items()}
    assert {k: c.active for k, c in port.codecs.items()} == {k: c.active for k, c in ref.codecs.items()}
    if enabled:
        # a stats decision wider than the canonical dtype is no codec;
        # masks and u64 bits never get one
        assert "c::values" not in port.codecs
        assert not any(k.endswith(("::mask", "::bits", "::u64bits")) for k in port.codecs)


def _f64(bits):
    return np.array(bits, dtype=np.uint64).view(np.float64)


SEQUENCES = {
    # int64 values decided by stats at int8, then every step up
    "a::values": [
        np.array([0, 5, 100], dtype=np.int64),
        np.array([-128, 127], dtype=np.int64),
        np.array([200, -3], dtype=np.int64),  # int16
        np.array([], dtype=np.int64),
        np.array([70_000], dtype=np.int64),  # int32
        np.array([5, 6], dtype=np.int64),
        np.array([2**40, -(2**35)], dtype=np.int64),  # canonical
        np.array([1], dtype=np.int64),
    ],
    # int32 values by stats at int16, widened to canonical int32
    "d::values": [
        np.array([-5, 300], dtype=np.int32),
        np.array([40_000], dtype=np.int32),
        np.array([7], dtype=np.int32),
    ],
    # a probed int64 column (timestamps): the first batch decides
    "t::values": [
        np.array([1_600_000_000, 1_600_000_100], dtype=np.int64),
        np.array([1_600_000_050], dtype=np.int64),
        np.array([-1], dtype=np.int64),
    ],
    # an empty first batch probes int8
    "e::values": [
        np.array([], dtype=np.int16),
        np.array([3, -3], dtype=np.int16),
        np.array([300], dtype=np.int16),
    ],
    # float64 exact in float32, with -0.0, +/-inf and the canonical NaN;
    # then a later batch with a value float32 cannot hold exactly
    "f::values": [
        np.array([0.5, -0.0, 1.25, np.inf, -np.inf, np.nan, float(np.float32(3.0e38))]),
        np.array([2.0, -0.0, 0.0]),
        np.array([0.1]),  # not exact in float32
        np.array([0.5]),
    ],
    # float64 with a NaN payload float32 cannot carry: the probe keeps f64
    "h2::values": [
        _f64([0x7FF8000000000001, 0x3FF0000000000000]),
        np.array([1.0]),
    ],
    # float64 subnormal: flushes in float32, so the probe keeps f64
    "h3::values": [
        np.array([5e-324, 1.0]),
        np.array([2.0]),
    ],
    # a float64 column exact at first, then a subnormal and a NaN payload
    "h4::values": [
        np.array([1.0, 2.0]),
        np.array([np.finfo(np.float64).tiny / 4]),
    ],
    "h5::values": [
        np.array([1.0, 2.0]),
        _f64([0x7FF0000000000001]),
    ],
    # dictionary codes (-1 null) and utf8 lengths, probed
    "s::codes": [
        np.array([-1, 0, 3, 120], dtype=np.int32),
        np.array([127, -1], dtype=np.int32),
        np.array([5000], dtype=np.int32),
        np.array([-1], dtype=np.int32),
    ],
    "s::lengths": [
        np.array([0, 3, 16], dtype=np.int32),
        np.array([300], dtype=np.int32),
        np.array([2], dtype=np.int32),
    ],
}
SEQ_DTYPES = {k: v[0].dtype for k, v in SEQUENCES.items()}
SEQ_RANGES = {"a": (0, 100), "d": (-5, 300)}


def _drive(mod, keys):
    """Encode each key's batches in order; on a violation, widen and
    encode the same batch again (the packer's rule). Returns everything
    observed."""
    reqs = [(RReq if mod is rwire else TReq)(*k.split("::")) for k in keys]
    table = mod.resolve_codecs(StubDataset(SEQ_DTYPES, SEQ_RANGES), reqs, True)
    seen = [("token", table.token())]
    for key in keys:
        for batch in SEQUENCES[key]:
            while True:
                try:
                    enc = table.encode(key, batch)
                    break
                except mod.CodecViolation as violation:
                    seen.append(("violation", violation.key, violation.required.name))
                    table.widen(violation.key, violation.required)
                    seen.append(("widened", table.version, table.token()))
            seen.append(("encoded", key, enc.dtype.name, enc.tobytes(), enc.nbytes,
                         table.raw_bytes_of(key, enc)))
    return seen


@pytest.mark.parametrize("key", sorted(SEQUENCES))
def test_encode_sequence_matches_the_reference(key):
    assert _drive(twire, [key]) == _drive(rwire, [key])


def test_all_sequences_in_one_table_match_the_reference():
    keys = sorted(SEQUENCES)
    port = _drive(twire, keys)
    assert port == _drive(rwire, keys)
    versions = [v for kind, v, *_ in (s for s in port if s[0] == "widened")]
    assert versions == list(range(1, len(versions) + 1)) and len(versions) >= 8


def test_float_codec_round_trips_bit_for_bit():
    """What the f32 wire ships decodes to the same float64 bits."""
    table = twire.resolve_codecs(StubDataset({"f::values": np.float64}, {}),
                                 [TReq("f", "values")], True)
    subnormal = float(np.float32(1.5e-40))  # a float32 subnormal, exact in both
    values = np.array([0.5, -0.0, np.inf, -np.inf, np.nan, subnormal, float(np.float32(3.0e38))])
    enc = table.encode("f::values", values)
    assert enc.dtype == np.float32
    np.testing.assert_array_equal(enc.astype(np.float64).view(np.int64), values.view(np.int64))


def _dataset(P):
    rng = np.random.default_rng(0)
    n = 64
    return P.Dataset.from_pydict({
        "a": rng.integers(0, 100, n), "b": rng.integers(-40_000, 40_000, n),
        "c": rng.integers(0, 2**40, n), "q": rng.integers(0, 100, n).astype(np.int32),
        "f": np.round(rng.random(n), 2), "g": rng.random(n).astype(np.float32) * 2 ** 20,
        "x": rng.random(n), "s": [f"w{i % 9}" for i in range(n)],
        "t": np.arange(n).astype("datetime64[s]"), "bo": rng.random(n) < 0.5,
        "m": np.ma.array(rng.integers(5, 9, n), mask=rng.random(n) < 0.3),
    })


REAL = [("a", "values"), ("b", "values"), ("c", "values"), ("q", "values"), ("f", "values"),
        ("g", "values"), ("x", "values"), ("s", "codes"), ("s", "lengths"), ("t", "values"),
        ("bo", "values"), ("m", "values")]


def _shipped(P, mod, Req):
    ds = _dataset(P)
    reqs = [Req(*r) for r in REAL]
    table = mod.resolve_codecs(ds, reqs, True)
    out = {}
    for r in reqs:
        if r.repr == "lengths" and P is T:
            from deequ_tpu_torch.data.table import _lengths_table

            values = _lengths_table(ds.dictionary(r.column))[ds.materialize(TReq(r.column, "codes")) + 1]
        else:
            values = ds.materialize(r)
        out[r.key] = (table.encode(r.key, values).dtype.name, np.dtype(values.dtype).name,
                      r.key in table.codecs)
    return out


def test_real_datasets_ship_the_same_wire_dtypes():
    ref = _shipped(R, rwire, RReq)
    port = _shipped(T, twire, TReq)
    assert {k: v[0] for k, v in port.items()} == {k: v[0] for k, v in ref.items()}
    # where the canonical dtypes differ, the port narrows with a codec
    for k in port:
        if port[k][1] != ref[k][1]:
            assert port[k][2] and np.dtype(port[k][1]).itemsize > np.dtype(ref[k][1]).itemsize
    assert ref["a::values"][1] == "int32" and port["a::values"][1] == "int64"
    assert port["s::codes"] == ("int8", "int32", True)
