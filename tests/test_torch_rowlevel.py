"""The port's row-level results (``deequ_tpu_torch/verification/
rowlevel.py``, ``VerificationResult.row_level_results_as_dataset``)
against the JAX package's.

Each case builds the same data in both packages (a dict, or numpy draws
from a seed), runs the same Check through ``VerificationSuite`` in
each (the JAX package on the CPU with x64, the port with
``device="cpu"``), and asks both for the row-level results in both
``filtered_row_outcome`` modes: the column names are equal, and each
column is equal row for row (nulls included). The cases are those of
``tests/test_custom_applicability.py::TestRowLevelResults``,
``tests/test_predicate.py``'s row-level cases and
``tests/test_memory_pressure.py::TestRowLevelDegrade``, with the values
those tests pin, plus multi-column keys, float keys with NaN and -0.0,
string keys and a seeded table with every family.
"""

import numpy as np
import pytest
import torch

import deequ_tpu as R
import deequ_tpu_torch as T
from deequ_tpu_torch import config as tconfig

MODES = ["true", "null"]


@pytest.fixture(autouse=True)
def _cpu():
    with tconfig.configure(device="cpu"):
        yield


def _rows(P, data, build, outcome):
    check = build(P)
    result = P.VerificationSuite().on_data(P.Dataset.from_pydict(data)).add_check(check).run()
    table = result.row_level_results_as_dataset(filtered_row_outcome=outcome).table
    return {name: table.column(name).to_pylist() for name in table.schema.names}, result


def _both(data, build, outcome):
    ref, _ = _rows(R, data, build, outcome)
    got, result = _rows(T, data, build, outcome)
    assert list(got) == list(ref)
    for name in ref:
        assert got[name] == ref[name], name
    return got, result


def _column(rows, fragment):
    (name,) = [k for k in rows if fragment in k]
    return rows[name]


# -- tests/test_custom_applicability.py::TestRowLevelResults -------------


@pytest.mark.parametrize("outcome", MODES)
def test_row_level_outcomes(outcome):
    data = {"x": [1.0, -2.0, 3.0, None], "id": [1, 2, 2, 4],
            "email": ["a@b.com", "nope", "c@d.org", None]}

    def build(P):
        return (P.Check(P.CheckLevel.ERROR, "rl").is_complete("x")
                .satisfies("x > 0", "positive", lambda v: v == 1.0)
                .is_unique("id").contains_email("email", lambda v: v == 1.0))

    rows, _ = _both(data, build, outcome)
    assert len(rows) == 4
    assert _column(rows, "Completeness") == [True, True, True, False]
    assert _column(rows, "positive") == [True, False, True, False]
    assert _column(rows, "Uniqueness") == [True, False, False, True]


@pytest.mark.parametrize("outcome", MODES)
def test_uniqueness_row_level_respects_where(outcome):
    def build(P):
        return (P.Check(P.CheckLevel.ERROR, "w")
                .has_unique_value_ratio(["id"], lambda v: v == 1.0).where("g = 1"))

    rows, _ = _both({"id": [1, 1, 2], "g": [1, 2, 1]}, build, outcome)
    assert list(rows.values())[0] == ([True, True, True] if outcome == "true"
                                      else [True, None, True])


@pytest.mark.parametrize("outcome", MODES)
def test_unique_value_ratio_row_level(outcome):
    def build(P):
        return P.Check(P.CheckLevel.ERROR, "uvr").has_unique_value_ratio(["id"], lambda v: v >= 0.5)

    rows, _ = _both({"id": [1, 2, 2, 3, 3, 4]}, build, outcome)
    assert list(rows.values())[0] == [True, False, False, False, False, True]


@pytest.mark.parametrize("outcome", MODES)
def test_where_filtered_rows(outcome):
    def build(P):
        return (P.Check(P.CheckLevel.ERROR, "w")
                .satisfies("x > 0", "pos-in-g1", lambda v: v == 1.0).where("g = 1"))

    rows, _ = _both({"x": [1.0, -5.0, 2.0], "g": [1, 2, 1]}, build, outcome)
    assert list(rows.values())[0] == ([True, True, True] if outcome == "true"
                                      else [True, None, True])


@pytest.mark.parametrize("outcome", MODES)
def test_asserted_value_outcomes_lengths_and_minmax(outcome):
    def build(P):
        return (P.Check(P.CheckLevel.ERROR, "asserted")
                .has_min_length("s", lambda v: v >= 2).has_max_length("s", lambda v: v <= 3)
                .has_min("x", lambda v: v >= 0).has_max("x", lambda v: v <= 6))

    rows, result = _both({"s": ["a", "abc", None, "abcdef"], "x": [5.0, -1.0, 7.0, None]},
                         build, outcome)
    assert _column(rows, "MinLength") == [False, True, True, True]
    assert _column(rows, "MaxLength") == [True, True, True, False]
    assert _column(rows, "Minimum") == [True, False, True, True]
    assert _column(rows, "Maximum") == [True, True, False, True]
    for cr in list(result.check_results.values())[0].constraint_results:
        row_passed = all(x for x in rows[str(cr.constraint)] if x is not None)
        assert row_passed == (cr.status.value == "Success"), str(cr.constraint)


def test_bad_filtered_row_outcome_rejected():
    result = T.VerificationSuite().on_data(T.Dataset.from_pydict({"x": [1.0]})).add_check(
        T.Check(T.CheckLevel.ERROR, "w").is_complete("x")).run()
    with pytest.raises(ValueError, match="filtered_row_outcome"):
        result.row_level_results_as_dataset(filtered_row_outcome="x")


@pytest.mark.parametrize("outcome", MODES)
def test_throwing_assertion_degrades_to_no_column(outcome):
    def build(P):
        return P.Check(P.CheckLevel.ERROR, "partial").has_min("x", lambda v: 1.0 / v > 0)

    rows, _ = _both({"x": [1.0, 0.0, None]}, build, outcome)
    assert not [n for n in rows if "Minimum" in n]
    assert list(rows) == ["__no_row_level_constraints__"]


# -- tests/test_predicate.py's row-level cases -----------------------------


@pytest.mark.parametrize("outcome", MODES)
def test_partial_assertion_safe_on_filtered_domain(outcome):
    def build(P):
        return (P.Check(P.CheckLevel.ERROR, "partial")
                .has_min("x", lambda v: 1.0 / v > 0).where("x != 0"))

    rows, _ = _both({"x": [1.0, 0.0, 2.0]}, build, outcome)
    assert _column(rows, "Minimum") == ([True, True, True] if outcome == "true"
                                        else [True, None, True])


@pytest.mark.parametrize("outcome", MODES)
def test_row_level_with_synthetic_lanes(outcome):
    def build(P):
        return P.Check(P.CheckLevel.ERROR, "rl").satisfies(
            "CONCAT(a, '-', b) = 'x-1' OR CASE WHEN n > 2 THEN a ELSE b END = 'y'",
            "syn", lambda v: v > 0)

    rows, _ = _both({"a": ["x", None, "y"], "b": ["1", "2", None], "n": [1.0, 2.0, 3.0]},
                    build, outcome)
    assert list(rows.values())[0] == [True, False, True]


# -- tests/test_memory_pressure.py::TestRowLevelDegrade --------------------


@pytest.mark.parametrize("outcome", MODES)
def test_one_bad_one_good_predicate_export(outcome):
    def build(P):
        return (P.Check(P.CheckLevel.ERROR, "rl")
                .satisfies("a >= 0", "a-non-negative", lambda v: v == 1.0)
                .satisfies("nosuchcol >= 0", "phantom-column", lambda v: v == 1.0))

    rows, result = _both({"a": [1.0, -2.0, 3.0]}, build, outcome)
    assert result.status.value == "Error"
    assert _column(rows, "a-non-negative") == [True, False, True]
    assert not [n for n in rows if "phantom-column" in n]


@pytest.mark.parametrize("outcome", MODES)
def test_bad_where_filter_drops_only_its_column(outcome):
    def build(P):
        return (P.Check(P.CheckLevel.ERROR, "rl").has_min("a", lambda v: v <= 10)
                .where("nosuchcol > 0").has_completeness("a", lambda v: v == 1.0))

    rows, _ = _both({"a": [1.0, 2.0, 3.0]}, build, outcome)
    assert _column(rows, "Completeness") == [True, True, True]
    assert not [n for n in rows if "Minimum" in n]


# -- keys, and every family over a seeded table ------------------------------


@pytest.mark.parametrize("outcome", MODES)
def test_multi_column_and_float_keys(outcome):
    nan = float("nan")
    data = {
        "f": [0.0, -0.0, nan, nan, 1.5, None, None, 1.5],
        "s": ["a", "a", "b", "b", None, "c", "c", None],
        "k": [1, 1, 2, 3, 4, 5, 5, 4],
    }

    def build(P):
        return (P.Check(P.CheckLevel.ERROR, "keys")
                .has_uniqueness(["f"], lambda v: v >= 0)
                .has_uniqueness(["s", "k"], lambda v: v >= 0)
                .is_primary_key("f", "s")
                .has_unique_value_ratio(["k", "f"], lambda v: v >= 0).where("k > 1"))

    _both(data, build, outcome)


def _seeded(n=1000, seed=7):
    rng = np.random.default_rng(seed)
    return {
        "v": rng.integers(0, 120, size=n).tolist(),
        "s": [None if rng.random() < 0.08 else f"u{int(x):03d}@ex.com"
              for x in rng.integers(0, 40, size=n)],
        "u": rng.integers(0, n // 2, size=n).tolist(),
        "x": [None if rng.random() < 0.05 else float(x) for x in rng.normal(size=n)],
    }


@pytest.mark.parametrize("outcome", MODES)
def test_every_family_over_a_seeded_table(outcome):
    def build(P):
        return (P.Check(P.CheckLevel.ERROR, "all")
                .is_complete("s").is_complete("x").where("v > 20")
                .satisfies("v < 90", "v_small").where("v >= 10")
                .has_pattern("s", r"@ex\.com$").contains_email("s", lambda v: v > 0.5)
                .has_min("v", lambda x: x >= 5).has_max("x", lambda x: x < 2.0).where("v < 100")
                .has_min_length("s", lambda n: n > 10).has_max_length("s", lambda n: n <= 11)
                .has_min("x", lambda x: -2.5 < x < 2.5)
                .is_unique("u").is_unique("s").where("v < 60")
                .is_non_negative("x").is_contained_in("s", ["u001@ex.com", "u002@ex.com"]))

    rows, _ = _both(_seeded(), build, outcome)
    assert len(rows) == 14


# -- chunks, key partitions, and what fails an export --------------------


@pytest.mark.parametrize("chunk_rows", [7, 64, 333])
@pytest.mark.parametrize("outcome", MODES)
def test_every_family_in_chunks_and_key_partitions(outcome, chunk_rows):
    """The device sees ``chunk_rows`` rows at a time, and Uniqueness
    groups each of about n / chunk_rows hash partitions of the keys
    apart: the columns are still the JAX package's."""
    def build(P):
        return (P.Check(P.CheckLevel.ERROR, "chunks")
                .is_complete("x").where("v > 20")
                .satisfies("v < 90", "v_small").where("v >= 10")
                .has_pattern("s", r"@ex\.com$")
                .has_min("v", lambda x: x >= 5).has_max_length("s", lambda n: n <= 11)
                .is_unique("u").is_unique("s").where("v < 60")
                .has_uniqueness(["v", "s"], lambda v: v >= 0))

    with tconfig.configure(batch_size=chunk_rows):
        rows, _ = _both(_seeded(), build, outcome)
    assert len(rows) == 8


@pytest.mark.parametrize("outcome", MODES)
def test_a_skewed_key_partition_is_grouped_on_the_host(outcome):
    """A key that most rows share makes one partition far larger than a
    chunk; it is grouped on the host, with the same outcomes."""
    rng = np.random.default_rng(3)
    n = 600
    data = {"k": [7 if rng.random() < 0.9 else int(x) for x in rng.integers(0, 50, size=n)],
            "g": rng.integers(0, 3, size=n).tolist()}

    def build(P):
        return (P.Check(P.CheckLevel.ERROR, "skew").is_unique("k")
                .has_uniqueness(["k", "g"], lambda v: v >= 0).where("g > 0"))

    with tconfig.configure(batch_size=50):
        _both(data, build, outcome)


FAULTS = {
    "out of memory": lambda: torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2 GiB"),
    "device fault": lambda: RuntimeError("CUDA error: an illegal memory access was encountered"),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_memory_pressure_and_device_faults_fail_the_export(monkeypatch, fault):
    """An unplannable constraint drops its own column, but memory
    pressure or a device fault while a column is computed raises: a
    column is never dropped for the card's sake."""
    from deequ_tpu_torch.verification import rowlevel

    def failing(*args, **kwargs):
        raise FAULTS[fault]()

    data = T.Dataset.from_pydict({"id": [1, 2, 2, 4]})
    result = (T.VerificationSuite().on_data(data)
              .add_check(T.Check(T.CheckLevel.ERROR, "u").is_complete("id").is_unique("id"))
              .run())
    monkeypatch.setattr(rowlevel, "_group_ids", failing)
    with pytest.raises(RuntimeError, match="CUDA"):
        result.row_level_results_as_dataset()
