"""The port against the exactness goldens of the JAX package.

Every case of ``tools/goldens_spec.cases()`` whose analyzer type the
port has runs through the port's ``AnalysisRunner`` on the CPU, on
``Dataset.from_arrow`` of ``goldens_spec.fixtures()``, and must give the
frozen outcome of ``tests/goldens/core_v1.json`` EXACTLY: the same value
(NaN, infinities and -0.0 included, through ``goldens_spec
.encode_value``) or the same failure type. ``where=`` cases included.

The map from a spec to the port's analyzer is this file's own. The types
the port does not have yet sit in ``NOT_YET_PORTED``; a later slice that
ports one moves it out, and its cases then run here.
"""

import json
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import deequ_tpu_torch as T  # noqa: E402
from deequ_tpu_torch import config as tconfig  # noqa: E402
from tools import goldens_spec as spec  # noqa: E402

GOLDEN_PATH = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "goldens", "core_v1.json"
)

PORTED = {
    "Size": lambda s: T.Size(where=s.get("where")),
    "Completeness": lambda s: T.Completeness(s["column"], where=s.get("where")),
    "Mean": lambda s: T.Mean(s["column"], where=s.get("where")),
    "Sum": lambda s: T.Sum(s["column"], where=s.get("where")),
    "Minimum": lambda s: T.Minimum(s["column"], where=s.get("where")),
    "Maximum": lambda s: T.Maximum(s["column"], where=s.get("where")),
    "StandardDeviation": lambda s: T.StandardDeviation(s["column"], where=s.get("where")),
    "ApproxCountDistinct": lambda s: T.ApproxCountDistinct(s["column"]),
    "Compliance": lambda s: T.Compliance(s["instance"], s["predicate"], where=s.get("where")),
    "PatternMatch": lambda s: T.PatternMatch(s["column"], s["pattern"]),
    "DataType": lambda s: T.DataType(s["column"]),
    "MinLength": lambda s: T.MinLength(s["column"]),
    "MaxLength": lambda s: T.MaxLength(s["column"]),
    "Correlation": lambda s: T.Correlation(s["first"], s["second"]),
    "RatioOfSums": lambda s: T.RatioOfSums(s["first"], s["second"]),
    "CountDistinct": lambda s: T.CountDistinct(s["columns"]),
    "Distinctness": lambda s: T.Distinctness(s["columns"]),
    "Uniqueness": lambda s: T.Uniqueness(s["columns"]),
    "UniqueValueRatio": lambda s: T.UniqueValueRatio(s["columns"]),
    "Entropy": lambda s: T.Entropy(s["column"]),
    "MutualInformation": lambda s: T.MutualInformation(s["columns"]),
}

# analyzer types of the goldens that the port does not have yet
NOT_YET_PORTED = set()

with open(GOLDEN_PATH) as f:
    GOLDEN = json.load(f)


def _case_id(case):
    a = dict(case["analyzer"])
    t = a.pop("type")
    rest = ",".join(f"{k}={v}" for k, v in sorted(a.items()))
    return f"{case['fixture']}-{t}({rest})"


PORTED_CASES = [c for c in GOLDEN["cases"] if c["analyzer"]["type"] in PORTED]


def test_every_golden_type_is_ported_or_listed():
    types = {c["analyzer"]["type"] for c in GOLDEN["cases"]}
    assert types == set(PORTED) | NOT_YET_PORTED
    assert not set(PORTED) & NOT_YET_PORTED


def _run(dataset, analyzer):
    with tconfig.configure(device="cpu"):
        ctx = T.AnalysisRunner.do_analysis_run(dataset, [analyzer])
    metric = ctx.metric(analyzer)
    if metric.value.is_success:
        return {"success": True, "value": spec.encode_value(metric.value.get())}
    cause = metric.value.exception
    while cause.__cause__ is not None:
        cause = cause.__cause__
    return {"success": False, "error": type(cause).__name__}


@pytest.mark.parametrize("case", PORTED_CASES, ids=[_case_id(c) for c in PORTED_CASES])
def test_golden_case(case):
    table = spec.fixtures()[case["fixture"]]
    analyzer = PORTED[case["analyzer"]["type"]](case["analyzer"])
    got = _run(T.Dataset.from_arrow(table), analyzer)
    assert got == case["expect"], f"{_case_id(case)}: frozen={case['expect']} got={got}"
