"""JSON serde of analysis results.

Counterpart of ``deequ_tpu/repository/serde.py``, and byte-equal to it
for the same results: each result is its key and a list of
``{"analyzer": {type, **fields}, "metric": {...}}`` pairs, every metric
type included (double, keyed, histogram and KLL metrics, and failures
as their message). An analyzer loads through ``ANALYZER_REGISTRY``,
which holds every analyzer of this package; a type it does not know
raises ``ValueError``, as the JAX package does.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Type

from deequ_tpu_torch.analyzers import (
    ApproxCountDistinct,
    ApproxQuantile,
    ApproxQuantiles,
    ColumnCount,
    Completeness,
    Compliance,
    Correlation,
    CountDistinct,
    CustomSql,
    DataType,
    Distinctness,
    Entropy,
    Histogram,
    KLLSketch,
    Maximum,
    MaxLength,
    Mean,
    Minimum,
    MinLength,
    MutualInformation,
    PatternMatch,
    RatioOfSums,
    Size,
    StandardDeviation,
    Sum,
    Uniqueness,
    UniqueValueRatio,
)
from deequ_tpu_torch.analyzers.base import Analyzer, MetricCalculationRuntimeException
from deequ_tpu_torch.analyzers.runner import AnalyzerContext
from deequ_tpu_torch.metrics.distribution import Distribution, DistributionValue, HistogramMetric
from deequ_tpu_torch.metrics.kll import BucketDistribution, BucketValue, KLLMetric
from deequ_tpu_torch.metrics.metric import DoubleMetric, Entity, KeyedDoubleMetric, Metric
from deequ_tpu_torch.repository.base import AnalysisResult, ResultKey
from deequ_tpu_torch.sketches.kll import KLLParameters
from deequ_tpu_torch.telemetry.oprecords import OperationalAnalyzer
from deequ_tpu_torch.utils.trylike import Failure, Success

ANALYZER_REGISTRY: Dict[str, Type[Analyzer]] = {
    cls.__name__: cls
    for cls in (
        ApproxCountDistinct,
        ApproxQuantile,
        ApproxQuantiles,
        ColumnCount,
        Completeness,
        Compliance,
        Correlation,
        CountDistinct,
        CustomSql,
        DataType,
        Distinctness,
        Entropy,
        Histogram,
        KLLSketch,
        Maximum,
        MaxLength,
        Mean,
        Minimum,
        MinLength,
        MutualInformation,
        PatternMatch,
        RatioOfSums,
        Size,
        StandardDeviation,
        Sum,
        Uniqueness,
        UniqueValueRatio,
        # telemetry's operational records ride the same serde path as
        # data-quality metrics
        OperationalAnalyzer,
    )
}

_METRIC_TYPES = {
    cls.__name__: cls for cls in (DoubleMetric, KeyedDoubleMetric, HistogramMetric, KLLMetric)
}


def _param_to_json(value: Any) -> Any:
    if isinstance(value, KLLParameters):
        return {
            "__kll_params__": True,
            "sketch_size": value.sketch_size,
            "shrinking_factor": value.shrinking_factor,
            "number_of_buckets": value.number_of_buckets,
        }
    if isinstance(value, tuple):
        return list(value)
    return value


def _param_from_json(value: Any) -> Any:
    if isinstance(value, dict) and value.get("__kll_params__"):
        return KLLParameters(
            value["sketch_size"], value["shrinking_factor"], value["number_of_buckets"]
        )
    if isinstance(value, list):
        return tuple(value)
    return value


def analyzer_to_json(analyzer: Analyzer) -> Dict[str, Any]:
    out: Dict[str, Any] = {"type": type(analyzer).__name__}
    for f in dataclasses.fields(analyzer):
        out[f.name] = _param_to_json(getattr(analyzer, f.name))
    return out


def analyzer_from_json(data: Dict[str, Any]) -> Analyzer:
    cls = ANALYZER_REGISTRY.get(data["type"])
    if cls is None:
        raise ValueError(f"unknown analyzer type {data['type']!r}")
    return cls(**{k: _param_from_json(v) for k, v in data.items() if k != "type"})


def metric_to_json(metric: Metric) -> Dict[str, Any]:
    out: Dict[str, Any] = {
        "metric_type": type(metric).__name__,
        "entity": metric.entity.value,
        "name": metric.name,
        "instance": metric.instance,
    }
    if metric.value.is_failure:
        out["error"] = str(metric.value.exception)
        return out
    value = metric.value.get()
    if isinstance(metric, DoubleMetric):
        out["value"] = value
    elif isinstance(metric, KeyedDoubleMetric):
        out["value"] = dict(value)
    elif isinstance(metric, HistogramMetric):
        out["value"] = {
            "number_of_bins": value.number_of_bins,
            "values": {
                k: {"absolute": dv.absolute, "ratio": dv.ratio}
                for k, dv in value.values.items()
            },
        }
    elif isinstance(metric, KLLMetric):
        out["value"] = {
            "buckets": [
                {"low_value": b.low_value, "high_value": b.high_value, "count": b.count}
                for b in value.buckets
            ],
            "parameters": list(value.parameters),
            "data": [list(level) for level in value.data],
        }
    else:
        raise TypeError(f"cannot serialize metric type {type(metric)}")
    return out


def metric_from_json(data: Dict[str, Any]) -> Metric:
    entity = Entity(data["entity"])
    name = data["name"]
    instance = data["instance"]
    metric_type = data["metric_type"]
    if "error" in data:
        failure = Failure(MetricCalculationRuntimeException(data["error"]))
        return _METRIC_TYPES[metric_type](entity, name, instance, failure)
    raw = data["value"]
    if metric_type == "DoubleMetric":
        return DoubleMetric(entity, name, instance, Success(float(raw)))
    if metric_type == "KeyedDoubleMetric":
        return KeyedDoubleMetric(entity, name, instance, Success(dict(raw)))
    if metric_type == "HistogramMetric":
        dist = Distribution(
            {k: DistributionValue(v["absolute"], v["ratio"]) for k, v in raw["values"].items()},
            raw["number_of_bins"],
        )
        return HistogramMetric(entity, name, instance, Success(dist))
    if metric_type == "KLLMetric":
        dist = BucketDistribution(
            [BucketValue(b["low_value"], b["high_value"], b["count"]) for b in raw["buckets"]],
            tuple(raw["parameters"]),
            tuple(tuple(level) for level in raw["data"]),
        )
        return KLLMetric(entity, name, instance, Success(dist))
    raise TypeError(f"unknown metric type {metric_type!r}")


def serialize(results: List[AnalysisResult], indent: int = 2) -> str:
    payload = []
    for result in results:
        payload.append(
            {
                "result_key": {
                    "dataset_date": result.result_key.dataset_date,
                    "tags": result.result_key.tags_dict,
                },
                "analyzer_context": [
                    {"analyzer": analyzer_to_json(a), "metric": metric_to_json(m)}
                    for a, m in result.analyzer_context.metric_map.items()
                ],
            }
        )
    return json.dumps(payload, indent=indent)


def deserialize(text: str) -> List[AnalysisResult]:
    out: List[AnalysisResult] = []
    for entry in json.loads(text):
        key = ResultKey.of(entry["result_key"]["dataset_date"], entry["result_key"]["tags"])
        metric_map = {}
        for pair in entry["analyzer_context"]:
            analyzer = analyzer_from_json(pair["analyzer"])
            metric_map[analyzer] = metric_from_json(pair["metric"])
        out.append(AnalysisResult(key, AnalyzerContext(metric_map)))
    return out
