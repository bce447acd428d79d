from deequ_tpu_torch.metrics.metric import DoubleMetric, Entity, Metric

__all__ = ["DoubleMetric", "Entity", "Metric"]
