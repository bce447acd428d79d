from deequ_tpu_torch.engine.scan import AnalysisEngine

__all__ = ["AnalysisEngine"]
