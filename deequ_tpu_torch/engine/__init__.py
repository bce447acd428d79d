from deequ_tpu_torch.engine.mesh import monoid_all_reduce
from deequ_tpu_torch.engine.scan import AnalysisEngine

__all__ = ["AnalysisEngine", "monoid_all_reduce"]
