from bensolve_tpu_torch.vlp.problem import VLPProblem, Bounds, ConeGen
from bensolve_tpu_torch.vlp.options import Options
from bensolve_tpu_torch.vlp.reader import read_vlp, VLPFormatError

__all__ = ["VLPProblem", "Bounds", "ConeGen", "Options", "read_vlp", "VLPFormatError"]
