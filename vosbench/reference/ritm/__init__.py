"""RITM's iterative-mask HRNet-18 + OCR click model under f-BRS-B in plain
float32 torch: the reference of the benchmark's click event
(vosbench/events/click.py).

  hrnet.py      the network (HRNet-W18, OCR width 64, the disk click maps
                and the previous-mask channel through maps_transform)
  predictor.py  one click: the transforms (zoom-in, LimitLongestSide,
                flip) and their inverses, f-BRS-B's scale-and-bias
                objective at insertion point A, and scipy's L-BFGS-B with
                upstream's exits

Each file names the upstream files it follows and its departures. Nothing
here imports the port (cutie_tpu_torch) or JAX. The caller runs it with
TF32 off (torch.backends.cuda.matmul.allow_tf32 and
torch.backends.cudnn.allow_tf32 False): vosbench.check.precision(net,
"fp32"); "tf32" is the benchmark's control.
"""
from vosbench.reference.ritm.hrnet import HRNetISModel
from vosbench.reference.ritm.predictor import (Click, Interaction, Params,
                                               lbfgs_b)

__all__ = ["Click", "HRNetISModel", "Interaction", "Params", "lbfgs_b"]
