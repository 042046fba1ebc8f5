"""The CUTIE network of the plain reference: a frozen copy of the port's
modules (cutie_tpu_torch/models, ops/resize.py, ops/tensor_utils.py).
It imports nothing of the port."""
from vosbench.reference.network.cutie import CUTIE
