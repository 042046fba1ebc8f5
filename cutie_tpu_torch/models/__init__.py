from cutie_tpu_torch.models.cutie import CUTIE

__all__ = ["CUTIE"]
