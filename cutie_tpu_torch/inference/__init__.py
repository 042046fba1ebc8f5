from cutie_tpu_torch.inference.inference_core import InferenceCore

__all__ = ["InferenceCore"]
