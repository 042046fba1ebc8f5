from cutie_tpu_torch.config.config import (Config, eval_config, model_base,
                                           model_small)

__all__ = ["Config", "model_base", "model_small", "eval_config"]
