from cutie_tpu_torch.config.config import (Config, eval_config,
                                           eval_plus_config, get_dataset_cfg,
                                           model_base, model_small)

__all__ = ["Config", "model_base", "model_small", "eval_config",
           "eval_plus_config", "get_dataset_cfg"]
