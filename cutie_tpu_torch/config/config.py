"""Configuration tree (the port's own copy of cutie_tpu/config/config.py).

An attribute-dict config mirroring the reference's eval_config.yaml and
model/{base,small}.yaml. YAML is imported only when a YAML file is read.
"""
from __future__ import annotations

import copy
from typing import Any, Dict, Optional


class Config:
    """A nested attribute/item-access config node:
    `cfg.model.key_dim == cfg['model']['key_dim']`."""

    def __init__(self, data: Optional[Dict[str, Any]] = None, **kwargs):
        data = dict(data or {})
        data.update(kwargs)
        for k, v in data.items():
            self[k] = v

    def __setitem__(self, k, v):
        if isinstance(v, dict):
            v = Config(v)
        object.__setattr__(self, k, v)

    def __getitem__(self, k):
        try:
            return self.__dict__[k]
        except KeyError:
            raise KeyError(k)

    def __setattr__(self, k, v):
        self[k] = v

    def __contains__(self, k):
        return k in self.__dict__

    def __iter__(self):
        return iter(self.__dict__)

    def __len__(self):
        return len(self.__dict__)

    def __eq__(self, other):
        return isinstance(other, Config) and self.__dict__ == other.__dict__

    def __repr__(self):
        return f"Config({self.__dict__!r})"

    def keys(self):
        return self.__dict__.keys()

    def values(self):
        return self.__dict__.values()

    def items(self):
        return self.__dict__.items()

    def get(self, k, default=None):
        return self.__dict__.get(k, default)

    def to_dict(self) -> Dict[str, Any]:
        return {k: (v.to_dict() if isinstance(v, Config) else v)
                for k, v in self.items()}

    def __deepcopy__(self, memo):
        return Config({k: copy.deepcopy(v, memo) for k, v in self.items()})

    def copy(self) -> "Config":
        return copy.deepcopy(self)

    def merge(self, other: Dict[str, Any]) -> "Config":
        """Recursive in-place merge; `other` wins. Returns self."""
        for k, v in other.items():
            if k in self and isinstance(self[k], Config) and isinstance(v, dict):
                self[k].merge(v)
            else:
                self[k] = v
        return self

    @staticmethod
    def from_yaml(path: str) -> "Config":
        import yaml

        with open(path) as f:
            return Config(yaml.safe_load(f))


def model_base() -> Config:
    """Mirrors reference cutie/config/model/base.yaml."""
    embed_dim = 256
    return Config({
        "pixel_mean": [0.485, 0.456, 0.406],
        "pixel_std": [0.229, 0.224, 0.225],
        "pixel_dim": 256,
        "key_dim": 64,
        "value_dim": 256,
        "sensory_dim": 256,
        "embed_dim": embed_dim,
        "pixel_encoder": {"type": "resnet50", "ms_dims": [1024, 512, 256]},
        "mask_encoder": {"type": "resnet18", "final_dim": 256},
        "pixel_pe_scale": 32,
        "pixel_pe_temperature": 128,
        "object_transformer": {
            "embed_dim": embed_dim,
            "ff_dim": 2048,
            "num_heads": 8,
            "num_blocks": 3,
            "num_queries": 16,
            "read_from_pixel": {"add_pe_to_qkv": [True, True, False]},
            "read_from_query": {"add_pe_to_qkv": [True, True, False],
                                "output_norm": False},
            "query_self_attention": {"add_pe_to_qkv": [True, True, False]},
        },
        "object_summarizer": {
            "embed_dim": embed_dim,
            "num_summaries": 16,
            "add_pe": True,
        },
        "aux_loss": {
            "sensory": {"enabled": True, "weight": 0.01},
            "query": {"enabled": True, "weight": 0.01},
        },
        "mask_decoder": {"up_dims": [256, 128, 128]},
    })


def model_small() -> Config:
    """Mirrors reference cutie/config/model/small.yaml."""
    cfg = model_base()
    cfg.pixel_encoder = Config({"type": "resnet18", "ms_dims": [256, 128, 64]})
    return cfg


def eval_config(model: str = "base") -> Config:
    """Mirrors reference cutie/config/eval_config.yaml at the d17-val
    settings (working memory only, a memory frame every 5 frames)."""
    return Config({
        "model": model_base() if model == "base" else model_small(),
        "amp": False,
        "weights": None,
        "flip_aug": False,
        "max_internal_size": -1,
        "use_long_term": False,
        "mem_every": 5,
        "max_mem_frames": 5,
        "long_term": {
            "count_usage": True,
            "max_mem_frames": 10,
            "min_mem_frames": 5,
            "num_prototypes": 128,
            "max_num_tokens": 10000,
            "buffer_tokens": 2000,
        },
        "top_k": 30,
        "stagger_updates": 5,
        "chunk_size": -1,
        "save_aux": False,
        "perm_frame_capacity": 1,
        # carried so that cutie_tpu configs load; the port always reads
        # memory through ops.read_kernel.radix_topk_readout
        "read_backend": "auto",
    })
