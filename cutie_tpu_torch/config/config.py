"""Configuration tree (the port's own copy of cutie_tpu/config/config.py).

An attribute-dict config mirroring the reference's eval_config.yaml and
model/{base,small}.yaml, with its dataset presets and get_dataset_cfg. YAML
is imported only when a YAML file is read; command-line overrides are parsed
without it (parse_scalar).
"""
from __future__ import annotations

import copy
import json
import re
from typing import Any, Dict, Iterable, Optional


_NULLS = ("", "~", "null", "Null", "NULL")
_BOOLS = {"true": True, "yes": True, "on": True,
          "false": False, "no": False, "off": False}
# YAML 1.1's decimal integers and floats, as PyYAML resolves them
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)")
_FLOAT = re.compile(r"[-+]?[0-9][0-9_]*\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|[-+]?\.[0-9_]+(?:[eE][-+][0-9]+)?")


def parse_scalar(raw: str) -> Any:
    """A command-line value as yaml.safe_load reads it (cutie_tpu's
    apply_overrides), without YAML, for the values a config holds: null,
    booleans (true/false, yes/no, on/off, in lower, capitalised or upper
    case), decimal integers and floats, JSON lists and mappings, and
    strings, quoted or not."""
    s = raw.strip()
    if s in _NULLS:
        return None
    if s.lower() in _BOOLS and s in (s.lower(), s.capitalize(), s.upper()):
        return _BOOLS[s.lower()]
    if _INT.fullmatch(s):
        return int(s.replace("_", ""))
    if _FLOAT.fullmatch(s):
        return float(s.replace("_", ""))
    if s[:1] in "[{":
        return json.loads(s)
    if len(s) > 1 and s[0] == s[-1] and s[0] in "'\"":
        return s[1:-1]
    return s


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

    def override(self, dotted: str, value: Any) -> "Config":
        """Set one dotted key, e.g. 'long_term.max_num_tokens'."""
        keys = dotted.split(".")
        node = self
        for k in keys[:-1]:
            if k not in node or not isinstance(node[k], Config):
                node[k] = Config()
            node = node[k]
        node[keys[-1]] = value
        return self

    def apply_overrides(self, overrides: Iterable[str]) -> "Config":
        """Apply 'a.b.c=value' strings; values are parsed by parse_scalar."""
        for ov in overrides:
            key, _, raw = ov.partition("=")
            self.override(key.strip(), parse_scalar(raw))
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


_DATASETS: Dict[str, Dict[str, Any]] = {
    # mirrors reference cutie/config/eval_config.yaml:54-147
    "d16-val": dict(size=480, save_all=True, use_all_masks=False,
                    use_long_term=False, mem_every=5),
    "d17-val": dict(size=480, save_all=True, use_all_masks=False,
                    use_long_term=False, mem_every=5),
    "d17-test-dev": dict(size=480, save_all=True, use_all_masks=False,
                         use_long_term=False, mem_every=5),
    "y18-val": dict(size=480, save_all=False, use_all_masks=True,
                    use_long_term=False, mem_every=5),
    "y19-val": dict(size=480, save_all=False, use_all_masks=True,
                    use_long_term=False, mem_every=5),
    "mose-val": dict(size=480, save_all=True, use_all_masks=False,
                     use_long_term=False, mem_every=5),
    "generic": dict(size=-1, save_all=True, use_all_masks=False,
                    use_long_term=True, mem_every=5),
    "burst-val": dict(size=600, save_all=False, use_long_term=True,
                      mem_every=10, skip_frames=-1),
    "burst-test": dict(size=600, save_all=False, use_long_term=True,
                       mem_every=10, skip_frames=-1),
    "lvos-val": dict(size=480, save_all=False, use_all_masks=True,
                     use_long_term=True, mem_every=5),
    "lvos-test": dict(size=480, save_all=False, use_all_masks=True,
                      use_long_term=True, mem_every=5),
}


def eval_config(model: str = "base") -> Config:
    """Mirrors reference cutie/config/eval_config.yaml's top level, key for
    key with cutie_tpu's eval_config. The per-dataset keys (size, save_all,
    use_all_masks, use_long_term, mem_every and the directories) are None
    until get_dataset_cfg fills them from cfg.datasets[cfg.dataset]; a value
    set before that call overrides the preset."""
    return Config({
        "model": model_base() if model == "base" else model_small(),
        "exp_id": "default",
        "dataset": "d17-val",
        "amp": False,
        "weights": "output/cutie-base-mega.pth",
        "output_dir": None,
        "flip_aug": False,
        "max_internal_size": -1,
        "image_directory": None,
        "mask_directory": None,
        "json_directory": None,
        "size": None,
        "save_all": None,
        "use_all_masks": None,
        "use_long_term": None,
        "mem_every": None,
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
        "save_scores": False,
        "save_aux": False,
        "visualize": False,
        # carried so that cutie_tpu's configs load; the port reads none of
        # max_objects, matmul_precision and read_backend (it always reads
        # memory through ops.read_kernel.radix_topk_readout)
        "max_objects": -1,
        "perm_frame_capacity": 1,
        "compute_dtype": "float32",
        "matmul_precision": None,
        "read_backend": "auto",
        "datasets": {k: dict(v) for k, v in _DATASETS.items()},
    })


def eval_plus_config(model: str = "base") -> Config:
    """Mirrors reference cutie/config/eval_plus_config.yaml: 720p/600p,
    mem_every=3 on DAVIS and MOSE, max_mem_frames=10."""
    cfg = eval_config(model)
    cfg.max_mem_frames = 10
    plus_overrides = {
        "d16-val": dict(size=720, mem_every=3),
        "d17-val": dict(size=720, mem_every=3),
        "d17-test-dev": dict(size=720, mem_every=3),
        "y18-val": dict(size=600, mem_every=5),
        "y19-val": dict(size=600, mem_every=5),
        "mose-val": dict(size=720, mem_every=3),
        "lvos-val": dict(size=600, mem_every=5),
        "lvos-test": dict(size=600, mem_every=5),
    }
    for name, o in plus_overrides.items():
        cfg.datasets[name].merge(o)
    return cfg


def get_dataset_cfg(cfg: Config) -> Config:
    """Merge the per-dataset block into the top level, honouring explicit
    top-level overrides (reference cutie/inference/utils/args_utils.py:7-30).
    Returns the dataset block; the top level gets its values too."""
    dataset_name = cfg.dataset
    if dataset_name not in cfg.datasets:
        raise KeyError(
            f"Unknown dataset '{dataset_name}'. Available: "
            f"{sorted(cfg.datasets.keys())} (or add a custom block to "
            f"cfg.datasets)")
    data_cfg = Config(cfg.datasets[dataset_name])
    potential_overrides = [
        "image_directory", "mask_directory", "json_directory", "size",
        "save_all", "use_all_masks", "use_long_term", "mem_every",
    ]
    for key in potential_overrides:
        if cfg.get(key) is not None:
            data_cfg[key] = cfg[key]
        if key in data_cfg:
            cfg[key] = data_cfg[key]
    if data_cfg.get("use_long_term") is None:
        data_cfg["use_long_term"] = False
        cfg["use_long_term"] = cfg.get("use_long_term") or False
    return data_cfg
