"""Model construction and weight loading.

The port's counterpart of cutie_tpu/utils/get_default_model.py and of the
name mapping in cutie_tpu/utils/weight_import.py. Weights are numpy npz
files: either a reference state dict (the goldens' state_dict_*.npz, torch
names) or cutie_tpu's flax variables converted with from_jax_variables.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from cutie_tpu_torch.config import Config
from cutie_tpu_torch.models import CUTIE

# Reference checkpoint entries the port has no tensor for: BatchNorm step
# counters, positional-encoding frequency buffers (recomputed), and the
# training-only aux heads (ported with training).
_SKIPPED_SUFFIXES = ("num_batches_tracked", "inv_freq")
_SKIPPED_PREFIXES = ("aux_computer.",)


def set_fp32_precision() -> None:
    """Exact fp32 on the card: no TF32 in matmuls, and none in cuDNN
    convolutions, where PyTorch enables it by default."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def load_torch_npz(path: str) -> Dict[str, np.ndarray]:
    """A reference state dict saved as npz (torch names), as numpy arrays."""
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def adapt_state_dict(sd: Mapping[str, np.ndarray], model: torch.nn.Module
                     ) -> Dict[str, torch.Tensor]:
    """Reference names -> this model's names. Older reference checkpoints
    name a GConv2d's weight `x.weight` where newer ones (and the port) use
    `x.conv.weight`; entries without a counterpart are dropped (see
    _SKIPPED_*). Values become fp32 tensors."""
    own = model.state_dict()
    out = {}
    for k, v in sd.items():
        if k.endswith(_SKIPPED_SUFFIXES) or k.startswith(_SKIPPED_PREFIXES):
            continue
        if k not in own:
            head, _, leaf = k.rpartition(".")
            if f"{head}.conv.{leaf}" in own:
                k = f"{head}.conv.{leaf}"
        out[k] = torch.from_numpy(np.asarray(v, np.float32))
    return out


def _torch_path(path: Tuple[str, ...]) -> Tuple[str, ...]:
    """cutie_tpu flax module path -> reference/port module path (the rules
    of cutie_tpu/utils/weight_import.py:_torch_key_candidates)."""
    out = []
    for s in path:
        if s == "trunk":
            continue
        if s.startswith("layer") and "_" in s:
            base, idx = s.split("_")
            if base == "layer1" and out and out[0] == "pixel_encoder":
                base = "res2"
            out += [base, idx]
        elif s == "downsample_conv":
            out += ["downsample", "0"]
        elif s == "downsample_bn":
            out += ["downsample", "1"]
        elif s.startswith("block_"):
            out += ["blocks", s.rsplit("_", 1)[1]]
        elif s.startswith("mask_pred_"):
            out += ["mask_pred", s.rsplit("_", 1)[1], "1"]
        elif s.startswith("decoder_feat_proc_"):
            out += ["decoder_feat_proc", "transforms", s.rsplit("_", 1)[1]]
        elif s in ("feature_pred_0", "feature_pred_2", "weights_pred_0",
                   "weights_pred_2"):
            out += list(s.rsplit("_", 1))
        elif s in ("x_transform", "g_transform"):
            out += ["distributor", s]
        else:
            out.append(s)
    return tuple(out)


def _flat(tree, prefix=()):
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            yield from _flat(v, prefix + (k,))
    else:
        yield prefix, np.asarray(tree, np.float32)


def from_jax_variables(variables_np: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """cutie_tpu's flax variables {'params', 'batch_stats'} (numpy leaves)
    -> the port's state dict (numpy), inverting
    cutie_tpu/utils/weight_import.py:convert_torch_state_dict: HWIO conv
    kernels -> OIHW, [in, out] dense kernels -> [out, in], q/k/v projections
    packed into in_proj_weight / in_proj_bias."""
    out: Dict[str, np.ndarray] = {}
    qkv: Dict[str, Dict[Tuple[str, str], np.ndarray]] = {}
    for collection in ("params", "batch_stats"):
        for path, value in _flat(variables_np.get(collection, {})):
            mod, leaf = _torch_path(path[:-1]), path[-1]
            if mod and mod[0] == "aux_computer":
                continue
            name = ".".join(mod)
            if collection == "batch_stats":
                out[f"{name}.running_{leaf}"] = value
            elif mod and mod[-1] in ("q", "k", "v"):
                qkv.setdefault(".".join(mod[:-1]), {})[(mod[-1], leaf)] = value
            elif leaf == "kernel":
                w = (value.transpose(3, 2, 0, 1) if value.ndim == 4
                     else value.T if value.ndim == 2 else value)
                out[f"{name}.weight"] = w
            elif leaf == "scale":
                out[f"{name}.weight"] = value
            elif leaf == "bias":
                out[f"{name}.bias"] = value
            elif leaf == "conv" and value.ndim == 3:   # ECA conv1d [k,1,1]
                out[f"{name}.conv.weight"] = value.transpose(2, 1, 0)
            elif leaf in ("query_init", "query_emb"):
                out[f"{name}.{leaf}.weight"] = value
            else:
                raise ValueError(f"unmapped variable {collection}/{'/'.join(path)}")
    for base, parts in qkv.items():
        out[f"{base}.in_proj_weight"] = np.concatenate(
            [parts[(x, "kernel")].T for x in "qkv"], axis=0)
        out[f"{base}.in_proj_bias"] = np.concatenate(
            [parts[(x, "bias")] for x in "qkv"], axis=0)
    return out


def build_model(cfg: Config, weights_npz: Optional[str] = None,
                device: str = "cuda", *,
                state_dict: Optional[Mapping[str, np.ndarray]] = None
                ) -> CUTIE:
    """CUTIE in eval mode on `device` (default the card; a CPU model only
    when asked for), with weights from a reference npz state dict or an
    explicit numpy state dict. Raises if a CUDA device is asked for and
    there is none. Turns TF32 off: the port keeps cutie_tpu's fp32
    precision map."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("build_model: a CUDA device was asked for and "
                           "torch.cuda.is_available() is False")
    if cfg.get("amp", False):
        raise NotImplementedError("amp (bf16) inference is not ported yet")
    set_fp32_precision()
    model = CUTIE(cfg)
    if weights_npz is not None:
        state_dict = load_torch_npz(weights_npz)
    if state_dict is not None:
        model.load_state_dict(adapt_state_dict(state_dict, model), strict=True)
    return model.to(device).eval()
