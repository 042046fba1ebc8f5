"""Model construction and weight loading.

The port's counterpart of cutie_tpu/utils/get_default_model.py and of the
name mapping and object surgery in cutie_tpu/utils/weight_import.py. It
takes every weights file cutie_tpu's build_model takes (load_weights): a
reference .pth checkpoint, a reference state dict saved as npz (torch
names; the goldens' state_dict_*.npz), and cutie_tpu's trainer npz (flax
paths, converted with from_jax_variables).
"""
from __future__ import annotations

import hashlib
import logging
import os
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from cutie_tpu_torch.config import Config, eval_config, get_dataset_cfg
from cutie_tpu_torch.models import CUTIE

log = logging.getLogger(__name__)

_WEIGHT_URLS = {
    # mirrors reference cutie/utils/download_models.py:8-11
    "cutie-base-mega.pth":
        ("https://github.com/hkchengrex/Cutie/releases/download/v1.0/"
         "cutie-base-mega.pth", "a6071de6136982e396851903ab4c083a"),
}

# Reference checkpoint entries the port has no tensor for: BatchNorm step
# counters and positional-encoding frequency buffers (recomputed).
_SKIPPED_SUFFIXES = ("num_batches_tracked", "inv_freq")
# The training-only aux heads: a file without them still loads, and the
# heads keep their initialisation (inference never runs them).
_AUX_PREFIX = "aux_computer."


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
    _SKIPPED_SUFFIXES). Aux-head entries the file lacks keep the model's
    own. Values become fp32 tensors."""
    own = model.state_dict()
    out = {}
    for k, v in sd.items():
        if k.endswith(_SKIPPED_SUFFIXES):
            continue
        if k not in own:
            head, _, leaf = k.rpartition(".")
            if f"{head}.conv.{leaf}" in own:
                k = f"{head}.conv.{leaf}"
        out[k] = torch.from_numpy(np.asarray(v, np.float32))
    missing_aux = [k for k in own if k.startswith(_AUX_PREFIX) and k not in out]
    if missing_aux:
        log.info("No aux-head weights (%s); they keep their initialisation.",
                 ", ".join(missing_aux))
        out.update({k: own[k] for k in missing_aux})
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


def _orthogonal(shape, rng: np.random.Generator) -> np.ndarray:
    """numpy equivalent of torch.nn.init.orthogonal_ for a 4D conv pad block
    (cutie_tpu/utils/weight_import.py:_orthogonal, the same draws)."""
    rows = shape[0]
    cols = int(np.prod(shape[1:]))
    a = rng.normal(size=(max(rows, cols), min(rows, cols)))
    q, r = np.linalg.qr(a)
    q = q * np.sign(np.diagonal(r))
    q = q.T if rows < cols else q
    return q[:rows, :cols].reshape(shape).astype(np.float32)


# The sensory compression's weight: the reference's GConv2d name, and the
# port's (the name save_weights writes).
_SENSORY_COMPRESS = ("pixel_fuser.sensory_compress.weight",
                     "pixel_fuser.sensory_compress.conv.weight")


def apply_object_surgery(sd: Mapping[str, np.ndarray], single_object: bool,
                         sensory_dim: int, value_dim: int,
                         init_as_zero_if_needed: bool = False,
                         seed: int = 0) -> Dict[str, np.ndarray]:
    """Single <-> multi-object channel surgery (reference cutie.py:212-256;
    cutie_tpu/utils/weight_import.py:43-75, with the same numpy-seeded
    orthogonal pads, in adapt_variables_single_to_multi's order): a
    single-object checkpoint's mask encoder and sensory compression gain an
    input channel, a multi-object one's lose it. Takes the reference's and
    the port's names of the sensory compression."""
    sd = dict(sd)
    rng = np.random.default_rng(seed)
    conv1 = "mask_encoder.conv1.weight"
    compress = [k for k in _SENSORY_COMPRESS if k in sd]
    if not single_object:
        if conv1 in sd and sd[conv1].shape[1] == 4:
            log.info("Converting %s from single to multiple objects.", conv1)
            pads = (np.zeros((64, 1, 7, 7), np.float32) if init_as_zero_if_needed
                    else _orthogonal((64, 1, 7, 7), rng))
            sd[conv1] = np.concatenate([sd[conv1], pads], axis=1)
        for k in compress:
            if sd[k].shape[1] == sensory_dim + 1:
                log.info("Converting %s from single to multiple objects.", k)
                pads = (np.zeros((value_dim, 1, 1, 1), np.float32)
                        if init_as_zero_if_needed
                        else _orthogonal((value_dim, 1, 1, 1), rng))
                sd[k] = np.concatenate([sd[k], pads], axis=1)
    else:
        if conv1 in sd and sd[conv1].shape[1] == 5:
            log.warning("Converting %s from multiple objects to single object.",
                        conv1)
            sd[conv1] = sd[conv1][:, :-1]
        for k in compress:
            if sd[k].shape[1] == sensory_dim + 2:
                log.warning("Converting %s from multiple objects to single "
                            "object.", k)
                sd[k] = sd[k][:, :-1]
    return sd


def _unflatten(flat: Mapping[str, np.ndarray]) -> Dict[str, Any]:
    """cutie_tpu/training/trainer.py:load_weights_npz: 'a/b/c' keys -> a
    nested tree, fp16 storage widened to fp32."""
    tree: Dict[str, Any] = {}
    for k, v in flat.items():
        node = tree
        parts = k.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v.astype(np.float32) if v.dtype == np.float16 else v
    return tree


def load_weights(path: str, cfg: Config, single_object: bool = False
                 ) -> Dict[str, np.ndarray]:
    """A reference state dict (torch names, numpy values) from any weights
    file cutie_tpu's build_model takes (cutie_tpu/utils/get_default_model.py:
    54-96): cutie_tpu's trainer npz (flax paths 'params/...' and
    'batch_stats/...'), a torch-named npz, or a reference .pth (torch.load on
    the CPU, weights only, a training checkpoint's 'network' unwrapped). A
    torch-named state dict gets the object surgery for a multi-object
    model, or for a single-object one when single_object."""
    if path.endswith(".npz"):
        sd = load_torch_npz(path)
        if any(k.startswith(("params/", "batch_stats/")) for k in sd):
            return from_jax_variables(_unflatten(sd))
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
        if "network" in sd:
            sd = sd["network"]
        sd = {k: (v.float() if v.is_floating_point() else v).numpy()
              for k, v in sd.items()}
    return apply_object_surgery(sd, single_object, cfg.model.sensory_dim,
                                cfg.model.value_dim)


def build_model(cfg: Config, weights: Optional[str] = None,
                device: str = "cuda", *,
                state_dict: Optional[Mapping[str, np.ndarray]] = None,
                single_object: bool = False) -> CUTIE:
    """CUTIE in eval mode on `device` (default the card; a CPU model only
    when asked for), with weights from a file (load_weights) or an explicit
    numpy state dict in torch names; a weights path that does not exist
    leaves the random initialisation, with a warning, as cutie_tpu's
    build_model does. Raises if a CUDA device is asked for and there is
    none. Turns TF32 off: the port keeps cutie_tpu's fp32 precision map.
    cfg.amp=True or cfg.compute_dtype='bfloat16' builds the model with bf16
    conv and transformer stacks and fp32 islands, as cutie_tpu's
    build_model does (models/cutie.py); its parameters stay fp32.
    single_object builds the pre-training model (models/cutie.py); an
    explicit state_dict must already fit it (apply_object_surgery)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("build_model: a CUDA device was asked for and "
                           "torch.cuda.is_available() is False")
    set_fp32_precision()
    model = CUTIE(cfg, single_object)
    if weights and os.path.exists(weights):
        state_dict = load_weights(weights, cfg, single_object)
    elif weights:
        log.warning("Weights %s not found; using random init.", weights)
    if state_dict is not None:
        model.load_state_dict(adapt_state_dict(state_dict, model), strict=True)
    return model.to(device).eval()


def download_models_if_needed(weights_path: str) -> None:
    """Download and md5-check the released weights
    (reference download_models.py:13-32) when `weights_path` names one of
    them and is missing or corrupt; any other path is left alone."""
    import urllib.request

    if not weights_path:
        return
    name = os.path.basename(weights_path)
    if name not in _WEIGHT_URLS:
        return
    url, md5 = _WEIGHT_URLS[name]

    def md5_ok(p):
        with open(p, "rb") as f:
            return hashlib.md5(f.read()).hexdigest() == md5

    if os.path.exists(weights_path):
        if md5_ok(weights_path):
            return
        log.warning("md5 mismatch for existing %s; re-downloading.",
                    weights_path)
        os.remove(weights_path)
    os.makedirs(os.path.dirname(weights_path) or ".", exist_ok=True)
    tmp_path = weights_path + ".part"
    try:
        log.info("Downloading %s ...", url)
        urllib.request.urlretrieve(url, tmp_path)
    except OSError as e:
        if os.path.exists(tmp_path):
            os.remove(tmp_path)
        log.warning("Could not download weights (%s); continuing without.", e)
        return
    if not md5_ok(tmp_path):
        os.remove(tmp_path)
        raise RuntimeError(f"md5 mismatch for downloaded {weights_path}")
    os.replace(tmp_path, weights_path)


def get_default_model(weights: Optional[str] = None, device: str = "cuda"
                      ) -> Tuple[CUTIE, Config]:
    """The reference's default: cutie-base at the eval settings of the
    default dataset preset, on `device`. Returns (model, cfg); cfg goes to
    InferenceCore. Raises if the weights can neither be found nor
    downloaded."""
    cfg = eval_config("base")
    if weights is not None:
        cfg.weights = weights
    get_dataset_cfg(cfg)
    download_models_if_needed(cfg.weights)
    if not (cfg.weights and os.path.exists(str(cfg.weights))):
        raise FileNotFoundError(
            f"model weights not found at {cfg.weights!r} and could not be "
            f"downloaded; pass an explicit path (build_model(cfg) gives an "
            f"untrained model deliberately)")
    return build_model(cfg, cfg.weights, device), cfg
