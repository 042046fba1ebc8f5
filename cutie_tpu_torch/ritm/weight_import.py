"""RITM weights for the port's models.

The port's modules carry the reference's torch names, so a reference state
dict (a .pth checkpoint, or tests/golden/ritm_state_dict.npz) loads with
load_state_dict(strict=True) as it is; only BatchNorm's
num_batches_tracked counters, which nothing in eval mode reads, are
dropped (state_dict_tensors).

from_jax_variables is the inverse of cutie_tpu/ritm/weight_import.py:
convert_ritm_state_dict: cutie_tpu's flax RITM variables (HRNet or
DeepLab), as numpy arrays, to the port's state dict. It keeps its own copy
of that module's name mapping (torch_candidates); the port imports nothing
of cutie_tpu.
"""
from __future__ import annotations

import json
import logging
import re
from typing import Any, Dict, Iterator, List, Mapping, Tuple

import numpy as np
import torch

log = logging.getLogger(__name__)

SKIPPED_SUFFIX = "num_batches_tracked"


def state_dict_tensors(sd: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A reference state dict (numpy arrays or tensors) as fp32 tensors,
    without num_batches_tracked."""
    return {k: torch.as_tensor(np.asarray(v), dtype=torch.float32)
            for k, v in sd.items() if not k.endswith(SKIPPED_SUFFIX)}


def load_ritm_checkpoint(path: str) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
    """A RITM .pth -> (its state dict as numpy arrays, its config: a dict
    with 'class' and 'params', or {} when the file holds none). The .pth is
    read in torch.load's weights_only mode (tensors and the serialized
    config); a file that needs full unpickling is refused. A .npz is a
    state dict in the reference's names with no config
    (tests/golden/ritm_state_dict.npz)."""
    if str(path).endswith(".npz"):
        with np.load(path) as z:
            return {k: z[k] for k in z.files}, {}
    raw = torch.load(path, map_location="cpu", weights_only=True)
    config: Dict[str, Any] = {}
    if isinstance(raw, dict) and "config" in raw:
        config = raw["config"]
        if isinstance(config, str):
            config = json.loads(config)
    sd = raw.get("state_dict", raw) if isinstance(raw, dict) else raw
    return ({k: v.numpy() for k, v in sd.items() if isinstance(v, torch.Tensor)},
            config)


# ---------------------------------------------------- cutie_tpu's flax names

def torch_candidates(path: Tuple[str, ...]) -> List[Tuple[str, str]]:
    """A flax parameter path of cutie_tpu's RITM models -> the (torch module
    path, parameter name) pairs it may correspond to, in order (the copy of
    cutie_tpu/ritm/weight_import.py:_candidates)."""
    segs = list(path[:-1])
    leaf = path[-1]
    if leaf in ("kernel", "scale"):
        pname = "weight"
    elif leaf == "bias":
        pname = "bias"
    elif leaf in ("mean", "var"):
        pname = {"mean": "running_mean", "var": "running_var"}[leaf]
    elif leaf == "maps_transform_3_scale":
        return [("maps_transform.3", "scale")]
    else:
        pname = leaf

    options: List[List[str]] = [[]]

    def extend_all(*variants: List[str]):
        nonlocal options
        options = [o + v for o in options for v in variants]

    for s in segs:
        if s in ("bb", "hd"):  # cutie_tpu's flax-only backbone/head split
            continue
        m = re.fullmatch(r"(stage\d|layer\d)_(\d+)", s)
        if m:
            extend_all([m.group(1), m.group(2)])
            continue
        m = re.fullmatch(r"branches_(\d+)_(\d+)", s)
        if m:
            extend_all(["branches", m.group(1), m.group(2)])
            continue
        if s in ("downsample_conv", "downsample_bn"):
            extend_all(["downsample", "0" if s.endswith("conv") else "1"])
            continue
        m = re.fullmatch(r"fuse_(\d+)_(\d+)_(\d+)_(conv|bn)", s)
        if m:
            i, j, k, kind = m.groups()
            extend_all(["fuse_layers", i, j, k, "0" if kind == "conv" else "1"])
            continue
        m = re.fullmatch(r"fuse_(\d+)_(\d+)_(conv|bn)", s)
        if m:
            i, j, kind = m.groups()
            extend_all(["fuse_layers", i, j, "0" if kind == "conv" else "1"])
            continue
        m = re.fullmatch(r"(transition\d)_(\d+)_(\d+)_(conv|bn)", s)
        if m:
            t, i, j, kind = m.groups()
            idx = "0" if kind == "conv" else "1"
            # a new branch nests Sequential(conv, bn, relu) in a Sequential
            extend_all([t, i, j, idx], [t, i, idx])
            continue
        m = re.fullmatch(r"(f_pixel|f_object|f_down|f_up)_(\d+)_(conv|bn)", s)
        if m:
            name, k, kind = m.groups()
            k = int(k)
            # the norm sits in Sequential(norm, relu) at the odd indices
            extend_all([name, str(2 * k)] if kind == "conv"
                       else [name, str(2 * k + 1), "0"])
            continue
        # ---- DeepLabV3+ flavour
        m = re.fullmatch(r"conv1_(\d+)", s)
        if m:  # the deep stem's Sequential
            extend_all(["conv1", m.group(1)])
            continue
        if s in ("skip_project_0_conv", "skip_project_0_bn"):
            extend_all(["skip_project", "skip_project",
                        "0" if s.endswith("conv") else "1"])
            continue
        m = re.fullmatch(r"b([0-3])_0_(conv|bn)", s)
        if m:  # ASPP branches
            extend_all(["concurent", m.group(1), "0" if m.group(2) == "conv" else "1"])
            continue
        m = re.fullmatch(r"b4_gap_(conv|bn)", s)
        if m:  # ASPP pooling branch (pool 0, conv 1, bn 2)
            extend_all(["concurent", "4", "gap", "1" if m.group(1) == "conv" else "2"])
            continue
        m = re.fullmatch(r"project_0_(conv|bn)", s)
        if m:
            extend_all(["project", "0" if m.group(1) == "conv" else "1"])
            continue
        m = re.fullmatch(r"(sep_)?head_([012])", s)
        if m:
            seq = ["head", "layers"] if m.group(1) else ["head", "block"]
            extend_all(seq + [m.group(2)] + (["body"] if m.group(2) != "2" else []))
            continue
        if s in ("dw", "pw"):
            extend_all(["0" if s == "dw" else "1"])
            continue
        if s == "bn" and options and options[0] and options[0][-1] == "body":
            extend_all(["2"])
            continue
        m = re.fullmatch(r"(conv_bn_dropout|aux_head|conv3x3_ocr|cls_head|rgb_conv"
                         r"|maps_transform)_(\d+)_?(conv|bn)?", s)
        if m:
            name, k, kind = m.groups()
            if kind == "bn":
                # conv_bn_dropout's norm is wrapped; the heads' are flat
                extend_all([name, str(int(k) + 1), "0"], [name, str(int(k) + 1)])
            else:
                extend_all([name, k])
            continue
        options = [o + [s] for o in options]

    return [(".".join(o), pname) for o in options]


def _flat(tree, prefix=()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            yield from _flat(v, prefix + (k,))
    else:
        yield prefix, tree


def from_jax_variables(variables: Mapping[str, Any], model: torch.nn.Module
                       ) -> Dict[str, torch.Tensor]:
    """cutie_tpu's flax RITM variables ({'params', 'batch_stats'} of numpy
    arrays; HRNet or DeepLab) -> a state dict of `model` (load it with
    strict=True). Conv kernels HWIO -> OIHW, dense kernels transposed.
    Raises if a leaf has no counterpart in the model, a shape differs, or
    an entry of the model is left without a value."""
    own = model.state_dict()
    out: Dict[str, torch.Tensor] = {}
    for collection in ("params", "batch_stats"):
        for path, value in _flat(variables.get(collection, {})):
            key = next((f"{mod}.{p}" for mod, p in torch_candidates(path)
                        if f"{mod}.{p}" in own), None)
            if key is None:
                raise KeyError(f"{collection}/{'/'.join(path)} has no counterpart "
                               f"in {type(model).__name__}")
            value = np.asarray(value, np.float32)
            if value.ndim == 4:
                value = value.transpose(3, 2, 0, 1)
            elif value.ndim == 2:
                value = value.T
            if tuple(value.shape) != tuple(own[key].shape):
                raise ValueError(f"{key}: {value.shape} against {tuple(own[key].shape)}")
            out[key] = torch.from_numpy(np.ascontiguousarray(value))
    missing = sorted(k for k in own if k not in out)
    if missing:
        raise KeyError(f"no flax leaf for {missing[:8]}")
    return out
