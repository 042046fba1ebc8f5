"""Shape and probability utilities (NCHW).

The port's counterpart of cutie_tpu/ops/tensor_utils.py (reference
cutie/utils/tensor_utils.py:7-61). Spatial axes are the last two.
"""
from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def compute_pad(h: int, w: int, d: int) -> Tuple[int, int, int, int]:
    """Padding (lw, uw, lh, uh) that makes (h, w) divisible by d, split
    evenly with the extra pixel on the upper/right side."""
    new_h = h + (d - h % d) % d
    new_w = w + (d - w % d) % d
    lh = (new_h - h) // 2
    uh = (new_h - h) - lh
    lw = (new_w - w) // 2
    uw = (new_w - w) - lw
    return (lw, uw, lh, uh)


def pad_divide_by(x: torch.Tensor, d: int
                  ) -> Tuple[torch.Tensor, Tuple[int, int, int, int]]:
    """Zero-pad the last two axes of x to multiples of d."""
    pad = compute_pad(x.shape[-2], x.shape[-1], d)
    return F.pad(x, pad), pad


def unpad(x: torch.Tensor, pad: Sequence[int]) -> torch.Tensor:
    """Inverse of pad_divide_by. pad = (lw, uw, lh, uh)."""
    lw, uw, lh, uh = pad
    h, w = x.shape[-2], x.shape[-1]
    return x[..., lh:h - uh, lw:w - uw]


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """x clipped to [lo, hi], with jnp.clip's gradient: half of it at a
    value equal to a bound (torch.maximum and torch.minimum split a tie),
    where torch.clamp passes all of it. A sigmoid saturates onto the
    bound 1 - 1e-7 over a range of fp32 logits, so the training gradient
    sees the bounds often. The bounds are 0-dim CPU tensors of x's dtype,
    which a binary op on the card reads on the host: no upload, so no wait
    for the card and nothing a CUDA graph capture refuses."""
    return torch.minimum(torch.maximum(x, _host_scalar(lo, x.dtype)),
                         _host_scalar(hi, x.dtype))


@functools.lru_cache(maxsize=None)
def _host_scalar(value: float, dtype: torch.dtype) -> torch.Tensor:
    """A 0-dim CPU tensor, made once a value and dtype (never written)."""
    return torch.tensor(value, dtype=dtype)


def aggregate(prob: torch.Tensor, dim: int) -> torch.Tensor:
    """Soft aggregation: per-object probabilities -> (num_objects+1)-way
    logits with an implicit background channel prod(1-p), in fp32."""
    prob = prob.float()
    bg = torch.prod(1.0 - prob, dim=dim, keepdim=True)
    new_prob = clip(torch.cat([bg, prob], dim=dim), 1e-7, 1 - 1e-7)
    return torch.log(new_prob / (1.0 - new_prob))


def aggregate_wbg_np(prob: np.ndarray, keep_bg: bool = False,
                     hard: bool = False) -> np.ndarray:
    """Host-side soft aggregation + softmax: prob [K, H, W] -> softmax
    probabilities, with the background channel when keep_bg; `hard`
    applies the x1000 low temperature of the GUI's interactions
    (reference gui/interaction.py:15-27)."""
    prob = prob.astype(np.float32)
    bg = np.prod(1 - prob, axis=0, keepdims=True)
    new_prob = np.clip(np.concatenate([bg, prob], 0), 1e-7, 1 - 1e-7)
    logits = np.log(new_prob / (1 - new_prob))
    if hard:
        logits *= 1000  # very low temperature
    logits -= logits.max(0, keepdims=True)
    e = np.exp(logits)
    sm = e / e.sum(0, keepdims=True)
    return sm if keep_bg else sm[1:]
