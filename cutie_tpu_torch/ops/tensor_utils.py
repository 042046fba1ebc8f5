"""Shape and probability utilities (NCHW).

The port's counterpart of cutie_tpu/ops/tensor_utils.py (reference
cutie/utils/tensor_utils.py:7-61). Spatial axes are the last two.
"""
from __future__ import annotations

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


def aggregate(prob: torch.Tensor, dim: int) -> torch.Tensor:
    """Soft aggregation: per-object probabilities -> (num_objects+1)-way
    logits with an implicit background channel prod(1-p), in fp32."""
    prob = prob.float()
    bg = torch.prod(1.0 - prob, dim=dim, keepdim=True)
    new_prob = torch.cat([bg, prob], dim=dim).clamp(1e-7, 1 - 1e-7)
    return torch.log(new_prob / (1.0 - new_prob))


def aggregate_wbg_np(prob: np.ndarray, keep_bg: bool = False) -> np.ndarray:
    """Host-side soft aggregation + softmax: prob [K, H, W] -> softmax
    probabilities, with the background channel when keep_bg."""
    prob = prob.astype(np.float32)
    bg = np.prod(1 - prob, axis=0, keepdims=True)
    new_prob = np.clip(np.concatenate([bg, prob], 0), 1e-7, 1 - 1e-7)
    logits = np.log(new_prob / (1 - new_prob))
    logits -= logits.max(0, keepdims=True)
    e = np.exp(logits)
    sm = e / e.sum(0, keepdims=True)
    return sm if keep_bg else sm[1:]
