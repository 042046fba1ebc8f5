"""Resize primitives matching the reference's F.interpolate modes (NCHW).

The port's counterpart of cutie_tpu/ops/resize.py. The reference only
area-downsamples by integer factors (2, 4, 16), where 'area' equals average
pooling, and upsamples bilinearly with align_corners=False, except in RITM
(HRNet's fusion, its logits, the click predictor's transforms), which
resizes with align_corners=True.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _as_4d(x: torch.Tensor):
    lead = x.shape[:-3]
    return x.reshape(-1, *x.shape[-3:]), lead


def bilinear_resize(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Half-pixel bilinear resize of the last two axes of [..., C, H, W]."""
    x4, lead = _as_4d(x)
    y = F.interpolate(x4, size=(out_h, out_w), mode="bilinear",
                      align_corners=False)
    return y.reshape(*lead, *y.shape[1:])


def upsample_2x(x: torch.Tensor) -> torch.Tensor:
    return bilinear_resize(x, x.shape[-2] * 2, x.shape[-1] * 2)


def upsample_4x(x: torch.Tensor) -> torch.Tensor:
    return bilinear_resize(x, x.shape[-2] * 4, x.shape[-1] * 4)


def area_downsample(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Average-pool the last two axes by an integer factor; equals
    F.interpolate(mode='area') for integer ratios. x: [..., H, W]."""
    h, w = x.shape[-2:]
    if h % factor or w % factor:
        raise ValueError(f"{(h, w)} is not divisible by {factor}")
    y = x.reshape(*x.shape[:-2], h // factor, factor, w // factor, factor)
    return y.mean(dim=(-3, -1))


def bilinear_resize_align_corners(x: torch.Tensor, out_h: int, out_w: int
                                  ) -> torch.Tensor:
    """Corner-aligned bilinear resize of the last two axes of [..., C, H, W]
    (F.interpolate(mode='bilinear', align_corners=True), the operator the
    reference calls)."""
    if tuple(x.shape[-2:]) == (out_h, out_w):
        return x
    x4, lead = _as_4d(x)
    y = F.interpolate(x4, size=(out_h, out_w), mode="bilinear",
                      align_corners=True)
    return y.reshape(*lead, *y.shape[1:])


def align_corners_matrix(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] align-corners interpolation matrix: row i holds the two
    taps of output coordinate i."""
    m = np.zeros((n_out, n_in), np.float32)
    if n_out == 1 or n_in == 1:
        m[:, 0] = 1.0
        return m
    ys = np.arange(n_out, dtype=np.float64) * ((n_in - 1) / (n_out - 1))
    y0 = np.clip(np.floor(ys).astype(np.int64), 0, n_in - 1)
    y1 = np.clip(y0 + 1, 0, n_in - 1)
    wy = (ys - y0).astype(np.float32)
    np.add.at(m, (np.arange(n_out), y0), 1.0 - wy)
    np.add.at(m, (np.arange(n_out), y1), wy)
    return m


def bilinear_resize_align_corners_mm(x: torch.Tensor, out_h: int, out_w: int
                                     ) -> torch.Tensor:
    """The same resize as two fp32 matmuls over [..., H, W] (the weights of
    bilinear_resize_align_corners up to summation order). Its backward is two
    matmuls again, with no scatter: the f-BRS objective differentiates it on
    every L-BFGS evaluation."""
    wy = torch.from_numpy(align_corners_matrix(x.shape[-2], out_h)).to(x.device)
    wx = torch.from_numpy(align_corners_matrix(x.shape[-1], out_w)).to(x.device)
    with torch.autocast(x.device.type, enabled=False):
        return wy @ x.float() @ wx.T


def nearest_exact_resize_np(mask: np.ndarray, out_h: int, out_w: int
                            ) -> np.ndarray:
    """numpy F.interpolate(mode='nearest-exact') for index masks [..., H, W]."""
    h, w = mask.shape[-2:]
    ys = np.clip(np.floor((np.arange(out_h) + 0.5) * h / out_h).astype(np.int64),
                 0, h - 1)
    xs = np.clip(np.floor((np.arange(out_w) + 0.5) * w / out_w).astype(np.int64),
                 0, w - 1)
    return mask[..., ys[:, None], xs[None, :]]
