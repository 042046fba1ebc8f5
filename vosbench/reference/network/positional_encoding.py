"""Frozen copy of cutie_tpu_torch/models/positional_encoding.py for the benchmark's plain
reference (vosbench/reference): later changes to the port do not reach it.

2D sine/cosine positional encoding (Mask2Former style).

The port's counterpart of cutie_tpu/models/positional_encoding.py (reference
cutie/model/transformer/positional_encoding.py:12-97): a pure function of
the spatial shape, computed with numpy.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch


@functools.lru_cache(maxsize=64)
def _pos_enc_np(h: int, w: int, dim: int, scale: float,
                temperature: float) -> np.ndarray:
    """[dim, H, W] for dim % 4 == 0."""
    d = int(np.ceil(dim / 4) * 2)
    inv_freq = 1.0 / (temperature ** (np.arange(0, d, 2, dtype=np.float32) / d))
    eps = 1e-6
    pos_y = np.arange(h, dtype=np.float32)
    pos_x = np.arange(w, dtype=np.float32)
    pos_y = pos_y / (pos_y[-1] + eps) * scale
    pos_x = pos_x / (pos_x[-1] + eps) * scale
    sin_inp_y = np.einsum("i,j->ij", pos_y, inv_freq)
    sin_inp_x = np.einsum("i,j->ij", pos_x, inv_freq)

    def get_emb(sin_inp):
        emb = np.stack([np.sin(sin_inp), np.cos(sin_inp)], axis=-1)
        return emb.reshape(*emb.shape[:-2], -1)

    emb = np.zeros((h, w, d * 2), dtype=np.float32)
    emb[:, :, :d] = get_emb(sin_inp_x)[None, :, :]
    emb[:, :, d:] = get_emb(sin_inp_y)[:, None, :]
    return np.ascontiguousarray(emb.transpose(2, 0, 1))


def positional_encoding(h: int, w: int, dim: int, scale: float = 2 * math.pi,
                        temperature: float = 10000.0,
                        device=None) -> torch.Tensor:
    """[dim, H, W] fp32 positional encoding."""
    return torch.from_numpy(_pos_enc_np(h, w, dim, float(scale),
                                        float(temperature))).to(device)
