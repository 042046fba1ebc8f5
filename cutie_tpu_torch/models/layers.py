"""Primitive network modules (NCHW, group tensors [B, N, C, H, W]).

The port's counterpart of cutie_tpu/models/layers.py (reference
cutie/model/group_modules.py, channel_attn.py, modules.py). Module and
parameter names follow the reference's state dict.
"""
from __future__ import annotations

import math
from typing import List

import torch
import torch.nn as nn
import torch.nn.functional as F

from cutie_tpu_torch.ops.resize import area_downsample, upsample_2x


def flatten_group(g: torch.Tensor):
    return g.flatten(0, 1), g.shape[:2]


def unflatten_group(g: torch.Tensor, bn) -> torch.Tensor:
    return g.view(*bn, *g.shape[1:])


class FrozenBatchNorm(nn.Module):
    """BatchNorm with frozen statistics: an affine map with stored
    mean/var (the reference freezes both encoders' BN, big_modules.py)."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(features))
        self.register_buffer("bias", torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scale = self.weight / torch.sqrt(self.running_var + self.eps)
        shift = self.bias - self.running_mean * scale
        return x * scale[None, :, None, None] + shift[None, :, None, None]


class GConv2d(nn.Module):
    """Conv over a group tensor [B, N, C, H, W] (group_modules.py:33-37)."""

    def __init__(self, in_dim: int, out_dim: int, kernel_size: int,
                 padding: int = 0):
        super().__init__()
        self.conv = nn.Conv2d(in_dim, out_dim, kernel_size, padding=padding)

    def forward(self, g: torch.Tensor) -> torch.Tensor:
        flat, bn = flatten_group(g)
        return unflatten_group(self.conv(flat), bn)


class CAResBlock(nn.Module):
    """Residual block with ECA channel attention (channel_attn.py:7-39).
    Operates on flat [B', C, H, W]."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.conv1 = nn.Conv2d(in_dim, out_dim, 3, padding=1)
        self.conv2 = nn.Conv2d(out_dim, out_dim, 3, padding=1)
        t = int((abs(math.log2(out_dim)) + 1) // 2)
        k = t if t % 2 else t + 1
        self.conv = nn.Conv1d(1, 1, k, padding=(k - 1) // 2, bias=False)
        self.downsample = (nn.Conv2d(in_dim, out_dim, 1)
                           if in_dim != out_dim else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        r = x
        x = self.conv1(F.relu(x))
        x = self.conv2(F.relu(x))
        pooled = x.mean(dim=(2, 3))                           # [B', C]
        gate = torch.sigmoid(self.conv(pooled[:, None, :]))[:, 0]
        x = x * gate[:, :, None, None]
        return x + (r if self.downsample is None else self.downsample(r))


class GroupResBlock(nn.Module):
    """(group_modules.py:40-58)"""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.conv1 = nn.Conv2d(in_dim, out_dim, 3, padding=1)
        self.conv2 = nn.Conv2d(out_dim, out_dim, 3, padding=1)
        self.downsample = (nn.Conv2d(in_dim, out_dim, 1)
                           if in_dim != out_dim else None)

    def forward(self, g: torch.Tensor) -> torch.Tensor:
        flat, bn = flatten_group(g)
        out = self.conv2(F.relu(self.conv1(F.relu(flat))))
        if self.downsample is not None:
            flat = self.downsample(flat)
        return unflatten_group(out + flat, bn)


class MainToGroupDistributor(nn.Module):
    """Adds a shared feature [B, C, H, W] to every object of a group tensor
    (group_modules.py:74-99, method 'add'), after optional transforms."""

    def __init__(self, x_transform: nn.Module = None,
                 g_transform: nn.Module = None):
        super().__init__()
        self.x_transform = x_transform
        self.g_transform = g_transform

    def forward(self, x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        if self.x_transform is not None:
            x = self.x_transform(x)
        if self.g_transform is not None:
            g = self.g_transform(g)
        return x[:, None] + g


class GroupFeatureFusionBlock(nn.Module):
    """(group_modules.py:102-126)"""

    def __init__(self, x_in_dim: int, g_in_dim: int, out_dim: int):
        super().__init__()
        self.distributor = MainToGroupDistributor(
            x_transform=nn.Conv2d(x_in_dim, out_dim, 1),
            g_transform=GConv2d(g_in_dim, out_dim, 1))
        self.block1 = CAResBlock(out_dim, out_dim)
        self.block2 = CAResBlock(out_dim, out_dim)

    def forward(self, x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        g = self.distributor(x, g)
        flat, bn = flatten_group(g)
        return unflatten_group(self.block2(self.block1(flat)), bn)


def _recurrent_update(h: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """GRU-style update (modules.py:35-43) on [B, N, 3D, H, W], fp32."""
    dim = values.shape[2] // 3
    forget_gate = torch.sigmoid(values[:, :, :dim])
    update_gate = torch.sigmoid(values[:, :, dim:dim * 2])
    new_value = torch.tanh(values[:, :, dim * 2:])
    return forget_gate * h * (1 - update_gate) + update_gate * new_value


class SensoryUpdater(nn.Module):
    """Decoder-side multi-scale sensory GRU (modules.py:46-68), fp32."""

    def __init__(self, g_dims: List[int], mid_dim: int, sensory_dim: int):
        super().__init__()
        self.g16_conv = GConv2d(g_dims[0], mid_dim, 1)
        self.g8_conv = GConv2d(g_dims[1], mid_dim, 1)
        self.g4_conv = GConv2d(g_dims[2], mid_dim, 1)
        self.transform = GConv2d(mid_dim + sensory_dim, sensory_dim * 3, 3,
                                 padding=1)

    def forward(self, g: List[torch.Tensor], h: torch.Tensor) -> torch.Tensor:
        g = (self.g16_conv(g[0]) + self.g8_conv(area_downsample(g[1], 2))
             + self.g4_conv(area_downsample(g[2], 4)))
        values = self.transform(torch.cat([g.float(), h.float()], dim=2))
        return _recurrent_update(h.float(), values)


class SensoryDeepUpdater(nn.Module):
    """Mask-encoder-side sensory GRU (modules.py:71-85), fp32."""

    def __init__(self, f_dim: int, sensory_dim: int):
        super().__init__()
        self.transform = GConv2d(f_dim + sensory_dim, sensory_dim * 3, 3,
                                 padding=1)

    def forward(self, g: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        values = self.transform(torch.cat([g.float(), h.float()], dim=2))
        return _recurrent_update(h.float(), values)


class MaskUpsampleBlock(nn.Module):
    """2x bilinear upsample + skip add + GroupResBlock (modules.py:8-19)."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.distributor = MainToGroupDistributor()
        self.out_conv = GroupResBlock(in_dim, out_dim)

    def forward(self, in_g: torch.Tensor, skip_f: torch.Tensor) -> torch.Tensor:
        g = upsample_2x(in_g)
        return self.out_conv(self.distributor(skip_f, g))
