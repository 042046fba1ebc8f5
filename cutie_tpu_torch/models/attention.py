"""Transformer layers of the object transformer.

The port's counterpart of cutie_tpu/models/attention.py (reference
cutie/model/transformer/transformer_layers.py:12-161): pre-norm residual
self/cross attention, FFN and PixelFFN. The multi-head attention keeps
nn.MultiheadAttention's parameter names (packed in_proj, out_proj) and
computes its softmax in fp32.
"""
from __future__ import annotations

import math
from typing import List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from cutie_tpu_torch.models.layers import CAResBlock

NEG_INF = -1e30


class MultiheadAttention(nn.Module):
    """q [B, Lq, E], k/v [B, Lk, E], mask bool [B, H, Lq, Lk] (True = blocked)."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = nn.Linear(dim, dim)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, q, k, v, mask: Optional[torch.Tensor] = None):
        e = q.shape[-1]
        h = self.num_heads
        wq, wk, wv = self.in_proj_weight.chunk(3)
        bq, bk, bv = self.in_proj_bias.chunk(3)

        def split(x, w, b):
            x = F.linear(x, w, b)
            return x.view(*x.shape[:-1], h, e // h).transpose(-3, -2)

        q, k, v = split(q, wq, bq), split(k, wk, bk), split(v, wv, bv)
        logits = (q @ k.transpose(-1, -2)).float() / math.sqrt(e // h)
        if mask is not None:
            logits = logits.masked_fill(mask, NEG_INF)
        out = torch.softmax(logits, dim=-1).to(v.dtype) @ v
        out = out.transpose(-3, -2).reshape(*out.shape[:-3], out.shape[-2], e)
        return self.out_proj(out)


class SelfAttention(nn.Module):
    """Pre-norm residual self-attention (transformer_layers.py:12-41)."""

    def __init__(self, dim: int, num_heads: int, add_pe_to_qkv: List[bool]):
        super().__init__()
        self.add_pe_to_qkv = list(add_pe_to_qkv)
        self.norm = nn.LayerNorm(dim)
        self.self_attn = MultiheadAttention(dim, num_heads)

    def forward(self, x, pe):
        x = self.norm(x)
        x_pe = x + pe
        q, k, v = (x_pe if a else x for a in self.add_pe_to_qkv)
        return x + self.self_attn(q, k, v)


class CrossAttention(nn.Module):
    """Pre-norm residual cross-attention (transformer_layers.py:45-98)."""

    def __init__(self, dim: int, num_heads: int, add_pe_to_qkv: List[bool],
                 norm: bool = True):
        super().__init__()
        self.add_pe_to_qkv = list(add_pe_to_qkv)
        self.norm = nn.LayerNorm(dim) if norm else None
        self.cross_attn = MultiheadAttention(dim, num_heads)

    def forward(self, x, mem, x_pe, mem_pe, attn_mask=None):
        if self.norm is not None:
            x = self.norm(x)
        q = x + x_pe if self.add_pe_to_qkv[0] else x
        mem_pe_added = mem + mem_pe
        k = mem_pe_added if self.add_pe_to_qkv[1] else mem
        v = mem_pe_added if self.add_pe_to_qkv[2] else mem
        return x + self.cross_attn(q, k, v, mask=attn_mask)


class FFN(nn.Module):
    """Pre-norm residual MLP (transformer_layers.py:101-118)."""

    def __init__(self, dim_in: int, dim_ff: int):
        super().__init__()
        self.norm = nn.LayerNorm(dim_in)
        self.linear1 = nn.Linear(dim_in, dim_ff)
        self.linear2 = nn.Linear(dim_ff, dim_in)

    def forward(self, x):
        return x + self.linear2(F.relu(self.linear1(self.norm(x))))


class PixelFFN(nn.Module):
    """CAResBlock over the pixel map (transformer_layers.py:121-136).
    pixel [B, N, C, H, W]; pixel_flat [B*N, H*W, C]."""

    def __init__(self, dim: int):
        super().__init__()
        self.conv = CAResBlock(dim, dim)

    def forward(self, pixel, pixel_flat):
        bs, num_objects, c, h, w = pixel.shape
        x = pixel_flat.view(bs * num_objects, h, w, c).permute(0, 3, 1, 2)
        return self.conv(x).view(bs, num_objects, c, h, w)
