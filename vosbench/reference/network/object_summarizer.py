"""Frozen copy of cutie_tpu_torch/models/object_summarizer.py for the benchmark's plain
reference (vosbench/reference): later changes to the port do not reach it.

Object summarizer: pools mask-encoder values into per-object summary
tokens.

The port's counterpart of cutie_tpu/models/object_summarizer.py (reference
cutie/model/transformer/object_summarizer.py:10-89). The output is
cat(sums, area) [B, N, Q, E+1], so that the caller keeps a streaming
average. The pooling is fp32.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from vosbench.reference.network.layers import fp32_island
from vosbench.reference.network.positional_encoding import positional_encoding
from vosbench.reference.network.resize import area_downsample


class ObjectSummarizer(nn.Module):

    def __init__(self, model_cfg: Config):
        super().__init__()
        cfg = model_cfg.object_summarizer
        self.value_dim = model_cfg.value_dim
        self.embed_dim = cfg.embed_dim
        self.num_summaries = cfg.num_summaries
        self.add_pe = cfg.add_pe
        self.pe_scale = model_cfg.pixel_pe_scale
        self.pe_temperature = model_cfg.pixel_pe_temperature
        self.input_proj = nn.Linear(self.value_dim, self.embed_dim)
        self.feature_pred = nn.Sequential(
            nn.Linear(self.embed_dim, self.embed_dim), nn.ReLU(inplace=True),
            nn.Linear(self.embed_dim, self.embed_dim))
        self.weights_pred = nn.Sequential(
            nn.Linear(self.embed_dim, self.embed_dim), nn.ReLU(inplace=True),
            nn.Linear(self.embed_dim, self.num_summaries))

    def forward(self, masks: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
        """masks [B, N, H0, W0] at full padded resolution; value
        [B, N, Cv, h, w]. Returns the summaries [B, N, Q, E+1]."""
        h, w = value.shape[-2:]
        masks = area_downsample(masks, masks.shape[-1] // w)[..., None]
        half = self.num_summaries // 2
        repeated_masks = torch.cat([masks.expand(*masks.shape[:-1], half),
                                    (1 - masks).expand(*masks.shape[:-1], half)],
                                   dim=-1)                      # [B,N,h,w,Q]
        value = self.input_proj(value.permute(0, 1, 3, 4, 2))     # [B,N,h,w,E]
        if self.add_pe:
            pe = positional_encoding(h, w, self.embed_dim, self.pe_scale,
                                     self.pe_temperature, device=value.device)
            value = value + pe.permute(1, 2, 0)
        with fp32_island(value):
            value = value.float()
            feature = self.feature_pred(value)
            weights = torch.sigmoid(self.weights_pred(value)) * repeated_masks.float()
            sums = torch.einsum("bkhwq,bkhwc->bkqc", weights, feature)
            area = weights.sum(dim=(2, 3))[..., None]
            summaries = torch.cat([sums, area], dim=-1)
        return summaries
