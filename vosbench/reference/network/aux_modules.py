"""Frozen copy of cutie_tpu_torch/models/aux_modules.py for the benchmark's plain
reference (vosbench/reference): later changes to the port do not reach it.

Auxiliary output heads for the training losses.

The port's counterpart of cutie_tpu/models/aux_modules.py (reference
cutie/model/aux_modules.py:13-79). Parameter names follow the reference's
state dict: aux_computer.sensory_aux.projection.conv.{weight,bias}.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn

from vosbench.reference.network.layers import GConv2d, fp32_island
from vosbench.reference.network.tensor_utils import aggregate


class LinearPredictor(nn.Module):
    """sensory -> a per-pixel linear classifier against pix_feat
    (aux_modules.py:13-26)."""

    def __init__(self, x_dim: int, pix_dim: int):
        super().__init__()
        self.projection = GConv2d(x_dim, pix_dim + 1, 1)

    def forward(self, pix_feat: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """pix_feat [B, C, h, w]; x [B, N, x_dim, h, w] -> logits [B, N, h, w]."""
        x = self.projection(x)
        return (pix_feat[:, None] * x[:, :, :-1]).sum(dim=2) + x[:, :, -1]


def _aggregate_with_selector(logits: torch.Tensor,
                             selector: Optional[torch.Tensor]) -> torch.Tensor:
    """sigmoid, zero the padded objects, then the soft aggregate with a
    background channel, in fp32: [B, N, ...] -> [B, N + 1, ...]."""
    with fp32_island(logits):
        prob = torch.sigmoid(logits.float())
        if selector is not None:
            prob = prob * selector.view(*selector.shape,
                                        *([1] * (prob.dim() - selector.dim())))
        return aggregate(prob, dim=1)


class AuxComputer(nn.Module):
    """(aux_modules.py:40-79)"""

    def __init__(self, cfg: Config):
        super().__init__()
        model_cfg = cfg.model
        self.sensory_enabled = model_cfg.aux_loss.sensory.enabled
        self.query_enabled = model_cfg.aux_loss.query.enabled
        if self.sensory_enabled:
            self.sensory_aux = LinearPredictor(model_cfg.sensory_dim,
                                               model_cfg.embed_dim)

    def forward(self, pix_feat: torch.Tensor, aux_input: Dict[str, torch.Tensor],
                selector: Optional[torch.Tensor]) -> Dict[str, torch.Tensor]:
        """aux_input: {'sensory' [B, N, Cs, h, w], 'q_logits' [B, N, L, h, w]
        or None, 'attn_mask'}. Returns {'sensory_logits' [B, N+1, h, w],
        'q_logits' [B, N+1, L, h, w], 'attn_mask'} (those enabled)."""
        aux_output: Dict[str, torch.Tensor] = {}
        if "attn_mask" in aux_input:
            aux_output["attn_mask"] = aux_input["attn_mask"]
        if self.sensory_enabled:
            logits = self.sensory_aux(pix_feat, aux_input["sensory"])
            aux_output["sensory_logits"] = _aggregate_with_selector(logits,
                                                                    selector)
        if self.query_enabled and aux_input.get("q_logits") is not None:
            aux_output["q_logits"] = _aggregate_with_selector(
                aux_input["q_logits"], selector)
        return aux_output
