"""Object (query) transformer: reads memory at the object level.

The port's counterpart of cutie_tpu/models/object_transformer.py (reference
cutie/model/transformer/object_transformer.py:12-205), with the fg/bg
masked attention between blocks.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from cutie_tpu_torch.config import Config
from cutie_tpu_torch.models.attention import (FFN, CrossAttention, PixelFFN,
                                              SelfAttention)
from cutie_tpu_torch.models.layers import GConv2d
from cutie_tpu_torch.models.positional_encoding import positional_encoding
from cutie_tpu_torch.ops.tensor_utils import aggregate


class QueryTransformerBlock(nn.Module):

    def __init__(self, model_cfg: Config):
        super().__init__()
        cfg = model_cfg.object_transformer
        e, heads = cfg.embed_dim, cfg.num_heads
        self.embed_dim = e
        self.read_from_pixel = CrossAttention(
            e, heads, cfg.read_from_pixel.add_pe_to_qkv)
        self.self_attn = SelfAttention(e, heads,
                                       cfg.query_self_attention.add_pe_to_qkv)
        self.ffn = FFN(e, cfg.ff_dim)
        self.read_from_query = CrossAttention(
            e, heads, cfg.read_from_query.add_pe_to_qkv,
            norm=cfg.read_from_query.output_norm)
        self.pixel_ffn = PixelFFN(e)

    def forward(self, x, pixel, query_pe, pixel_pe, attn_mask):
        """x [B*N, Q, E]; pixel [B, N, E, H, W]; query_pe [B*N, Q, E];
        pixel_pe [B*N, H*W, E]; attn_mask bool [B*N, heads, Q, H*W]."""
        bs, num_objects, e, h, w = pixel.shape
        pixel_flat = pixel.flatten(3).flatten(0, 1).transpose(1, 2)
        x = self.read_from_pixel(x, pixel_flat, query_pe, pixel_pe,
                                 attn_mask=attn_mask)
        x = self.self_attn(x, query_pe)
        x = self.ffn(x)
        pixel_flat = self.read_from_query(pixel_flat, x, pixel_pe, query_pe)
        return x, self.pixel_ffn(pixel, pixel_flat)


class QueryTransformer(nn.Module):

    def __init__(self, model_cfg: Config):
        super().__init__()
        cfg = model_cfg.object_transformer
        self.embed_dim = e = cfg.embed_dim
        self.num_heads = cfg.num_heads
        self.num_queries = cfg.num_queries
        self.pe_scale = model_cfg.pixel_pe_scale
        self.pe_temperature = model_cfg.pixel_pe_temperature
        self.query_init = nn.Embedding(self.num_queries, e)
        self.query_emb = nn.Embedding(self.num_queries, e)
        self.summary_to_query_init = nn.Linear(e, e)
        self.summary_to_query_emb = nn.Linear(e, e)
        self.pixel_init_proj = GConv2d(e, e, 1)
        self.pixel_emb_proj = GConv2d(e, e, 1)
        self.blocks = nn.ModuleList(QueryTransformerBlock(model_cfg)
                                    for _ in range(cfg.num_blocks))
        self.mask_pred = nn.ModuleList(
            nn.Sequential(nn.ReLU(), GConv2d(e, 1, 1))
            for _ in range(cfg.num_blocks + 1))

    def forward(self, pixel: torch.Tensor, obj_summaries: torch.Tensor,
                selector: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """pixel [B, N, E, H, W]; obj_summaries [B, N, T, Q, E+1];
        selector [B, N] in {0, 1} or None (masks padded object slots).
        Returns (pixel [B, N, E, H, W], {'logits': [B, N, L, H, W],
        'attn_mask': ...})."""
        e, q = self.embed_dim, self.num_queries
        bs, num_objects, _, h, w = pixel.shape
        summ = obj_summaries.reshape(bs * num_objects, -1, q, e + 1)
        obj_sums = summ[..., :-1].sum(dim=1)
        obj_area = summ[..., -1:].sum(dim=1)
        obj_values = obj_sums / (obj_area + 1e-4)
        query = self.query_init.weight[None] + self.summary_to_query_init(obj_values)
        query_emb = self.query_emb.weight[None] + self.summary_to_query_emb(obj_values)

        pixel_init = self.pixel_init_proj(pixel)
        pixel_emb = self.pixel_emb_proj(pixel)
        spatial_pe = positional_encoding(h, w, e, self.pe_scale,
                                         self.pe_temperature, device=pixel.device)
        pixel_emb = pixel_emb.flatten(3).flatten(0, 1).transpose(1, 2)
        pixel_pe = spatial_pe.flatten(1).T[None] + pixel_emb

        pixel = pixel_init
        aux_logits = [self.mask_pred[0](pixel)[:, :, 0]]
        attn_mask = self._get_aux_mask(aux_logits[-1], selector)
        for i, block in enumerate(self.blocks):
            query, pixel = block(query, pixel, query_emb, pixel_pe, attn_mask)
            aux_logits.append(self.mask_pred[i + 1](pixel)[:, :, 0])
            attn_mask = self._get_aux_mask(aux_logits[-1], selector)
        return pixel, {"logits": torch.stack(aux_logits, dim=2),
                       "attn_mask": attn_mask}

    def _get_aux_mask(self, logits: torch.Tensor,
                      selector: Optional[torch.Tensor]) -> torch.Tensor:
        """fg/bg attention mask (object_transformer.py:179-205): the first
        Q/2 queries see only their object's foreground, the last Q/2 only
        background; fully blocked rows are unblocked. logits [B, N, H, W];
        returns bool [B*N, heads, Q, H*W], True = blocked."""
        prob = torch.sigmoid(logits.float())
        if selector is not None:
            prob = prob * selector[..., None, None]
        agg = aggregate(prob, dim=1)
        is_fg = agg[:, 1:] >= agg.max(dim=1, keepdim=True).values
        b, n = is_fg.shape[:2]
        fg = is_fg.reshape(b, n, 1, 1, -1)
        hw = fg.shape[-1]
        half = self.num_queries // 2
        shape = (b, n, self.num_heads, half, hw)
        mask = torch.cat([(~fg).expand(shape), fg.expand(shape)], dim=3)
        mask = mask.reshape(b * n, self.num_heads, self.num_queries, hw)
        return mask & ~mask.all(dim=-1, keepdim=True)
