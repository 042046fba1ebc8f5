"""Frozen copy of cutie_tpu_torch/models/cutie.py for the benchmark's plain
reference (vosbench/reference): later changes to the port do not reach it.

CUTIE model: stage methods over the network blocks.

The stage methods that inference uses (reference cutie/model/cutie.py:
18-260): encode_image, transform_key, encode_mask, pixel_fusion,
readout_query and segment; vosbench/reference/stream.py keeps the memory.
The aux heads (aux_computer) are built, never run: make_weights lays the
weights out over every parameter in name order, as over the port's model.

Layouts follow the reference: images [B, 3, H, W]; group tensors
[B, N, C, H, W]; masks [B, N, H, W]. Everything runs in float32 (the
benchmark's control turns TF32 on around it, vosbench/check.py).
"""
from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn as nn

from vosbench.reference.network.aux_modules import AuxComputer
from vosbench.reference.network.big_modules import (KeyProjection, MaskDecoder,
                                                MaskEncoder, PixelEncoder,
                                                PixelFeatureFuser)
from vosbench.reference.network.layers import fp32_island
from vosbench.reference.network.object_summarizer import ObjectSummarizer
from vosbench.reference.network.object_transformer import QueryTransformer
from vosbench.reference.network.resize import area_downsample, upsample_4x
from vosbench.reference.network.tensor_utils import aggregate, clip


class CUTIE(nn.Module):

    def __init__(self, cfg: Config):
        super().__init__()
        model_cfg = cfg.model
        self.model_cfg = model_cfg
        self.object_transformer_enabled = (
            model_cfg.object_transformer.num_blocks > 0)
        self.pixel_encoder = PixelEncoder(model_cfg)
        self.pix_feat_proj = nn.Conv2d(model_cfg.pixel_encoder.ms_dims[0],
                                       model_cfg.pixel_dim, 1)
        self.key_proj = KeyProjection(model_cfg)
        self.mask_encoder = MaskEncoder(model_cfg)
        self.mask_decoder = MaskDecoder(model_cfg)
        self.pixel_fuser = PixelFeatureFuser(model_cfg)
        if self.object_transformer_enabled:
            self.object_transformer = QueryTransformer(model_cfg)
            self.object_summarizer = ObjectSummarizer(model_cfg)
        self.aux_computer = AuxComputer(cfg)
        self.register_buffer(
            "pixel_mean", torch.tensor(model_cfg.pixel_mean).view(-1, 1, 1),
            persistent=False)
        self.register_buffer(
            "pixel_std", torch.tensor(model_cfg.pixel_std).view(-1, 1, 1),
            persistent=False)

    def _normalize(self, image: torch.Tensor) -> torch.Tensor:
        return (image - self.pixel_mean) / self.pixel_std

    def _get_others(self, masks: torch.Tensor) -> torch.Tensor:
        """Per-object sum of all other objects' masks (cutie.py:49-59)."""
        return clip(masks.sum(dim=1, keepdim=True) - masks, 0.0, 1.0)

    def encode_image(self, image: torch.Tensor):
        """image [B, 3, H, W] in [0, 1] -> ((f16, f8, f4), pix_feat)."""
        ms_image_feat = self.pixel_encoder(self._normalize(image))
        return ms_image_feat, self.pix_feat_proj(ms_image_feat[0])

    def transform_key(self, final_pix_feat: torch.Tensor, *,
                      need_sk: bool = True, need_ek: bool = True):
        """f16 -> (key, shrinkage, selection)."""
        return self.key_proj(final_pix_feat, need_s=need_sk, need_e=need_ek)

    def encode_mask(self, image: torch.Tensor, pix_feat: torch.Tensor,
                    sensory: torch.Tensor, masks: torch.Tensor, *,
                    deep_update: bool = True):
        """-> (msk_value, new_sensory, object_summaries)."""
        image = self._normalize(image)
        mask_value, new_sensory = self.mask_encoder(
            image, pix_feat, sensory, masks, self._get_others(masks),
            deep_update=deep_update)
        if self.object_transformer_enabled:
            summaries = self.object_summarizer(masks, mask_value)
        else:
            summaries = None
        return mask_value, new_sensory, summaries

    def pixel_fusion(self, pix_feat: torch.Tensor, pixel: torch.Tensor,
                     sensory: torch.Tensor, last_mask: torch.Tensor
                     ) -> torch.Tensor:
        """last_mask [B, N, H0, W0] at full padded resolution."""
        h = sensory.shape[-2]
        last_mask = area_downsample(last_mask, last_mask.shape[-2] // h)
        return self.pixel_fuser(pix_feat, pixel, sensory, last_mask,
                                self._get_others(last_mask))

    def readout_query(self, pixel_readout: torch.Tensor,
                      obj_memory: Optional[torch.Tensor], *,
                      selector: Optional[torch.Tensor] = None):
        if not self.object_transformer_enabled:
            return pixel_readout, None
        return self.object_transformer(pixel_readout, obj_memory,
                                       selector=selector)

    def segment(self, ms_image_feat: List[torch.Tensor],
                memory_readout: torch.Tensor, sensory: torch.Tensor, *,
                selector: Optional[torch.Tensor] = None,
                update_sensory: bool = True):
        """-> (new_sensory, logits [B, N+1, H0, W0], prob [B, N+1, H0, W0])."""
        sensory, logits = self.mask_decoder(ms_image_feat, memory_readout,
                                            sensory,
                                            update_sensory=update_sensory)
        with fp32_island(logits):
            prob = torch.sigmoid(logits.float())
            if selector is not None:
                prob = prob * selector[..., None, None]
            low = aggregate(prob, dim=1)
            logits = upsample_4x(low)
            prob = torch.softmax(logits, dim=1)
        return sensory, logits, prob
