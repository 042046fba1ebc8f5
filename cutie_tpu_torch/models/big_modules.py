"""Encoders, key projection, pixel fuser and mask decoder.

The port's counterpart of cutie_tpu/models/big_modules.py (reference
cutie/model/big_modules.py). Shared features are [B, C, H, W]; per-object
group features are [B, N, C, H, W]. The object axis is a batch axis: there
is no object chunking.
"""
from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from cutie_tpu_torch.config import Config
from cutie_tpu_torch.models.layers import (GConv2d, GroupFeatureFusionBlock,
                                           MaskUpsampleBlock,
                                           SensoryDeepUpdater, SensoryUpdater,
                                           flatten_group, unflatten_group)
from cutie_tpu_torch.models.resnet import ResNetTrunk


class PixelEncoder(ResNetTrunk):
    """Query encoder: ResNet trunk -> (f16, f8, f4) (big_modules.py:21-61)."""

    def __init__(self, model_cfg: Config):
        super().__init__(model_cfg.pixel_encoder.type, layer1_name="res2")

    def forward(self, image: torch.Tensor):
        f4, f8, f16 = super().forward(image)
        return f16, f8, f4


class KeyProjection(nn.Module):
    """f16 -> key, shrinkage, selection (big_modules.py:64-87)."""

    def __init__(self, model_cfg: Config):
        super().__init__()
        in_dim = model_cfg.pixel_encoder.ms_dims[0]
        mid_dim = model_cfg.pixel_dim
        key_dim = model_cfg.key_dim
        self.pix_feat_proj = nn.Conv2d(in_dim, mid_dim, 1)
        self.key_proj = nn.Conv2d(mid_dim, key_dim, 3, padding=1)
        self.d_proj = nn.Conv2d(mid_dim, 1, 3, padding=1)
        self.e_proj = nn.Conv2d(mid_dim, key_dim, 3, padding=1)

    def forward(self, x: torch.Tensor, *, need_s: bool, need_e: bool):
        x = self.pix_feat_proj(x)
        shrinkage = self.d_proj(x) ** 2 + 1 if need_s else None
        selection = torch.sigmoid(self.e_proj(x)) if need_e else None
        return self.key_proj(x), shrinkage, selection


class MaskEncoder(ResNetTrunk):
    """Value encoder: ResNet-18 over [image, mask, others], fused with
    pix_feat, plus the sensory deep update (big_modules.py:90-189)."""

    def __init__(self, model_cfg: Config):
        super().__init__(model_cfg.mask_encoder.type, extra_dim=2)
        self.fuser = GroupFeatureFusionBlock(model_cfg.pixel_dim,
                                             model_cfg.mask_encoder.final_dim,
                                             model_cfg.value_dim)
        self.sensory_update = SensoryDeepUpdater(model_cfg.value_dim,
                                                 model_cfg.sensory_dim)

    def forward(self, image: torch.Tensor, pix_feat: torch.Tensor,
                sensory: torch.Tensor, masks: torch.Tensor,
                others: torch.Tensor, *, deep_update: bool = True
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """image [B, 3, H0, W0] (normalized), pix_feat [B, C, h, w],
        sensory [B, N, Cs, h, w], masks / others [B, N, H0, W0].
        Returns (value [B, N, Cv, h, w], new sensory)."""
        b, n = masks.shape[:2]
        planes = torch.stack([masks, others], dim=2)
        g = torch.cat([image[:, None].expand(b, n, *image.shape[1:]),
                       planes.to(image.dtype)], dim=2)
        _, _, f16 = ResNetTrunk.forward(self, g.flatten(0, 1))
        g16 = self.fuser(pix_feat, unflatten_group(f16, (b, n)))
        if deep_update:
            sensory = self.sensory_update(g16, sensory)
        return g16, sensory


class PixelFeatureFuser(nn.Module):
    """Fuses the pixel memory readout with sensory memory and the last mask
    (big_modules.py:192-235)."""

    def __init__(self, model_cfg: Config):
        super().__init__()
        self.sensory_compress = GConv2d(model_cfg.sensory_dim + 2,
                                        model_cfg.value_dim, 1)
        self.fuser = GroupFeatureFusionBlock(model_cfg.pixel_dim,
                                             model_cfg.value_dim,
                                             model_cfg.embed_dim)

    def forward(self, pix_feat, pixel_memory, sensory_memory, last_mask,
                last_others) -> torch.Tensor:
        """last_mask / last_others [B, N, h, w] at stride 16."""
        mask_feat = torch.stack([last_mask, last_others], dim=2)
        sensory_readout = self.sensory_compress(
            torch.cat([sensory_memory, mask_feat], dim=2))
        return self.fuser(pix_feat, pixel_memory + sensory_readout)


class DecoderFeatureProcessor(nn.Module):
    """1x1 projections of the f8 and f4 skip features (modules.py)."""

    def __init__(self, decoder_dims: List[int], out_dims: List[int]):
        super().__init__()
        self.transforms = nn.ModuleList(
            nn.Conv2d(d_dim, p_dim, 1) for d_dim, p_dim in zip(decoder_dims,
                                                               out_dims))

    def forward(self, multi_scale_features):
        return [f(x) for x, f in zip(multi_scale_features, self.transforms)]


class MaskDecoder(nn.Module):
    """FPN decoder 16 -> 8 -> 4, fp32 logits head and sensory GRU
    (big_modules.py:238-306)."""

    def __init__(self, model_cfg: Config):
        super().__init__()
        ms_dims = model_cfg.pixel_encoder.ms_dims
        up_dims = model_cfg.mask_decoder.up_dims
        embed_dim = model_cfg.embed_dim
        sensory_dim = model_cfg.sensory_dim
        self.decoder_feat_proc = DecoderFeatureProcessor(ms_dims[1:],
                                                         up_dims[:-1])
        self.up_16_8 = MaskUpsampleBlock(embed_dim, up_dims[1])
        self.up_8_4 = MaskUpsampleBlock(up_dims[1], up_dims[2])
        self.sensory_update = SensoryUpdater(
            [up_dims[0], up_dims[1], up_dims[2] + 1], sensory_dim, sensory_dim)
        self.pred = nn.Conv2d(up_dims[-1], 1, 3, padding=1)

    def forward(self, ms_image_feat: List[torch.Tensor],
                memory_readout: torch.Tensor, sensory: torch.Tensor, *,
                update_sensory: bool = True):
        """ms_image_feat [f16, f8, f4]; memory_readout [B, N, E, h, w];
        sensory [B, N, Cs, h, w]. Returns (new sensory, logits [B, N, H/4, W/4])."""
        f8, f4 = self.decoder_feat_proc(ms_image_feat[1:])
        p16 = memory_readout
        p8 = self.up_16_8(p16, f8)
        p4 = self.up_8_4(p8, f4)
        flat, bn = flatten_group(p4)
        logits = unflatten_group(self.pred(F.relu(flat.float())), bn)
        if update_sensory:
            p4 = torch.cat([p4.float(), logits], dim=2)
            sensory = self.sensory_update([p16, p8, p4], sensory)
        return sensory, logits[:, :, 0]
