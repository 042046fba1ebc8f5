"""CUTIE model: stage methods over the network blocks.

The port's counterpart of cutie_tpu/models/cutie.py (reference
cutie/model/cutie.py:18-260): encode_image, transform_key, encode_mask,
read_memory (the training full-softmax read), pixel_fusion, readout_query,
segment and compute_aux (the training aux heads). The stateful memory
logic lives in cutie_tpu_torch.inference (inference) and
cutie_tpu_torch.training (training). single_object=True builds the
pre-training model, whose mask encoder and sensory compression take no
"others" plane.

Layouts follow the reference: images [B, 3, H, W]; group tensors
[B, N, C, H, W]; masks [B, N, H, W].

Precision (cutie_tpu/utils/get_default_model.py:50-64): cfg.amp or
cfg.compute_dtype == 'bfloat16' makes compute_dtype bf16, and each stage
method then runs under torch.autocast to bf16. Parameters stay fp32, and
the fp32 islands (the GRUs' transforms and gates, the summarizer pooling,
the logits head, the final sigmoid, LayerNorm and the attention softmax)
run in fp32 (models/layers.py:fp32_island).
"""
from __future__ import annotations

import contextlib
import functools
from typing import Dict, List, Optional

import torch
import torch.nn as nn

from cutie_tpu_torch.config import Config
from cutie_tpu_torch.models.aux_modules import AuxComputer
from cutie_tpu_torch.models.big_modules import (KeyProjection, MaskDecoder,
                                                MaskEncoder, PixelEncoder,
                                                PixelFeatureFuser)
from cutie_tpu_torch.models.layers import fp32_island
from cutie_tpu_torch.models.object_summarizer import ObjectSummarizer
from cutie_tpu_torch.models.object_transformer import QueryTransformer
from cutie_tpu_torch.ops.memory import (get_similarity_expanded, readout,
                                        softmax_affinity)
from cutie_tpu_torch.ops.resize import area_downsample, upsample_4x
from cutie_tpu_torch.ops.tensor_utils import aggregate, clip
from cutie_tpu_torch.utils.tracing import span


def _stage(span_name: Optional[str] = None):
    """Run a stage method under autocast to the model's compute dtype, and
    in the span "models.<span_name>" (utils/tracing.py) where one is
    named."""
    name = None if span_name is None else "models." + span_name

    def wrap(method):
        @functools.wraps(method)
        def run(self, *args, **kwargs):
            with span(name) if name else contextlib.nullcontext(), torch.autocast(
                    self.pixel_mean.device.type, dtype=torch.bfloat16,
                    enabled=self.compute_dtype == torch.bfloat16):
                return method(self, *args, **kwargs)
        return run
    return wrap


class CUTIE(nn.Module):

    def __init__(self, cfg: Config, single_object: bool = False):
        super().__init__()
        model_cfg = cfg.model
        self.model_cfg = model_cfg
        self.single_object = single_object
        amp = (bool(cfg.get("amp", False))
               or str(cfg.get("compute_dtype", "float32")) == "bfloat16")
        self.compute_dtype = torch.bfloat16 if amp else torch.float32
        self.object_transformer_enabled = (
            model_cfg.object_transformer.num_blocks > 0)
        self.pixel_encoder = PixelEncoder(model_cfg)
        self.pix_feat_proj = nn.Conv2d(model_cfg.pixel_encoder.ms_dims[0],
                                       model_cfg.pixel_dim, 1)
        self.key_proj = KeyProjection(model_cfg)
        self.mask_encoder = MaskEncoder(model_cfg, single_object)
        self.mask_decoder = MaskDecoder(model_cfg)
        self.pixel_fuser = PixelFeatureFuser(model_cfg, single_object)
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

    def _get_others(self, masks: torch.Tensor) -> Optional[torch.Tensor]:
        """Per-object sum of all other objects' masks (cutie.py:49-59);
        None for a single-object model."""
        if self.single_object:
            return None
        return clip(masks.sum(dim=1, keepdim=True) - masks, 0.0, 1.0)

    @_stage("pixel_encoder")
    def encode_image(self, image: torch.Tensor):
        """image [B, 3, H, W] in [0, 1] -> ((f16, f8, f4), pix_feat)."""
        ms_image_feat = self.pixel_encoder(self._normalize(image))
        return ms_image_feat, self.pix_feat_proj(ms_image_feat[0])

    @_stage("key_projection")
    def transform_key(self, final_pix_feat: torch.Tensor, *,
                      need_sk: bool = True, need_ek: bool = True):
        """f16 -> (key, shrinkage, selection)."""
        return self.key_proj(final_pix_feat, need_s=need_sk, need_e=need_ek)

    @_stage("mask_encoder")
    def encode_mask(self, image: torch.Tensor, pix_feat: torch.Tensor,
                    sensory: torch.Tensor, masks: torch.Tensor, *,
                    deep_update: bool = True, need_weights: bool = False):
        """-> (msk_value, new_sensory, object_summaries, object_logits)."""
        image = self._normalize(image)
        mask_value, new_sensory = self.mask_encoder(
            image, pix_feat, sensory, masks, self._get_others(masks),
            deep_update=deep_update)
        if self.object_transformer_enabled:
            summaries, logits = self.object_summarizer(masks, mask_value,
                                                       need_weights)
        else:
            summaries, logits = None, None
        return mask_value, new_sensory, summaries, logits

    @_stage("pixel_fusion")
    def pixel_fusion(self, pix_feat: torch.Tensor, pixel: torch.Tensor,
                     sensory: torch.Tensor, last_mask: torch.Tensor
                     ) -> torch.Tensor:
        """last_mask [B, N, H0, W0] at full padded resolution."""
        h = sensory.shape[-2]
        last_mask = area_downsample(last_mask, last_mask.shape[-2] // h)
        return self.pixel_fuser(pix_feat, pixel, sensory, last_mask,
                                self._get_others(last_mask))

    @_stage("object_transformer")
    def readout_query(self, pixel_readout: torch.Tensor,
                      obj_memory: Optional[torch.Tensor], *,
                      selector: Optional[torch.Tensor] = None):
        if not self.object_transformer_enabled:
            return pixel_readout, None
        return self.object_transformer(pixel_readout, obj_memory,
                                       selector=selector)

    @_stage("mask_decoder")
    def segment(self, ms_image_feat: List[torch.Tensor],
                memory_readout: torch.Tensor, sensory: torch.Tensor, *,
                selector: Optional[torch.Tensor] = None,
                update_sensory: bool = True, return_low_logits: bool = False):
        """-> (new_sensory, logits [B, N+1, H0, W0], prob [B, N+1, H0, W0]),
        and with return_low_logits also the stride-4 aggregate logits
        before the upsample [B, N+1, H0/4, W0/4], which the training loss
        samples (training/losses.py)."""
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
        if return_low_logits:
            return sensory, logits, prob, low
        return sensory, logits, prob

    @_stage()
    def compute_aux(self, pix_feat: torch.Tensor,
                    aux_inputs: Dict[str, torch.Tensor],
                    selector: Optional[torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The aux heads on read_memory's aux output (models/aux_modules.py)."""
        return self.aux_computer(pix_feat, aux_inputs, selector)

    def read_memory(self, query_key, query_selection, memory_key,
                    memory_shrinkage, msk_value, obj_memory, pix_feat,
                    sensory, last_mask, selector):
        """Training-time full-softmax memory read (cutie.py:102-140).

        query_key / query_selection [B, Ck, h, w]; memory_key [B, Ck, T, h, w];
        memory_shrinkage [B, 1, T, h, w]; msk_value [B, N, Cv, T, h, w];
        obj_memory [B, N, T, Q, E+1]; last_mask [B, N, H0, W0].
        Returns (mem_readout [B, N, E, h, w], aux_output {'sensory',
        'q_logits' [B, N, L, h, w], 'attn_mask'}) as cutie_tpu's does.

        The similarity is the expanded form (ops/memory.py:
        get_similarity_expanded), two fp32 matmuls as in cutie_tpu: under
        autograd the direct form saves two [B, P, N] temporaries a key
        channel. The affinity and readout are fp32 outside autocast."""
        b, ck = memory_key.shape[:2]
        n, cv = msk_value.shape[1:3]
        h, w = query_key.shape[-2:]
        with fp32_island(query_key):
            mk = memory_key.flatten(2).transpose(1, 2)
            ms = memory_shrinkage.flatten(1)
            qk = query_key.flatten(2).transpose(1, 2)
            qe = query_selection.flatten(2).transpose(1, 2)
            affinity = softmax_affinity(get_similarity_expanded(mk, ms, qk, qe))
            mv = msk_value.flatten(3).transpose(2, 3)              # [B, N, THW, Cv]
            pixel_readout = readout(affinity, mv).transpose(2, 3)  # [B, N, Cv, HW]
        pixel_readout = pixel_readout.reshape(b, n, cv, h, w)
        pixel_readout = self.pixel_fusion(pix_feat, pixel_readout, sensory,
                                          last_mask)
        mem_readout, aux = self.readout_query(pixel_readout, obj_memory,
                                              selector=selector)
        return mem_readout, {
            "sensory": sensory,
            "q_logits": aux["logits"] if aux else None,
            "attn_mask": aux["attn_mask"] if aux else None,
        }
