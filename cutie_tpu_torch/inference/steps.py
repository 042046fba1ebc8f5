"""Per-frame step functions over the fixed-capacity MemoryState.

The port's counterpart of cutie_tpu/inference/steps.py (reference
cutie/inference/memory_manager.py:112-296 and inference_core.py:71-170):
encode, read memory, segment, memorize, set the last mask, and the fused
plain-frame step. PyTorch runs eagerly, so these are plain methods; they
update the state in place: segment replaces `sensory` and `last_mask`, and
memorize writes the new frame's keys and values into the permanent buffer
and the working-memory ring slots in place (index assignment).

The memory read goes through ops.read_kernel.radix_topk_readout: the CUDA
kernel for tensors on the card, its plain version on the CPU.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from cutie_tpu_torch.inference.state import MemoryState
from cutie_tpu_torch.models.cutie import CUTIE
from cutie_tpu_torch.ops.read_kernel import radix_topk_readout


class FrameFeatures(NamedTuple):
    image: torch.Tensor      # [B, 3, Hp, Wp] padded frame in [0, 1]
    f16: torch.Tensor
    f8: torch.Tensor
    f4: torch.Tensor
    pix_feat: torch.Tensor
    key: torch.Tensor        # [B, Ck, h, w]
    shrinkage: torch.Tensor  # [B, 1, h, w]
    selection: torch.Tensor  # [B, Ck, h, w]


def _tokens(x: torch.Tensor) -> torch.Tensor:
    """[B, C, h, w] -> [B, hw, C] token rows."""
    return x.flatten(2).transpose(1, 2).contiguous()


class StepFunctions:
    """The step functions of one CUTIE model under one eval config."""

    def __init__(self, model: CUTIE, cfg):
        if cfg.get("use_long_term", False):
            raise NotImplementedError("long-term memory is not ported yet")
        if cfg.get("flip_aug", False):
            raise NotImplementedError("flip_aug is not ported yet")
        self.model = model
        self.top_k = int(cfg.top_k)

    @torch.no_grad()
    def encode(self, image: torch.Tensor, *, pad=(0, 0, 0, 0)) -> FrameFeatures:
        """image [3, H, W] float in [0, 1] on the model's device; pad
        (lw, uw, lh, uh) zero padding to a multiple of 16."""
        x = F.pad(image[None], pad)
        (f16, f8, f4), pix_feat = self.model.encode_image(x)
        key, shrinkage, selection = self.model.transform_key(f16)
        return FrameFeatures(x, f16, f8, f4, pix_feat, key, shrinkage,
                             selection)

    def read_inputs(self, state: MemoryState, feats: FrameFeatures,
                    rep: int, row: int):
        """The arguments of radix_topk_readout for batch row `row` and the
        bucket whose representative object slot is `rep`: keys, shrinkage
        and validity over [perm | work], the frame's query keys and
        selection, and the two value segments, read in place."""
        b, ck, h, w = feats.key.shape
        hw = h * w
        f = state.work_key.shape[1]
        pcap = state.perm_key.shape[1]
        o, cv = state.num_objects, state.work_value.shape[-1]
        mk = torch.cat([state.perm_key[row],
                        state.work_key[row].reshape(f * hw, ck)])
        ms = torch.cat([state.perm_shrink[row],
                        state.work_shrink[row].reshape(f * hw)])
        perm_valid = torch.arange(pcap, device=mk.device) < state.perm_n
        valid = torch.cat([
            perm_valid & state.perm_obj_valid[rep],
            (state.ring_valid() & state.work_obj_valid[rep]).repeat_interleave(hw)])
        qk = feats.key[row].flatten(1).T.contiguous()
        qe = feats.selection[row].flatten(1).T.contiguous()
        values = (state.perm_value[row],
                  state.work_value[row].reshape(o, f * hw, cv))
        return mk, ms, valid, qk, qe, values

    def read_memory(self, state: MemoryState, feats: FrameFeatures,
                    bucket_rep: Tuple[int, ...],
                    bucket_sel: torch.Tensor) -> torch.Tensor:
        """Top-k attention read over [perm | work] (memory_manager.py:112-208).

        Each bucket (objects first seen in the same frame) reads only the
        tokens valid for its representative object slot, and its readout
        goes to the objects bucket_sel [num_buckets, O] selects. Returns the
        pixel memory readout [B, O, Cv, h, w]."""
        b, _, h, w = feats.key.shape
        o, cv = state.num_objects, state.work_value.shape[-1]
        pixel_readout = torch.zeros((b, o, h * w, cv), device=feats.key.device)
        for bi, rep in enumerate(bucket_rep):
            rows = [radix_topk_readout(*self.read_inputs(state, feats, rep, r),
                                       self.top_k)[0] for r in range(b)]
            pixel_readout += torch.stack(rows) * bucket_sel[bi][None, :, None, None]
        return pixel_readout.transpose(2, 3).reshape(b, o, cv, h, w)

    @torch.no_grad()
    def segment(self, state: MemoryState, feats: FrameFeatures,
                selector: torch.Tensor, update_sensory: bool,
                bucket_rep: Tuple[int, ...], bucket_sel: torch.Tensor
                ) -> torch.Tensor:
        """Memory read, object transformer and decoder
        (inference_core.py:123-170). selector [O] marks the live object
        slots. Returns prob with background [B, O+1, Hp, Wp]."""
        model = self.model
        pixel_readout = self.read_memory(state, feats, bucket_rep, bucket_sel)
        obj_mem = state.obj_v[:, :, None]
        b, o = state.sensory.shape[:2]
        # pixel fusion and the object transformer run per bucket, as in the
        # reference (memory_manager.py:183-195)
        mem_readout = 0
        for bi in range(len(bucket_rep)):
            bsel = bucket_sel[bi]
            fused = model.pixel_fusion(
                feats.pix_feat, pixel_readout, state.sensory,
                state.last_mask * bsel[None, :, None, None])
            r, _ = model.readout_query(fused, obj_mem,
                                       selector=bsel[None].expand(b, o))
            mem_readout = mem_readout + r * bsel[None, :, None, None, None]
        sensory, _, prob = model.segment(
            (feats.f16, feats.f8, feats.f4), mem_readout, state.sensory,
            selector=selector[None].expand(b, o), update_sensory=update_sensory)
        state.sensory = sensory
        state.last_mask = prob[:, 1:]
        return prob

    @torch.no_grad()
    def memorize(self, state: MemoryState, feats: FrameFeatures,
                 selector: torch.Tensor, new_obj_mask: torch.Tensor, *,
                 mode: str, deep_update: bool = True) -> None:
        """Encode state.last_mask into memory (inference_core.py:71-121,
        memory_manager.py:210-296).

        mode 'all': every live object's tokens go to permanent memory (first
        frame, forced commits); 'no': a ring insert; 'split': objects first
        seen this frame (new_obj_mask [O]) go to permanent memory, the others
        into the ring. The caller makes room in the permanent buffer."""
        b, ck, h, w = feats.key.shape
        o = state.num_objects
        hw = h * w
        f = state.work_key.shape[1]
        msk_value, sensory, obj_summaries, _ = self.model.encode_mask(
            feats.image, feats.pix_feat, state.sensory, state.last_mask,
            deep_update=deep_update)
        state.obj_v = state.obj_v + obj_summaries * selector[None, :, None, None]
        state.sensory = sensory

        key_t, shr_t = _tokens(feats.key), _tokens(feats.shrinkage)[..., 0]
        val_t = (msk_value.flatten(3).transpose(2, 3)
                 * selector[None, :, None, None])              # [B, O, HW, Cv]
        live = selector > 0.5
        if mode in ("all", "split"):
            perm_objs = live if mode == "all" else new_obj_mask > 0.5
            n0 = state.perm_n
            state.perm_key[:, n0:n0 + hw] = key_t
            state.perm_shrink[:, n0:n0 + hw] = shr_t
            state.perm_value[:, :, n0:n0 + hw] = val_t
            state.perm_obj_valid[:, n0:n0 + hw] = perm_objs[:, None]
            state.perm_n = n0 + hw
            if mode == "all":
                return
        ring_objs = live if mode == "no" else live & ~(new_obj_mask > 0.5)
        # FIFO: a full ring overwrites its oldest slot (memory_manager.py:296)
        slot = (state.work_start + state.work_count) % f
        if state.work_count >= f:
            state.work_start = (state.work_start + 1) % f
        else:
            state.work_count += 1
        state.work_key[:, slot] = key_t
        state.work_shrink[:, slot] = shr_t
        state.work_value[:, :, slot] = val_t
        state.work_obj_valid[:, slot] = ring_objs

    def set_last_mask(self, state: MemoryState, prob_no_bg: torch.Tensor) -> None:
        """Overwrite last_mask (after user-provided masks are merged)."""
        state.last_mask = prob_no_bg.float()

    def step_plain(self, state: MemoryState, image: torch.Tensor,
                   selector: torch.Tensor, bucket_rep: Tuple[int, ...],
                   bucket_sel: torch.Tensor, *, update_sensory: bool,
                   do_memorize: bool, pad=(0, 0, 0, 0), n_out: int = 0
                   ) -> torch.Tensor:
        """A plain propagation frame: encode, segment, and memorize when
        do_memorize. Returns the unpadded prob [n_out, H, W] of batch row 0
        (n_out > 0) or the padded [B, O+1, Hp, Wp]."""
        feats = self.encode(image, pad=pad)
        prob = self.segment(state, feats, selector, update_sensory,
                            bucket_rep, bucket_sel)
        if do_memorize:
            self.memorize(state, feats, selector, torch.zeros_like(selector),
                          mode="no")
        if n_out:
            lw, uw, lh, uh = pad
            hp, wp = prob.shape[-2:]
            prob = prob[0, :n_out, lh:hp - uh, lw:wp - uw]
        return prob
