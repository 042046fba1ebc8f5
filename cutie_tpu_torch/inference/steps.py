"""Per-frame step functions over the fixed-capacity MemoryState.

The port's counterpart of cutie_tpu/inference/steps.py (reference
cutie/inference/memory_manager.py:112-358 and inference_core.py:71-170):
encode, read memory, segment, memorize, set the last mask, long-term
consolidation, and the fused plain-frame step. PyTorch runs eagerly, so
these are plain methods; they update the state in place: the read adds its
usage into the usage counters (long-term mode), segment replaces `sensory`
and `last_mask`, memorize writes the new frame into the permanent buffer and
the working-memory ring slots (index assignment), and consolidate writes the
long-term buffers and advances the ring.

The memory read goes through ops.read_kernel.radix_topk_readout: the CUDA
kernel for tensors on the card, its plain version on the CPU.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from cutie_tpu_torch.inference.state import MemoryState
from cutie_tpu_torch.models.cutie import CUTIE
from cutie_tpu_torch.ops.memory import (NEG_INF, get_similarity, readout,
                                        softmax_affinity)
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


def _top_indices(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries of each row of x [B, M], equal
    values in index order (jax.lax.top_k's order; torch.topk promises
    none)."""
    return torch.sort(x, dim=1, descending=True, stable=True).indices[:, :k]


class StepFunctions:
    """The step functions of one CUTIE model under one eval config."""

    def __init__(self, model: CUTIE, cfg):
        if cfg.get("flip_aug", False):
            raise NotImplementedError("flip_aug is not ported yet")
        self.model = model
        self.top_k = int(cfg.top_k)
        self.use_long_term = bool(cfg.get("use_long_term", False))
        if self.use_long_term:
            self.num_prototypes = int(cfg.long_term.num_prototypes)

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
        and validity over [perm | lt | work], the frame's query keys and
        selection, and the three value segments, read in place (the lt
        segment holds no tokens outside long-term mode)."""
        b, ck, h, w = feats.key.shape
        hw = h * w
        f = state.work_key.shape[1]
        pcap = state.perm_key.shape[1]
        o, cv = state.num_objects, state.work_value.shape[-1]
        perm_valid = torch.arange(pcap, device=state.perm_key.device) < state.perm_n
        mk = torch.cat([state.perm_key[row], state.lt_key[row],
                        state.work_key[row].reshape(f * hw, ck)])
        ms = torch.cat([state.perm_shrink[row], state.lt_shrink[row],
                        state.work_shrink[row].reshape(f * hw)])
        valid = torch.cat([
            perm_valid & state.perm_obj_valid[rep],
            state.lt_valid() & state.lt_obj_valid[rep],
            (state.ring_valid() & state.work_obj_valid[rep]).repeat_interleave(hw)])
        qk = feats.key[row].flatten(1).T.contiguous()
        qe = feats.selection[row].flatten(1).T.contiguous()
        values = (state.perm_value[row], state.lt_value[row],
                  state.work_value[row].reshape(o, f * hw, cv))
        return mk, ms, valid, qk, qe, values

    def read_memory(self, state: MemoryState, feats: FrameFeatures,
                    bucket_rep: Tuple[int, ...],
                    bucket_sel: torch.Tensor) -> torch.Tensor:
        """Top-k attention read over [perm | lt | work]
        (memory_manager.py:112-208).

        Each bucket (objects first seen in the same frame) reads only the
        tokens valid for its representative object slot, and its readout
        goes to the objects bucket_sel [num_buckets, O] selects. In
        long-term mode each bucket's read adds its usage into work_use and
        lt_use and its validity into work_life and lt_life, in place
        (kv_memory_store.py:151-162; the counters are shared across buckets,
        the deviation PARITY.md records). Returns the pixel memory readout
        [B, O, Cv, h, w]."""
        b, _, h, w = feats.key.shape
        hw = h * w
        o, cv = state.num_objects, state.work_value.shape[-1]
        f = state.work_key.shape[1]
        pcap, lcap = state.perm_key.shape[1], state.lt_key.shape[1]
        pixel_readout = torch.zeros((b, o, hw, cv), device=feats.key.device)
        for bi, rep in enumerate(bucket_rep):
            reads = [radix_topk_readout(*self.read_inputs(state, feats, rep, r),
                                        self.top_k) for r in range(b)]
            pixel_readout += (torch.stack([rd for rd, _ in reads])
                              * bucket_sel[bi][None, :, None, None])
            if self.use_long_term:
                usage = torch.stack([us for _, us in reads])        # [B, N]
                state.lt_use += usage[:, pcap:pcap + lcap]
                state.work_use += usage[:, pcap + lcap:].reshape(b, f, hw)
                life_w = state.ring_valid() & state.work_obj_valid[rep]   # [F]
                state.work_life += life_w.float()[None, :, None]
                state.lt_life += (state.lt_valid()
                                  & state.lt_obj_valid[rep]).float()[None]
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
        into the ring. The caller makes room in the permanent buffer and, in
        long-term mode, consolidates before the ring would wrap."""
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
        sel_t = _tokens(feats.selection)
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
        # fresh usage counters for the (re)used slot (kv_memory_store.py:132-134)
        state.work_sel[:, slot] = sel_t
        state.work_use[:, slot] = 0.0
        state.work_life[:, slot] = 1e-7

    def set_last_mask(self, state: MemoryState, prob_no_bg: torch.Tensor) -> None:
        """Overwrite last_mask (after user-provided masks are merged)."""
        state.last_mask = prob_no_bg.float()

    @torch.no_grad()
    def consolidate(self, state: MemoryState, n_candidate_frames: int,
                    lt_keep: Optional[int] = None) -> None:
        """Long-term consolidation (cutie_tpu steps.py:_consolidate,
        reference memory_manager.py:309-358): compress the oldest
        n_candidate_frames ring frames into num_prototypes tokens, after a
        usage-ranked eviction that keeps lt_keep long-term tokens when
        lt_keep is given (kv_memory_store.py:209-242).

        In place: eviction compacts the long-term buffers (and lt_obj_valid
        with the same permutation) to their first lt_keep slots; the
        prototypes are written at lt_count; the consolidated frames leave the
        ring (work_start, work_count).

        Ties in usage (many candidates have usage exactly 0) go to the lower
        index, as jax.lax.top_k breaks them: a stable descending sort."""
        num_protos = self.num_prototypes
        b, f, hw, ck = state.work_key.shape
        o, cv = state.work_value.shape[1], state.work_value.shape[-1]
        nc = n_candidate_frames * hw
        dev = state.work_key.device

        # candidate frames, oldest first
        frame_idx = (state.work_start
                     + torch.arange(n_candidate_frames, device=dev)) % f
        cand_key = state.work_key[:, frame_idx].reshape(b, nc, ck)
        cand_shr = state.work_shrink[:, frame_idx].reshape(b, nc)
        cand_sel = state.work_sel[:, frame_idx].reshape(b, nc, ck)
        cand_val = state.work_value[:, :, frame_idx].reshape(b, o, nc, cv)
        cand_use = (state.work_use[:, frame_idx]
                    / state.work_life[:, frame_idx]).reshape(b, nc)

        # prototypes: the top-usage candidates (memory_manager.py:336-343)
        proto_idx = _top_indices(cand_use, num_protos)              # [B, P]
        proto_key = cand_key.gather(1, proto_idx[..., None].expand(-1, -1, ck))
        proto_sel = cand_sel.gather(1, proto_idx[..., None].expand(-1, -1, ck))

        # potentiation: the candidates' attention onto the prototypes
        sim = get_similarity(cand_key, cand_shr, proto_key, proto_sel)  # [B,P,Nc]
        proto_shr = readout(softmax_affinity(sim), cand_shr[..., None])[..., 0]
        # each object's values are potentiated over ITS valid candidates only
        # (a late-added object has zero value rows in the frames before it)
        obj_valid = state.work_obj_valid[:, frame_idx].repeat_interleave(
            hw, dim=1)[None, :, None, :]                              # [1,O,1,Nc]
        sim_o = torch.where(obj_valid, sim[:, None],
                            torch.full_like(sim[:, None], NEG_INF))  # [B,O,P,Nc]
        m = sim_o.amax(dim=-1, keepdim=True)
        e = torch.where(obj_valid, torch.exp(sim_o - m.clamp_min(-1e29)),
                        torch.zeros_like(sim_o))
        aff_o = e / e.sum(dim=-1, keepdim=True).clamp_min(1e-30)
        proto_val = torch.einsum("bopn,bonc->bopc", aff_o, cand_val.float())

        if lt_keep is not None:
            # usage-ranked eviction; lt_obj_valid is shared across the batch
            # and follows batch row 0's permutation
            use = torch.where(state.lt_valid()[None],
                              state.lt_use / state.lt_life.clamp_min(1e-30),
                              torch.full_like(state.lt_use, -1.0))
            keep = _top_indices(use, lt_keep)                       # [B, keep]

            def compact(buf, kept, dim):
                buf.narrow(dim, 0, lt_keep).copy_(kept)
                buf.narrow(dim, lt_keep, buf.shape[dim] - lt_keep).zero_()

            compact(state.lt_key,
                    state.lt_key.gather(1, keep[..., None].expand(-1, -1, ck)), 1)
            compact(state.lt_shrink, state.lt_shrink.gather(1, keep), 1)
            compact(state.lt_value, state.lt_value.gather(
                2, keep[:, None, :, None].expand(-1, o, -1, cv)), 2)
            compact(state.lt_use, state.lt_use.gather(1, keep), 1)
            compact(state.lt_life, state.lt_life.gather(1, keep), 1)
            state.lt_life.clamp_(min=1e-7)
            compact(state.lt_obj_valid, state.lt_obj_valid[:, keep[0]], 1)
            state.lt_count = lt_keep

        # append the prototypes at lt_count
        s0, s1 = state.lt_count, state.lt_count + num_protos
        state.lt_key[:, s0:s1] = proto_key
        state.lt_shrink[:, s0:s1] = proto_shr
        state.lt_value[:, :, s0:s1] = proto_val
        state.lt_obj_valid[:, s0:s1] = state.work_obj_valid[:, frame_idx].any(
            dim=1)[:, None]
        state.lt_use[:, s0:s1] = 0.0
        state.lt_life[:, s0:s1] = 1e-7
        state.lt_count = s1
        # drop the consolidated frames from the ring (memory_manager.py:317-320)
        state.work_start = (state.work_start + n_candidate_frames) % f
        state.work_count -= n_candidate_frames

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
