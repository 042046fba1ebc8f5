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
kernel for tensors on the card, its plain version on the CPU. With
cfg.mem_mesh_devices = D > 1 the read is sharded over a mesh of D ranks
instead (parallel/sharded_memory.py; cutie_tpu steps.py:437-503): every
rank runs the same steps on the same frames, the permanent and working
memory are replicated, and in long-term mode each rank's long-term buffers
hold its slice of the token axis.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from cutie_tpu_torch.inference.state import LT_FIELDS, MemoryState, slice_lt
from cutie_tpu_torch.models.cutie import CUTIE
from cutie_tpu_torch.ops.memory import (NEG_INF, get_similarity, readout,
                                        softmax_affinity)
from cutie_tpu_torch.ops.read_kernel import radix_topk_readout
from cutie_tpu_torch.parallel.mesh import all_gather
from cutie_tpu_torch.parallel.sharded_memory import (make_mem_mesh,
                                                     sharded_composite_readout)
from cutie_tpu_torch.utils.tracing import span


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
        self.model = model
        self.top_k = int(cfg.top_k)
        # batch row 1 holds the horizontally flipped frame
        # (cutie_tpu inference_core.py:266, steps.py:157-159)
        self.flip_aug = bool(cfg.get("flip_aug", False))
        self.save_aux = bool(cfg.get("save_aux", False))
        self.use_long_term = bool(cfg.get("use_long_term", False))
        if self.use_long_term:
            self.num_prototypes = int(cfg.long_term.num_prototypes)
        # the memory mesh (0 and 1: none); more ranks than the world has
        # raise (parallel/mesh.py:make_mesh)
        d = int(cfg.get("mem_mesh_devices", 0) or 0)
        self.mem_mesh = make_mem_mesh(d) if d > 1 else None

    def lt_sharded(self) -> bool:
        """True when each rank holds a slice of the long-term buffers."""
        return self.mem_mesh is not None and self.use_long_term

    def lt_shard(self) -> Tuple[int, int]:
        """(rank, D) of the long-term slice this rank holds; (0, 1): all."""
        if self.lt_sharded():
            return self.mem_mesh.rank, self.mem_mesh.size
        return 0, 1

    def lt_offset(self, state: MemoryState) -> int:
        """The global slot of this rank's first long-term slot."""
        return self.lt_shard()[0] * state.lt_key.shape[1]

    def gather_lt(self, state: MemoryState) -> MemoryState:
        """The state with whole long-term buffers, gathered from every
        rank's slice (the state itself when they are not sharded)."""
        if not self.lt_sharded():
            return state
        return dataclasses.replace(state, **{
            name: torch.cat(all_gather(getattr(state, name), self.mem_mesh), dim=dim)
            for name, dim in LT_FIELDS})

    @torch.no_grad()
    def encode(self, image: torch.Tensor, *, pad=(0, 0, 0, 0)) -> FrameFeatures:
        """image [3, H, W] float in [0, 1] on the model's device; pad
        (lw, uw, lh, uh) zero padding to a multiple of 16."""
        with span("steps.encode"):
            x = F.pad(image[None], pad)
            if self.flip_aug:
                x = torch.cat([x, x.flip(-1)])
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
        # the similarity is fp32 (under amp the key projection emits bf16)
        qk = feats.key[row].flatten(1).T.float().contiguous()
        qe = feats.selection[row].flatten(1).T.float().contiguous()
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
        with span("steps.read_memory"):
            b, _, h, w = feats.key.shape
            hw = h * w
            o, cv = state.num_objects, state.work_value.shape[-1]
            f = state.work_key.shape[1]
            pcap, lcap = state.perm_key.shape[1], state.lt_key.shape[1]
            lt_valid = state.lt_valid(self.lt_offset(state))
            pixel_readout = torch.zeros((b, o, hw, cv), device=feats.key.device)
            for bi, rep in enumerate(bucket_rep):
                if self.mem_mesh is None:
                    reads = [radix_topk_readout(*self.read_inputs(state, feats, rep, r),
                                                self.top_k) for r in range(b)]
                    rd = torch.stack([rd for rd, _ in reads])
                    usage = torch.stack([us for _, us in reads])        # [B, N]
                    lt_usage = usage[:, pcap:pcap + lcap]
                    work_usage = usage[:, pcap + lcap:]
                else:
                    rd, lt_usage, work_usage = self.sharded_read(state, feats, rep,
                                                                 lt_valid)
                pixel_readout += rd * bucket_sel[bi][None, :, None, None]
                if self.use_long_term:
                    state.lt_use += lt_usage
                    state.work_use += work_usage.reshape(b, f, hw)
                    life_w = state.ring_valid() & state.work_obj_valid[rep]   # [F]
                    state.work_life += life_w.float()[None, :, None]
                    state.lt_life += (lt_valid & state.lt_obj_valid[rep]).float()[None]
            return pixel_readout.transpose(2, 3).reshape(b, o, cv, h, w)

    def sharded_read(self, state: MemoryState, feats: FrameFeatures, rep: int,
                     lt_valid: torch.Tensor):
        """One bucket's read over the memory mesh, every batch row at once
        (cutie_tpu steps.py:_composite_bucket_read): (readout [B, O, HW,
        Cv], lt usage of this rank's slots [B, L_local], work usage
        [B, F*HW]; usages None outside long-term mode)."""
        b, ck, h, w = feats.key.shape
        hw = h * w
        f = state.work_key.shape[1]
        o, cv = state.num_objects, state.work_value.shape[-1]
        pcap = state.perm_key.shape[1]
        perm_valid = (torch.arange(pcap, device=state.perm_key.device) < state.perm_n)
        work_valid = (state.ring_valid() & state.work_obj_valid[rep]).repeat_interleave(hw)

        def rows(valid):
            return valid[None].expand(b, -1)

        return sharded_composite_readout(
            (state.perm_key, state.perm_shrink, state.perm_value,
             rows(perm_valid & state.perm_obj_valid[rep])),
            (state.lt_key, state.lt_shrink, state.lt_value,
             rows(lt_valid & state.lt_obj_valid[rep])),
            (state.work_key.reshape(b, f * hw, ck), state.work_shrink.reshape(b, f * hw),
             state.work_value.reshape(b, o, f * hw, cv), rows(work_valid)),
            _tokens(feats.key).float(), _tokens(feats.selection).float(),
            self.top_k, self.mem_mesh, lt_sharded=self.lt_sharded(),
            return_usage=self.use_long_term)

    @torch.no_grad()
    def segment(self, state: MemoryState, feats: FrameFeatures,
                selector: torch.Tensor, update_sensory: bool,
                bucket_rep: Tuple[int, ...], bucket_sel: torch.Tensor
                ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
        """Memory read, object transformer and decoder
        (inference_core.py:123-170). selector [O] marks the live object
        slots. Returns (prob with background [B, O+1, Hp, Wp], aux).

        Under flip_aug the prediction is the mean of the frame's and the
        flipped frame's (B = 1), and last_mask keeps it in both orientations
        (cutie_tpu steps.py:560-567).

        aux is None unless save_aux; then it holds, merged across buckets on
        the object axis (cutie_tpu steps.py:525-559, reference
        memory_manager.py:197-206), channels first:
          pixel_readout [B, O, E, h, w]  the pixel fusion's output;
          q_logits      [B, O, L, H, W]  the object transformer's mask
                                         logits, L = num_blocks + 1;
          attn_mask     [B, O, heads, Q, hw] bool, True = blocked;
          sensory       [B, O, Cs, h, w] the updated sensory memory;
        B is 2 under flip_aug (both orientations)."""
        with span("steps.segment"):
            model = self.model
            pixel_readout = self.read_memory(state, feats, bucket_rep, bucket_sel)
            obj_mem = state.obj_v[:, :, None]
            b, o = state.sensory.shape[:2]
            # pixel fusion and the object transformer run per bucket, as in the
            # reference (memory_manager.py:183-195)
            mem_readout, aux = 0, None
            for bi in range(len(bucket_rep)):
                bsel = bucket_sel[bi]
                fused = model.pixel_fusion(
                    feats.pix_feat, pixel_readout, state.sensory,
                    state.last_mask * bsel[None, :, None, None])
                r, aux_b = model.readout_query(fused, obj_mem,
                                               selector=bsel[None].expand(b, o))
                sel5 = bsel[None, :, None, None, None]
                mem_readout = mem_readout + r * sel5
                if self.save_aux and aux_b is not None:
                    am = aux_b["attn_mask"].view(b, o, *aux_b["attn_mask"].shape[1:])
                    if aux is None:
                        aux = {"pixel_readout": fused * sel5,
                               "q_logits": aux_b["logits"] * sel5, "attn_mask": am}
                    else:
                        aux["pixel_readout"] = aux["pixel_readout"] + fused * sel5
                        aux["q_logits"] = aux["q_logits"] + aux_b["logits"] * sel5
                        aux["attn_mask"] = torch.where(sel5 > 0.5, am,
                                                       aux["attn_mask"])
            sensory, _, prob = model.segment(
                (feats.f16, feats.f8, feats.f4), mem_readout, state.sensory,
                selector=selector[None].expand(b, o), update_sensory=update_sensory)
            state.sensory = sensory
            if self.flip_aug:
                prob = 0.5 * (prob[0:1] + prob[1:2].flip(-1))
                last = prob[:, 1:]
                state.last_mask = torch.cat([last, last.flip(-1)])
            else:
                state.last_mask = prob[:, 1:]
            if aux is not None:
                aux["sensory"] = sensory
            return prob, aux

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
        with span("steps.memorize"):
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
        """Overwrite last_mask (after user-provided masks are merged) with
        prob_no_bg [1, O, Hp, Wp], mirrored into batch row 1 under
        flip_aug."""
        last = prob_no_bg.float()
        if self.flip_aug:
            last = torch.cat([last, last.flip(-1)])
        state.last_mask = last

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
        index, as jax.lax.top_k breaks them: a stable descending sort.

        Over sharded long-term buffers every rank gathers the whole of
        them, consolidates as one device would (the eviction ranks the
        usage of every slot) and keeps its slice: the result of the global
        gathers XLA inserts for cutie_tpu's _consolidate."""
        with span("steps.consolidate"):
            if self.lt_sharded():
                whole = self.gather_lt(state)
                self.consolidate_whole(whole, n_candidate_frames, lt_keep)
                whole = slice_lt(whole, self.lt_shard())
                for field in dataclasses.fields(state):
                    setattr(state, field.name, getattr(whole, field.name))
            else:
                self.consolidate_whole(state, n_candidate_frames, lt_keep)

    def consolidate_whole(self, state: MemoryState, n_candidate_frames: int,
                          lt_keep: Optional[int]) -> None:
        """consolidate on a state whose long-term buffers are whole."""
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
        prob, _ = self.segment(state, feats, selector, update_sensory,
                               bucket_rep, bucket_sel)
        if do_memorize:
            self.memorize(state, feats, selector, torch.zeros_like(selector),
                          mode="no")
        if n_out:
            lw, uw, lh, uh = pad
            hp, wp = prob.shape[-2:]
            prob = prob[0, :n_out, lh:hp - uh, lw:wp - uw]
        return prob
