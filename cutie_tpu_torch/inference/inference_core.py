"""Streaming per-frame inference engine: the public API.

The port's counterpart of cutie_tpu/inference/inference_core.py (reference
cutie/inference/inference_core.py:18-345): step, output_prob_to_mask,
clear_memory, clear_non_permanent_memory, clear_sensory_memory and
delete_objects and update_config, with the mem_every cadence, staggered
sensory updates, partial-mask merging, force_permanent commits, in
long-term mode consolidation, and the eval options max_internal_size,
flip_aug, save_aux and amp (a model built with amp=True). The shell keeps
the host bookkeeping (object ids, buckets, cadence) and calls the step
functions over a fixed-capacity MemoryState on the model's device.

Inputs follow the reference: image is CHW float in [0, 1] or HWC uint8
(numpy or torch); masks are HW index masks or [num_objects, H, W] channel
masks. step returns a (num_objects+1, H, W) probability tensor on the
model's device.
"""
from __future__ import annotations

import logging
from typing import List, Optional

import numpy as np
import torch

from cutie_tpu_torch.inference.image_feature_store import ImageFeatureStore
from cutie_tpu_torch.inference.object_manager import ObjectManager
from cutie_tpu_torch.inference.state import (MemoryState, grow_perm,
                                             init_state, pad_objects,
                                             reorder_objects,
                                             resize_lt_capacity,
                                             resize_work_ring)
from cutie_tpu_torch.inference.steps import StepFunctions
from cutie_tpu_torch.ops.resize import bilinear_resize, nearest_exact_resize_np
from cutie_tpu_torch.ops.tensor_utils import aggregate_wbg_np, compute_pad
from cutie_tpu_torch.utils.tracing import span

log = logging.getLogger(__name__)

class InferenceCore:

    def __init__(self, network: torch.nn.Module, cfg):
        """network: a CUTIE model (utils.get_default_model.build_model);
        cfg: an eval config. Runs on the model's device."""
        self.network = network
        self.cfg = cfg
        self.device = next(network.parameters()).device
        # see internal_size; outputs are upsampled back to the input's size
        self.max_internal_size = cfg.get("max_internal_size", -1)
        self.flip_aug = bool(cfg.get("flip_aug", False))
        # with save_aux, the last segmented frame's aux tensors
        # (StepFunctions.segment)
        self.save_aux = bool(cfg.get("save_aux", False))
        self.aux = None
        self.steps = StepFunctions(network, cfg)
        self.image_feature_store = ImageFeatureStore(self.steps)
        if cfg.get("mem_every") is None or cfg.get("use_long_term") is None:
            # eval_config leaves both to the dataset preset
            raise ValueError("cfg.mem_every and cfg.use_long_term are unset: "
                             "call config.get_dataset_cfg(cfg) or set them")
        self.mem_every = cfg.mem_every
        stagger_updates = cfg.stagger_updates
        if stagger_updates >= self.mem_every:
            self.stagger_ti = set(range(1, self.mem_every + 1))
        else:
            self.stagger_ti = set(np.round(np.linspace(
                1, self.mem_every, stagger_updates)).astype(int))
        # memory budgets; -1: the first frame becomes permanent memory
        # (memory_manager.py:29-38)
        self.use_long_term = bool(cfg.get("use_long_term", False))
        if self.use_long_term:
            lt = cfg.long_term
            self.max_mem_frames = lt.max_mem_frames - 1
            self.min_mem_frames = lt.min_mem_frames - 1
            self.num_prototypes = lt.num_prototypes
            self.max_long_tokens = lt.max_num_tokens
            self.buffer_tokens = lt.buffer_tokens
            # one slack slot: consolidation runs once the ring holds
            # max_mem_frames frames, so the ring never overwrites a frame
            self.ring_frames = self.max_mem_frames + 1
            self.lt_capacity = self._round_lt_cap(self.max_long_tokens
                                                  + self.num_prototypes)
        else:
            self.max_mem_frames = cfg.max_mem_frames - 1
            self.ring_frames = max(self.max_mem_frames, 1)
            self.lt_capacity = 0
        # long-term consolidations run since construction
        self.consolidations = 0
        self.object_manager = ObjectManager()
        self.clear_memory()

    # ------------------------------------------------------------------ admin

    @property
    def engaged(self) -> bool:
        return self.state is not None and (self.state.perm_n > 0
                                           or self.state.work_count > 0)

    def clear_memory(self) -> None:
        self.curr_ti = -1
        self.last_mem_ti = 0
        self.state: Optional[MemoryState] = None
        # objects first seen in the same step share a bucket (reference
        # kv_memory_store.py:26-40); slot i -> bucket id
        self._slot_bucket: list = []
        self._next_bucket = 0
        self._new_slots: list = []
        self.pad = None

    def clear_non_permanent_memory(self) -> None:
        """Forget the working and long-term memory; keep the permanent
        memory (inference_core.py:124-140)."""
        self.curr_ti = -1
        self.last_mem_ti = 0
        st = self.state
        if st is not None:
            st.work_start = st.work_count = st.lt_count = 0
            for t in (st.work_obj_valid, st.lt_obj_valid, st.work_use,
                      st.work_life, st.lt_use, st.lt_life):
                t.zero_()

    def clear_sensory_memory(self) -> None:
        """Forget the sensory memory (inference_core.py:142-146)."""
        self.curr_ti = -1
        self.last_mem_ti = 0
        if self.state is not None:
            self.state.sensory.zero_()

    def update_config(self, cfg) -> None:
        """Change the memory budgets mid-video (cutie_tpu
        inference_core.py:147-205; reference inference_core.py:67-69 and
        memory_manager.py:59-75): mem_every and top_k take effect on the
        next frame; max_mem_frames, and in long-term mode the long-term
        budgets, reallocate the ring and the long-term buffers on the
        state's device. use_long_term cannot change."""
        if self.use_long_term != bool(cfg["use_long_term"]):
            # the error type cutie_tpu and the reference raise
            raise AssertionError("use_long_term cannot be updated")
        self.mem_every = cfg["mem_every"]
        self.steps.top_k = int(cfg["top_k"])
        st = self.state
        if self.use_long_term:
            lt = cfg["long_term"]
            self.max_mem_frames = lt["max_mem_frames"] - 1
            self.min_mem_frames = lt["min_mem_frames"] - 1
            self.max_long_tokens = lt["max_num_tokens"]
            self.buffer_tokens = lt["buffer_tokens"]
            new_ring = self.max_mem_frames + 1
            new_lt_cap = self._round_lt_cap(self.max_long_tokens + self.num_prototypes)
            if new_lt_cap != self.lt_capacity:
                self.lt_capacity = new_lt_cap
                if st is not None:
                    self.state = st = resize_lt_capacity(
                        self.steps.gather_lt(st), new_lt_cap, self.steps.lt_shard())
            # on a ring shrink, consolidate with the old ring intact until
            # the surviving frames fit: the reference consolidates before it
            # trims (memory_manager.py:282-296), where resizing first would
            # drop the oldest frames instead of absorbing them
            if st is not None and new_ring < self.ring_frames:
                while (st.work_count > new_ring
                       and st.work_count > self.min_mem_frames):
                    before = st.work_count
                    self._maybe_consolidate()
                    if st.work_count >= before:
                        break
        else:
            self.max_mem_frames = cfg["max_mem_frames"] - 1
            new_ring = max(self.max_mem_frames, 1)
        if new_ring != self.ring_frames:
            self.ring_frames = new_ring
            if st is not None:
                self.state = st = resize_work_ring(st, new_ring)
        # a ring shrunk to exactly full would make the next memory frame
        # overwrite an unconsolidated frame: drain it now
        if (self.use_long_term and st is not None
                and st.work_count >= self.ring_frames
                and st.work_count > self.min_mem_frames):
            self._maybe_consolidate()

    # -------------------------------------------------------------- internals

    def _round_lt_cap(self, cap: int) -> int:
        """The long-term allocation rounded up to a multiple of the memory
        mesh, so that the token axis divides across its ranks (cutie_tpu
        inference_core.py:208-215): capacity only, max_num_tokens still
        decides when eviction runs, and the extra slots stay invalid."""
        if self.steps.mem_mesh is None:
            return cap
        d = self.steps.mem_mesh.size
        return -(-cap // d) * d

    def _selector(self) -> torch.Tensor:
        sel = torch.zeros(self.state.num_objects, device=self.device)
        sel[:self.object_manager.num_obj] = 1.0
        return sel

    def _buckets(self):
        """(bucket_rep tuple, bucket_sel [num_buckets, O]) for the read."""
        o = self.state.num_objects
        if not self._slot_bucket:
            return (0,), torch.ones((1, o), device=self.device)
        groups = {}
        for slot, b in enumerate(self._slot_bucket):
            groups.setdefault(b, []).append(slot)
        reps = tuple(slots[0] for slots in groups.values())
        sel = torch.zeros((len(groups), o), device=self.device)
        for bi, slots in enumerate(groups.values()):
            sel[bi, slots] = 1.0
        return reps, sel

    def _ensure_state(self, h16: int, w16: int, num_obj: int) -> None:
        # the object axis holds exactly the live objects: PyTorch runs
        # eagerly, so a new count costs no recompilation and needs no
        # padded capacity buckets
        mc = self.cfg.model
        cap = num_obj
        if self.state is None:
            self.state = init_state(
                batch=2 if self.flip_aug else 1, max_objects=cap, h=h16, w=w16,
                sensory_dim=mc.sensory_dim, key_dim=mc.key_dim,
                value_dim=mc.value_dim,
                num_queries=mc.object_transformer.num_queries,
                embed_dim=mc.object_transformer.embed_dim,
                perm_frames=max(self.cfg.get("perm_frame_capacity", 1), 1),
                work_frames=self.ring_frames, lt_capacity=self.lt_capacity,
                value_dtype=self.network.compute_dtype, device=self.device,
                lt_shard=self.steps.lt_shard())
        elif self.state.num_objects < cap:
            self.state = pad_objects(self.state, cap)

    def _maybe_consolidate(self) -> None:
        """Consolidate once the ring holds max_mem_frames frames, evicting
        first when the long-term memory is near its budget
        (inference_core.py:331-345)."""
        st = self.state
        if not self.use_long_term or st.work_count < self.max_mem_frames:
            return
        lt_keep = None
        if st.lt_count >= self.max_long_tokens - self.num_prototypes:
            lt_keep = (self.max_long_tokens - self.num_prototypes
                       - self.buffer_tokens)
        self.steps.consolidate(st, st.work_count - self.min_mem_frames, lt_keep)
        self.consolidations += 1

    def _merge_input_mask(self, mask, objects, idx_mask: bool,
                          pred_prob_with_bg: Optional[np.ndarray],
                          h_pad: int, w_pad: int) -> np.ndarray:
        """Combine a (possibly partial) user mask with the prediction by
        mutual exclusivity (inference_core.py:258-300). Returns the padded
        per-slot last mask [O, Hp, Wp] (numpy)."""
        prev_n = len(self._slot_bucket)
        tmp_ids, _ = self.object_manager.add_new_objects(list(objects))
        self._ensure_state(h_pad // 16, w_pad // 16, self.object_manager.num_obj)
        self._new_slots = []
        if self.object_manager.num_obj > prev_n:
            bucket = self._next_bucket
            self._next_bucket += 1
            for slot in range(prev_n, self.object_manager.num_obj):
                self._slot_bucket.append(bucket)
                self._new_slots.append(slot)
        o = self.state.num_objects
        mask = np.asarray(mask)
        lw, uw, lh, uh = self.pad
        if idx_mask:
            mask_p = np.zeros((h_pad, w_pad), mask.dtype)
            mask_p[lh:h_pad - uh, lw:w_pad - uw] = mask
        else:
            mask_p = np.zeros((mask.shape[0], h_pad, w_pad), np.float32)
            mask_p[:, lh:h_pad - uh, lw:w_pad - uw] = mask

        out = np.zeros((o, h_pad, w_pad), np.float32)
        if pred_prob_with_bg is not None:
            pred_no_bg = np.asarray(pred_prob_with_bg[1:o + 1], np.float32).copy()
            if idx_mask:
                pred_no_bg[:, mask_p > 0] = 0
            else:
                pred_no_bg[:, mask_p.max(0) > 0.5] = 0
            out[:pred_no_bg.shape[0]] = pred_no_bg
        for mask_id, tmp_id in enumerate(tmp_ids):
            if idx_mask:
                out[tmp_id - 1] = (mask_p == objects[mask_id]).astype(np.float32)
            else:
                out[tmp_id - 1] = mask_p[mask_id]
        return out

    def internal_size(self, h: int, w: int):
        """The size an h x w frame is segmented at: its shorter side scaled
        down to max_internal_size where it exceeds it."""
        m = self.max_internal_size
        if 0 < m < min(h, w):
            return int(h / min(h, w) * m), int(w / min(h, w) * m)
        return h, w

    def _to_image(self, image) -> torch.Tensor:
        """[3, H, W] float in [0, 1] on the device, from CHW float or HWC
        uint8 input (numpy or torch)."""
        if not torch.is_tensor(image):
            image = torch.from_numpy(np.asarray(image))
        image = image.to(self.device)
        if image.dtype == torch.uint8 and image.dim() == 3 and image.shape[-1] == 3:
            return image.permute(2, 0, 1).float() / 255.0
        return image.float()

    # ------------------------------------------------------------------- step

    @torch.no_grad()
    def step(self, image, mask=None, objects: Optional[List[int]] = None, *,
             idx_mask: bool = True, end: bool = False,
             delete_buffer: bool = True, force_permanent: bool = False
             ) -> torch.Tensor:
        """See reference inference_core.py:172-201 for the full semantics.
        One call is one span inference_core.step (utils/tracing.py)."""
        with span("inference_core.step"):
            if objects is None and mask is not None:
                if idx_mask:
                    raise ValueError("an index mask needs its object ids")
                objects = list(range(1, mask.shape[0] + 1))
            with span("inference_core.upload"):
                image = self._to_image(image)
                orig_h, orig_w = image.shape[-2:]
                new_h, new_w = self.internal_size(orig_h, orig_w)
                resize_needed = (new_h, new_w) != (orig_h, orig_w)
                if resize_needed:
                    # non-antialiased bilinear on the device, as the reference
                    # (inference_core.py:203-225); index masks nearest-exact
                    image = bilinear_resize(image, new_h, new_w)
                    if mask is not None:
                        mask = np.asarray(mask)
                        mask = (nearest_exact_resize_np(mask, new_h, new_w)
                                if idx_mask else bilinear_resize(
                                    torch.from_numpy(mask.astype(np.float32)),
                                    new_h, new_w).numpy())
            h, w = image.shape[-2:]
            self.curr_ti += 1
            self.pad = compute_pad(h, w, 16)
            lw, uw, lh, uh = self.pad
            h_pad, w_pad = h + lh + uh, w + lw + uw

            is_mem_frame = ((self.curr_ti - self.last_mem_ti >= self.mem_every)
                            or (mask is not None)) and (not end)
            need_segment = (mask is None) or (
                self.object_manager.num_obj > 0
                and not self.object_manager.has_all(list(objects)))
            update_sensory = ((self.curr_ti - self.last_mem_ti)
                              in self.stagger_ti) and (not end)

            def restore_size(prob):
                return bilinear_resize(prob, orig_h, orig_w) if resize_needed else prob

            if (mask is None and self.engaged and not force_permanent
                    and not self.save_aux and delete_buffer
                    and self.curr_ti not in self.image_feature_store):
                bucket_rep, bucket_sel = self._buckets()
                prob = self.steps.step_plain(
                    self.state, image, self._selector(), bucket_rep, bucket_sel,
                    update_sensory=update_sensory, do_memorize=is_mem_frame,
                    pad=self.pad, n_out=self.object_manager.num_obj + 1)
                if is_mem_frame:
                    self.last_mem_ti = self.curr_ti
                    self._maybe_consolidate()
                return restore_size(prob)

            feats = self.image_feature_store.get_features(self.curr_ti, image,
                                                          pad=self.pad)

            def empty_result():
                # free the features cached above (nothing will consume them: ti
                # advances every step) and match the normal output size
                if delete_buffer:
                    self.image_feature_store.delete(self.curr_ti)
                return torch.zeros((1, orig_h, orig_w), device=self.device)

            pred_prob_with_bg = None
            if need_segment:
                if not self.engaged:
                    log.warning("Trying to segment without any memory!")
                    return empty_result()
                bucket_rep, bucket_sel = self._buckets()
                prob, aux = self.steps.segment(self.state, feats, self._selector(),
                                               update_sensory, bucket_rep, bucket_sel)
                if self.save_aux:
                    self.aux = aux
                pred_prob_with_bg = prob[0]

            if mask is not None:
                if idx_mask and len(objects) == 0:
                    log.warning("Trying to insert an empty mask as memory!")
                    return empty_result()
                with span("inference_core.merge_mask"):
                    pred_np = (pred_prob_with_bg.cpu().numpy()
                               if pred_prob_with_bg is not None else None)
                    last_mask = self._merge_input_mask(mask, objects, idx_mask,
                                                       pred_np, h_pad, w_pad)
                    prob_with_bg = torch.from_numpy(
                        aggregate_wbg_np(last_mask, keep_bg=True)).to(self.device)
                    self.steps.set_last_mask(self.state, prob_with_bg[None, 1:])
                pred_prob_with_bg = prob_with_bg

            if is_mem_frame or force_permanent:
                hw = (h_pad // 16) * (w_pad // 16)
                if force_permanent or not self.engaged:
                    mode = "all"
                elif self._new_slots:
                    mode = "split"   # new objects' tokens become permanent
                else:
                    mode = "no"
                if mode in ("all", "split"):
                    need = self.state.perm_n + hw
                    if need > self.state.perm_key.shape[1]:
                        self.state = grow_perm(self.state, need)
                new_mask = torch.zeros(self.state.num_objects, device=self.device)
                new_mask[self._new_slots] = 1.0
                self.steps.memorize(self.state, feats, self._selector(), new_mask,
                                    mode=mode)
                self.last_mem_ti = self.curr_ti
                if mode in ("no", "split"):
                    self._maybe_consolidate()
            self._new_slots = []
            if delete_buffer:
                self.image_feature_store.delete(self.curr_ti)

            out = pred_prob_with_bg[:, lh:h_pad - uh, lw:w_pad - uw]
            return restore_size(out[:self.object_manager.num_obj + 1])

    # ------------------------------------------------------------- public api

    def delete_objects(self, objects: List[int]) -> None:
        """Remove objects from the bookkeeping and from memory
        (inference_core.py:330-335)."""
        old_order = {obj.id: tmp
                     for obj, tmp in self.object_manager.obj_to_tmp_id.items()}
        old_buckets = list(self._slot_bucket)
        self.object_manager.delete_objects(objects)
        if self.state is None:
            return
        o = self.state.num_objects
        idx = [old_order[self.object_manager.tmp_id_to_obj[t].id] - 1
               for t in range(1, self.object_manager.num_obj + 1)]
        keep = len(idx)
        self._slot_bucket = [old_buckets[i] for i in idx]
        self.state = reorder_objects(
            self.state, torch.tensor(idx + [0] * (o - keep), device=self.device),
            torch.tensor([1.0] * keep + [0.0] * (o - keep), device=self.device))

    def output_prob_to_mask(self, output_prob: torch.Tensor) -> np.ndarray:
        """argmax, then temporary ids -> object ids (inference_core.py:337-345),
        in the span inference_core.to_host."""
        with span("inference_core.to_host"):
            mask = output_prob.argmax(dim=0).cpu().numpy()
            return self.object_manager.tmp_to_obj_cls(mask)
