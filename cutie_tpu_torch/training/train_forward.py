"""The training-time unrolled sequence forward.

The port's counterpart of cutie_tpu/training/train_forward.py (reference
cutie/model/train_wrapper.py:25-112): encode all T frames in one backbone
pass, seed the memory with the first frame's ground truth, then unroll
t = 1..T-1 with at most num_ref_frames randomly chosen reference frames,
full-softmax memory reads, segmentation, and re-encoding of the predicted
masks with a Bernoulli(deep_update_prob) deep update. The predicted masks
are not detached between frames: the gradient runs back through time, as
in cutie_tpu.

The random choices (reference subsets, deep updates) are drawn on the host
from a CPU torch.Generator, so the unroll never waits for the device. A
data-parallel rank draws them for the whole global batch and takes its own
rows, so every rank's generator stays in step and one rank of D equals one
process on the global batch (cutie_tpu draws one key for its sharded global
batch).
stage_cfg.remat runs each stage call under torch.utils.checkpoint, which
keeps its inputs and recomputes the rest in the backward (cutie_tpu's
jax.checkpoint). Each stage method enters its own autocast (models/cutie.py:
_stage), so the recompute runs at the same precision.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from cutie_tpu_torch.models.cutie import CUTIE


def _stage_caller(model: CUTIE, remat: bool):
    def call(name, *args, **kwargs):
        fn = getattr(model, name)
        if remat:
            return checkpoint(fn, *args, use_reentrant=False,
                              preserve_rng_state=False, **kwargs)
        return fn(*args, **kwargs)
    return call


def train_forward(model: CUTIE, data: Dict[str, torch.Tensor],
                  generator: torch.Generator, stage_cfg,
                  rows: Optional[Tuple[int, int]] = None
                  ) -> Dict[str, torch.Tensor]:
    """
    data (on the model's device):
      frames          [B, T, 3, H, W] float in [0, 1]
      first_frame_gt  [B, O, H, W] one-hot (padded object channels zero)
      selector        [B, O] 1 / 0
    generator: a CPU torch.Generator for the reference subsets and the deep
    updates. rows: (offset, global batch) when data holds rows [offset,
    offset + B) of a larger batch (a data-parallel rank).
    Returns {'logits' [B, T-1, O+1, H, W], 'logits_low' [B, T-1, O+1, H/4,
    W/4] (before the upsample; the loss samples it), 'sensory_logits'
    [B, T-1, O+1, H/16, W/16], 'q_logits' [B, T-1, O+1, L, H/16, W/16]}.
    """
    call = _stage_caller(model, bool(stage_cfg.get("remat", False)))
    frames = data["frames"]
    first_frame_gt = data["first_frame_gt"].float()
    selector = data["selector"]
    b, seq_length = frames.shape[:2]
    num_objects = first_frame_gt.shape[1]
    num_ref = stage_cfg.num_ref_frames
    deep_update_prob = float(stage_cfg.deep_update_prob)
    offset, global_b = rows or (0, b)

    # one backbone pass over all frames (train_wrapper.py:42-45)
    ms_feat, pix_feat = call("encode_image", frames.flatten(0, 1))
    keys, shrinkages, selections = call("transform_key", ms_feat[0].float())

    def unflat_t(x):
        return x.reshape(b, seq_length, *x.shape[1:])

    keys, shrinkages, selections = map(unflat_t, (keys, shrinkages, selections))
    ms_feat = [unflat_t(f) for f in ms_feat]
    pix_feat = unflat_t(pix_feat)
    h, w = keys.shape[-2:]

    sensory = torch.zeros(b, num_objects, model.model_cfg.sensory_dim, h, w,
                          device=frames.device)
    msk_val, sensory, obj_val, _ = call("encode_mask", frames[:, 0],
                                        pix_feat[:, 0], sensory,
                                        first_frame_gt, deep_update=True)
    masks = first_frame_gt
    msk_values = [msk_val]        # each [B, O, Cv, h, w]
    obj_values = [obj_val] if obj_val is not None else None

    all_logits, all_low, all_sensory_logits, all_q_logits = [], [], [], []
    for ti in range(1, seq_length):
        if ti <= num_ref:
            ref_msk_values = torch.stack(msk_values, dim=3)
            ref_keys = keys[:, :ti]
            ref_shrinkages = shrinkages[:, :ti]
        else:
            # a random subset of the ti stored frames, per sequence
            # (train_wrapper.py:76-81)
            ridx = torch.stack([torch.randperm(ti, generator=generator)[:num_ref]
                                for _ in range(global_b)])
            ridx = ridx[offset:offset + b].to(frames.device)
            rows = torch.arange(b, device=frames.device)[:, None]
            ref_msk_values = torch.stack(msk_values, dim=1)[rows, ridx]
            ref_msk_values = ref_msk_values.permute(0, 2, 3, 1, 4, 5)
            ref_keys = keys[rows, ridx]
            ref_shrinkages = shrinkages[rows, ridx]
        # every stored object summary is read, as in cutie_tpu: the subset
        # is of the pixel memory only
        ref_obj_values = (torch.stack(obj_values, dim=2)
                          if obj_values is not None else None)

        readout_mem, aux_input = call(
            "read_memory", keys[:, ti], selections[:, ti],
            ref_keys.transpose(1, 2), ref_shrinkages.transpose(1, 2),
            ref_msk_values, ref_obj_values, pix_feat[:, ti], sensory, masks,
            selector)
        aux_output = call("compute_aux", pix_feat[:, ti], aux_input, selector)
        sensory, logits, prob, logits_low = call(
            "segment", [f[:, ti] for f in ms_feat], readout_mem, sensory,
            selector=selector, return_low_logits=True)
        masks = prob[:, 1:]

        if ti < seq_length - 1:  # the last frame is not encoded
            deep_update = bool(torch.rand((), generator=generator)
                               < deep_update_prob)
            msk_val, sensory, obj_val, _ = call(
                "encode_mask", frames[:, ti], pix_feat[:, ti], sensory, masks,
                deep_update=deep_update)
            msk_values.append(msk_val)
            if obj_values is not None:
                obj_values.append(obj_val)

        all_logits.append(logits)
        all_low.append(logits_low)
        if "sensory_logits" in aux_output:
            all_sensory_logits.append(aux_output["sensory_logits"])
        if aux_output.get("q_logits") is not None:
            all_q_logits.append(aux_output["q_logits"])

    out = {"logits": torch.stack(all_logits, dim=1),
           "logits_low": torch.stack(all_low, dim=1)}
    if all_sensory_logits:
        out["sensory_logits"] = torch.stack(all_sensory_logits, dim=1)
    if all_q_logits:
        out["q_logits"] = torch.stack(all_q_logits, dim=1)
    return out
