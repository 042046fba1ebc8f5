"""Training losses: point-sampled cross-entropy and dice, with aux terms.

The port's counterpart of cutie_tpu/training/losses.py (reference
cutie/model/losses.py:11-97). As in cutie_tpu, each sequence's losses run
over the padded object-channel axis with a channel mask (the selector)
that restores the reference's mean over the valid channels; the main head
is sampled on the virtual 4x upsample of its stride-4 logits, and the
labels on the one-hot of the integer class map. A loop over the batch takes
the place of cutie_tpu's vmap.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from cutie_tpu_torch.ops.point_features import (calculate_uncertainty,
                                                draw_point_candidates,
                                                pick_uncertain_points,
                                                point_sample,
                                                point_sample_cls_onehot,
                                                point_sample_upsampled)

# draw(n, device) -> (candidates [n, S, 2], random points [n, R, 2])
PointDraw = Callable[[int, torch.device], Tuple[torch.Tensor, torch.Tensor]]


def ce_loss(logits: torch.Tensor, soft_gt: torch.Tensor) -> torch.Tensor:
    """logits / soft_gt [T, C, P]: sum over T, mean over P (losses.py:11-16)."""
    loss = -(soft_gt * torch.log_softmax(logits, dim=1)).sum(dim=1)  # [T, P]
    return loss.sum(0).mean()


def dice_loss(mask: torch.Tensor, soft_gt: torch.Tensor,
              ch_mask: torch.Tensor) -> torch.Tensor:
    """mask / soft_gt [T, C, P] (probabilities / one-hot); ch_mask [C-1],
    the validity of the foreground channels (losses.py:19-29: background
    left out, sum over T, mean over the valid channels)."""
    mask = mask[:, 1:]
    gt = soft_gt[:, 1:]
    numerator = 2 * (mask * gt).sum(-1)
    denominator = mask.sum(-1) + gt.sum(-1)
    loss = (1 - (numerator + 1) / (denominator + 1)) * ch_mask[None]
    return loss.sum() / ch_mask.sum().clamp_min(1)


class LossComputer:
    """(losses.py:32-97)"""

    def __init__(self, cfg, stage_cfg):
        self.num_points = stage_cfg.train_num_points
        self.oversample_ratio = stage_cfg.oversample_ratio
        self.importance_sample_ratio = stage_cfg.importance_sample_ratio
        self.sensory_weight = cfg.model.aux_loss.sensory.weight
        self.query_weight = cfg.model.aux_loss.query.weight
        if not stage_cfg.point_supervision:
            raise NotImplementedError("only point supervision is supported")

    def uniform_draw(self, generator: Optional[torch.Generator]) -> PointDraw:
        """The point draws of a training step, from `generator`."""
        def draw(n, device):
            return draw_point_candidates(generator, n, self.num_points,
                                         self.oversample_ratio,
                                         self.importance_sample_ratio, device)
        return draw

    def mask_loss(self, logits: torch.Tensor, cls_gt: torch.Tensor,
                  ch_mask: torch.Tensor, points: Tuple[torch.Tensor, torch.Tensor],
                  up_factor: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
        """logits [T, C, h, w] at their own resolution, sampled on their
        virtual up_factor-x upsample; cls_gt [T, H, W] integer; points: the
        (candidates, random points) of draw_point_candidates."""
        if up_factor > 1:
            def sample(x, c):
                return point_sample_upsampled(x, c, up_factor)
        else:
            sample = point_sample
        coords = pick_uncertain_points(
            logits.detach(), *points,
            int(self.importance_sample_ratio * self.num_points),
            calculate_uncertainty, sample)
        labels = point_sample_cls_onehot(cls_gt, coords, logits.shape[1])
        point_logits = sample(logits, coords)
        return (ce_loss(point_logits, labels),
                dice_loss(torch.softmax(point_logits, dim=1), labels, ch_mask))

    def compute(self, data: Dict[str, torch.Tensor], selector: torch.Tensor,
                draw: PointDraw, rows: Optional[Tuple[int, int]] = None
                ) -> Dict[str, torch.Tensor]:
        """data: {'logits_low' [B, T-1, C, h4, w4] (stride 4, before the
        upsample), 'cls_gt' [B, T-1, H, W] integer, and optionally
        'sensory_logits' [B, T-1, C, h, w], 'q_logits' [B, T-1, C, L, h, w]};
        selector [B, O] with C = O + 1. Points are drawn per sequence, in
        cutie_tpu's order: the main head, the sensory head, then each query
        level. rows: (offset, global batch) when data holds rows [offset,
        offset + B) of a larger batch: the points are drawn for every
        sequence of the global batch and each row takes its sequence's.
        Returns the means over the rows and their sum, 'total_loss'."""
        b = data["logits_low"].shape[0]
        offset, global_b = rows or (0, b)
        n = data["cls_gt"].shape[1]
        draws = 1 + ("sensory_logits" in data) + (
            data["q_logits"].shape[3] if "q_logits" in data else 0)
        per_seq = []
        for gi in range(global_b):
            bi = gi - offset
            if not 0 <= bi < b:
                for _ in range(draws):   # another rank's sequence
                    draw(n, data["cls_gt"].device)
                continue
            cls_gt = data["cls_gt"][bi]
            ch_mask = selector[bi]
            n = cls_gt.shape[0]
            losses = {}
            losses["loss_ce"], losses["loss_dice"] = self.mask_loss(
                data["logits_low"][bi], cls_gt, ch_mask,
                draw(n, cls_gt.device), up_factor=4)
            if "sensory_logits" in data:
                lc, ld = self.mask_loss(data["sensory_logits"][bi], cls_gt,
                                        ch_mask, draw(n, cls_gt.device))
                losses["aux_sensory_ce"] = lc * self.sensory_weight
                losses["aux_sensory_dice"] = ld * self.sensory_weight
            if "q_logits" in data:
                aux_q = data["q_logits"][bi]
                for level in range(aux_q.shape[2]):
                    lc, ld = self.mask_loss(aux_q[:, :, level], cls_gt, ch_mask,
                                            draw(n, cls_gt.device))
                    losses[f"aux_query_ce_l{level}"] = lc * self.query_weight
                    losses[f"aux_query_dice_l{level}"] = ld * self.query_weight
            per_seq.append(losses)
        out = {k: torch.stack([s[k] for s in per_seq]).mean() for k in per_seq[0]}
        out["total_loss"] = sum(out.values())
        return out
