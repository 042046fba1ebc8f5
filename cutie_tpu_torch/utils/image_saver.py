"""Training visualisation grids.

The port's counterpart of cutie_tpu/utils/image_saver.py (reference
cutie/utils/image_saver.py), numpy only: rows of rgb, ground-truth overlay
and prediction overlay across a sequence, in the port's channels-first
frame layout.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from cutie_tpu_torch.utils.palette import davis_palette_np


def _overlay(image: np.ndarray, cls_mask: np.ndarray, alpha=0.5) -> np.ndarray:
    """image [H, W, 3] float in [0, 1]; cls_mask [H, W] ints -> uint8 overlay."""
    colors = davis_palette_np[np.clip(cls_mask, 0, 255)]
    fg = (cls_mask > 0)[..., None]
    out = image * 255.0
    out = np.where(fg, out * (1 - alpha) + colors * alpha, out)
    return out.astype(np.uint8)


def vis_sequence(data: Dict[str, np.ndarray], logits: Optional[np.ndarray],
                 bi: int = 0, max_frames: int = 8) -> np.ndarray:
    """A [rows x T] grid for sequence `bi` of a training batch.

    data: frames [B, T, 3, H, W], cls_gt [B, T, H, W]; logits
    [B, T-1, C, H, W] or None. Returns an HWC uint8 grid (rows: rgb / gt /
    prediction; the prediction of frame 0 is its given ground truth)."""
    frames = np.moveaxis(np.asarray(data["frames"][bi]), 1, -1)
    cls_gt = np.asarray(data["cls_gt"][bi])
    t = min(frames.shape[0], max_frames)

    rows = [np.concatenate([(frames[ti] * 255).astype(np.uint8)
                            for ti in range(t)], axis=1),
            np.concatenate([_overlay(frames[ti], cls_gt[ti])
                            for ti in range(t)], axis=1)]
    if logits is not None:
        logits = np.asarray(logits[bi])
        preds = [cls_gt[0]] + [logits[ti - 1].argmax(0) for ti in range(1, t)]
        rows.append(np.concatenate([_overlay(frames[ti], preds[ti])
                                    for ti in range(t)], axis=1))
    return np.concatenate(rows, axis=0)
