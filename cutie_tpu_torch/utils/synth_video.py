"""Deterministic synthetic 480p video with three objects.

The port's own copy of tools/gen_golden.py:synth_frames_480: two translating
squares and a growing rectangle on a textured background, pure numpy. The
480p goldens tests/golden/stream480_*_trained.npz were recorded on it.
"""
from __future__ import annotations

import numpy as np


def synth_frames_480(t: int, h: int = 480, w: int = 854, seed: int = 9):
    """Returns (frames [t, 3, h, w] fp32 in [0, 1], first-frame index mask
    [h, w] int64 with objects 1, 2, 3)."""
    rng = np.random.default_rng(seed)
    bg = rng.uniform(0.2, 0.5, size=(h, w, 3)).astype(np.float32)
    frames = []
    mask0 = np.zeros((h, w), np.int64)
    sq = h // 5
    for ti in range(t):
        f = bg.copy()
        y1, x1 = h // 8 + ti * 4, w // 10 + ti * 6
        y2, x2 = h // 2 + ti * 2, 2 * w // 3 - ti * 5
        g = sq // 2 + ti * 3
        cy, cx = h // 3, w // 2
        f[y1:y1 + sq, x1:x1 + sq] = [0.9, 0.2, 0.1]
        f[y2:y2 + sq, x2:x2 + sq] = [0.1, 0.3, 0.9]
        f[max(cy - g, 0):cy + g, max(cx - g, 0):cx + g] = [0.2, 0.8, 0.2]
        f = np.round(f * 255.0) / 255.0
        frames.append(np.transpose(f, (2, 0, 1)).astype(np.float32))
        if ti == 0:
            mask0[y1:y1 + sq, x1:x1 + sq] = 1
            mask0[y2:y2 + sq, x2:x2 + sq] = 2
            mask0[cy - g:cy + g, cx - g:cx + g] = 3
    return np.stack(frames), mask0
