"""The memory schedule of one video, worked out from the traffic's settings.

Cutie's cadence (reference cutie/inference/inference_core.py and
memory_manager.py): frame 0 carries the mask and becomes permanent memory;
a later frame is a memory frame when mem_every frames have passed since the
last one; outside long-term mode the working memory is a FIFO of
max_mem_frames - 1 frames; in long-term mode, once the working memory holds
long_term.max_mem_frames - 1 frames, all but min_mem_frames - 1 of them are
consolidated into num_prototypes long-term tokens, after evicting down to
max_num_tokens - num_prototypes - buffer_tokens tokens when the long-term
memory has reached max_num_tokens - num_prototypes.

The benchmark counts a frame's work from this schedule, never from what the
program reports.
"""
from __future__ import annotations

from typing import Dict, List

FIRST, PLAIN, MEMORY = "first", "plain", "memory"


def tokens_per_frame(h: int, w: int) -> int:
    """Stride-16 tokens of an h x w frame, padded to multiples of 16."""
    return -(-h // 16) * -(-w // 16)


def internal_size(h: int, w: int, max_internal_size: int):
    """The size a frame is segmented at (InferenceCore's max_internal_size)."""
    m = max_internal_size
    if 0 < m < min(h, w):
        return int(h / min(h, w) * m), int(w / min(h, w) * m)
    return h, w


def video_schedule(core: dict, tokens: int, frames: int) -> List[Dict]:
    """One entry a frame of a video: kind (first / plain / memory), the
    valid memory tokens its read covers (read_tokens, 0 for the first
    frame), whether it consolidates, and the long-term tokens after it."""
    mem_every = int(core["mem_every"])
    long_term = bool(core["use_long_term"])
    if long_term:
        lt_cfg = core["long_term"]
        ring_max = int(lt_cfg["max_mem_frames"]) - 1
        ring_min = int(lt_cfg["min_mem_frames"]) - 1
        protos = int(lt_cfg["num_prototypes"])
        max_lt = int(lt_cfg["max_num_tokens"])
        buffer = int(lt_cfg["buffer_tokens"])
    else:
        ring_max = max(int(core["max_mem_frames"]) - 1, 1)
    out = []
    ring = lt = 0
    last_mem = 0
    for t in range(frames):
        if t == 0:
            out.append(dict(kind=FIRST, read_tokens=0, consolidate=False, lt=0))
            continue
        read_tokens = tokens * (1 + ring) + lt
        memory = t - last_mem >= mem_every
        consolidate = False
        if memory:
            last_mem = t
            ring += 1
            if not long_term:
                ring = min(ring, ring_max)
            elif ring >= ring_max:
                if lt >= max_lt - protos:
                    lt = max_lt - protos - buffer
                lt += protos
                ring = ring_min
                consolidate = True
        out.append(dict(kind=MEMORY if memory else PLAIN, read_tokens=read_tokens,
                        consolidate=consolidate, lt=lt))
    return out
