"""The memory schedule of one video, worked out from the traffic's settings
and its events (vosbench/events).

Cutie's cadence (reference cutie/inference/inference_core.py and
memory_manager.py): a frame that carries a mask is memorized, and so is a
later frame when mem_every frames have passed since the last memorized one.
Objects first given in one frame form a bucket (kv_memory_store.py), whose
permanent memory is that frame's tokens; every later memorized frame joins
the working memory of each bucket, which outside long-term mode keeps its
last max_mem_frames - 1 frames. A frame's read is one read a bucket, over
that bucket's valid tokens, and reads out that bucket's objects; a frame
whose mask brings new objects reads over the buckets it had before them,
and one whose mask brings none reads nothing (it is not segmented). A
deleted object leaves its bucket before the step of its frame, and a bucket
left empty goes with its tokens. In long-term mode (one bucket), once the
working memory holds long_term.max_mem_frames - 1 frames, all but
min_mem_frames - 1 of them are consolidated into num_prototypes long-term
tokens, after evicting down to max_num_tokens - num_prototypes -
buffer_tokens tokens when the long-term memory has reached max_num_tokens -
num_prototypes.

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


class Memory:
    """The objects and buckets of one video as the schedule follows them:
    what an event kind's schedule(memory, event) changes."""

    def __init__(self):
        # each bucket: its objects, permanent tokens and working-memory frames
        self.buckets: List[Dict] = []
        self.given: List[int] = []

    def objects(self) -> List[int]:
        return [o for b in self.buckets for o in b["objects"]]

    def mask(self, objects: List[int]) -> None:
        """The frame's step is given a mask of `objects`."""
        self.given += [o for o in objects if o not in self.given]

    def delete(self, objects: List[int]) -> None:
        """`objects` leave before the frame's step."""
        for b in self.buckets:
            b["objects"] = [o for o in b["objects"] if o not in objects]
        self.buckets = [b for b in self.buckets if b["objects"]]


def video_schedule(core: dict, tokens: int, frames: int, script) -> List[Dict]:
    """One entry a frame of a video: kind (first / plain / memory), event
    (the check's name of the frame's events, vosbench/events:Script.name,
    or None), objects (segmented; 0 for a frame that is not), reads ([valid
    tokens, objects read out] of each bucket's read), memorized (the
    objects memorized, 0 for none), whether it consolidates, and the
    long-term tokens after it. script: the traffic's events."""
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
    memory = Memory()
    lt = 0
    last_mem = 0
    for t in range(frames):
        memory.given = []
        script.schedule(memory, t)
        known = memory.objects()
        new = [o for o in memory.given if o not in known]
        if not known and not memory.given:
            raise ValueError(f"position {t} has no object: "
                             "a video starts with a mask")
        segmented = bool(known) and (not memory.given or bool(new))
        reads = ([[b["perm"] + tokens * b["ring"] + lt, len(b["objects"])]
                  for b in memory.buckets] if segmented else [])
        if new:
            memory.buckets.append(dict(objects=new, perm=0, ring=0, new=True))
        if long_term and len(memory.buckets) > 1:
            raise ValueError("more than one bucket in long-term mode is not "
                             "modelled")
        memorized = (t - last_mem >= mem_every) or bool(memory.given) or t == 0
        consolidate = False
        if memorized:
            last_mem = t
            for b in memory.buckets:
                if b.pop("new", False):
                    b["perm"] += tokens
                    continue
                b["ring"] += 1
                if not long_term:
                    b["ring"] = min(b["ring"], ring_max)
                elif b["ring"] >= ring_max:
                    if lt >= max_lt - protos:
                        lt = max_lt - protos - buffer
                    lt += protos
                    b["ring"] = ring_min
                    consolidate = True
        kind = FIRST if t == 0 else MEMORY if memorized else PLAIN
        out.append(dict(kind=kind, event=script.name(t),
                        objects=len(known) if segmented else 0, reads=reads,
                        memorized=len(memory.objects()) if memorized else 0,
                        consolidate=consolidate, lt=lt))
    return out
