"""The one traffic generator: a seeded synthetic video from a traffic file.

A traffic file (vosbench/traffic/<name>.json) gives the frame size, the
objects drawn (`objects`: a count, or {"drawn": count} where events,
vosbench/events, say when each is given), how the stream is cut into videos (clip_frames; null for
one continuous video), the warm-up, the InferenceCore settings ("core"),
the video's look ("video"), the traced sub-window ("trace") and what the
correctness check samples ("check").

The video: a textured background and `objects` textured ellipses, each
moving along a bounded sinusoidal path inside a cell of its own, so objects
never overlap or leave the frame. A pool of `pool_frames` frames is drawn
once into host memory and played forward and back, so a stream of any
length costs one pool. Each pass through the pool shows it cropped one
row lower (the pool is `jitter_rows` rows taller than the frame), so no
two frames within jitter_rows passes are identical: bit-identical frames
would put bit-identical keys in memory, whose exact ties a program and a
reference may break apart by one rounding. The crop is a contiguous view,
so handing a frame over costs no copy. Every seed draws the same sizes;
only content differs.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np

SEED_MASK = (1 << 64) - 1


def drawn_objects(traffic: dict) -> int:
    """The number of objects a traffic file's video draws."""
    objects = traffic["objects"]
    return int(objects["drawn"] if isinstance(objects, dict) else objects)


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    """An independent numpy generator for (seed, stream...); any integer
    seed, negative or wider than 64 bits included."""
    return np.random.default_rng([seed & SEED_MASK, (seed >> 64) & SEED_MASK,
                                  *stream])


class SyntheticVideo:
    """The seeded frame pool of one traffic mix."""

    def __init__(self, traffic: dict, seed: int):
        h, w = traffic["frame"]
        self.h, self.w = h, w
        self.num_objects = n = drawn_objects(traffic)
        self.pool_frames = p = int(traffic["pool_frames"])
        look = traffic["video"]
        self.jitter = jit = int(look["jitter_rows"])
        top = jit                   # objects stay inside every crop
        h_obj = h - jit
        h = h + jit
        rng = rng_for(seed, 1)
        y = np.arange(h, dtype=np.float32)[:, None, None]
        x = np.arange(w, dtype=np.float32)[None, :, None]
        # background: two plaid layers per channel and a fixed grain
        bg = np.full((h, w, 3), 0.45, np.float32)
        for _ in range(2):
            fy, fx = rng.uniform(*look["texture_freq"], size=(2, 3))
            py, px = rng.uniform(0, 2 * math.pi, size=(2, 3))
            bg += 0.12 * np.sin(fy * y + py) * np.sin(fx * x + px)
        bg += look["grain"] * rng.standard_normal((h, w, 3), dtype=np.float32)
        # one cell of a grid per object; the object moves inside it
        rows = int(math.ceil(math.sqrt(n)))
        cols = int(math.ceil(n / rows))
        ch, cw = h_obj / rows, w / cols
        objs = []
        for i in range(n):
            r, c = divmod(i, cols)
            size = rng.uniform(*look["object_size"])
            ry, rx = size * ch, size * cw * rng.uniform(0.6, 1.0)
            amp_y = look["motion"] * (ch / 2 - ry)
            amp_x = look["motion"] * (cw / 2 - rx)
            objs.append(dict(
                cy=top + (r + 0.5) * ch, cx=(c + 0.5) * cw, ry=ry, rx=rx,
                ay=amp_y, ax=amp_x,
                period=rng.uniform(*look["period_frames"], size=2),
                phase=rng.uniform(0, 2 * math.pi, size=2),
                color=rng.uniform(0.1, 0.9, size=3).astype(np.float32),
                stripe=rng.uniform(0.05, 0.3), tilt=rng.uniform(0, math.pi)))
        frames = np.empty((p, h, w, 3), np.uint8)
        masks = np.zeros((p, h, w), np.uint8)
        for t in range(p):
            f = bg * (1.0 + look["flicker"] * math.sin(0.37 * t))
            for i, o in enumerate(objs):
                cy = o["cy"] + o["ay"] * math.sin(2 * math.pi * t / o["period"][0]
                                                   + o["phase"][0])
                cx = o["cx"] + o["ax"] * math.sin(2 * math.pi * t / o["period"][1]
                                                   + o["phase"][1])
                y0, y1 = max(int(cy - o["ry"]), 0), min(int(cy + o["ry"]) + 2, h)
                x0, x1 = max(int(cx - o["rx"]), 0), min(int(cx + o["rx"]) + 2, w)
                yy = np.arange(y0, y1, dtype=np.float32)[:, None]
                xx = np.arange(x0, x1, dtype=np.float32)[None, :]
                inside = ((yy - cy) / o["ry"]) ** 2 + ((xx - cx) / o["rx"]) ** 2 <= 1.0
                u = (yy - cy) * math.cos(o["tilt"]) + (xx - cx) * math.sin(o["tilt"])
                tex = o["color"] * (0.75 + 0.25 * np.sin(o["stripe"] * u))[..., None]
                region = f[y0:y1, x0:x1]
                region[inside] = tex[inside]
                masks[t, y0:y1, x0:x1][inside] = i + 1
            frames[t] = np.clip(np.round(f * 255.0), 0, 255).astype(np.uint8)
        self.frames, self.masks = frames, masks

    def index(self, i: int) -> int:
        """The pool frame shown at stream frame i: forward, then back."""
        if self.pool_frames == 1:
            return 0
        period = 2 * (self.pool_frames - 1)
        j = i % period
        return j if j < self.pool_frames else period - j

    def _crop(self, i: int) -> slice:
        passes = i // max(self.pool_frames - 1, 1)
        off = passes % self.jitter if self.jitter else 0
        return slice(off, off + self.h)

    def frame(self, i: int) -> np.ndarray:
        """Stream frame i: HWC uint8 (a contiguous view into the pool)."""
        return self.frames[self.index(i), self._crop(i)]

    def mask(self, i: int) -> np.ndarray:
        """The index mask of stream frame i (objects 1..n)."""
        return self.masks[self.index(i), self._crop(i)]


class Stream:
    """How the stream is cut into videos. With clip_frames, the warm-up
    (its first `warmup` frames) is a video of its own and every later
    video has clip_frames frames, so the window opens on a new video; with
    clip_frames None the stream is one video. Frame i of the stream is
    frame `position(i)` of video `video(i)` (-1: the warm-up's);
    position 0 carries the first-frame mask."""

    def __init__(self, clip_frames: Optional[int], warmup: int = 0):
        self.clip_frames = clip_frames
        self.warmup = warmup if clip_frames is not None else 0

    def video(self, i: int) -> int:
        if self.clip_frames is None:
            return 0
        return -1 if i < self.warmup else (i - self.warmup) // self.clip_frames

    def position(self, i: int) -> int:
        if self.clip_frames is None or i < self.warmup:
            return i
        return (i - self.warmup) % self.clip_frames

    def start(self, video: int) -> int:
        if self.clip_frames is None or video < 0:
            return 0
        return self.warmup + video * self.clip_frames
