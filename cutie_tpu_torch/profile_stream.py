"""Where a streaming frame's time goes on the card.

    python3 -m cutie_tpu_torch.profile_stream [--long-term]

Streams cutie-base (trained test weights, d17 settings: mem_every 5,
top_k 30, 5 working-memory frames; with --long-term, long-term mode at the
settings tests/golden/stream480_lt_trained.npz was recorded with) over
WARMUP frames of the synthetic 480x854 three-object video, then traces
FRAMES - WARMUP further frames (two of them memory frames; in long-term
mode one of them consolidates) with torch.profiler and prints one JSON line:
wall ms per frame (synchronised), kernel time per frame, the device's busy
share (kernel time over wall time), and kernel time by kernel, largest
first.
Where the profiler records no device time, the device numbers are null.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import torch
from torch.autograd import DeviceType

from cutie_tpu_torch.config import eval_config
from cutie_tpu_torch.inference import InferenceCore
from cutie_tpu_torch.utils.get_default_model import build_model
from cutie_tpu_torch.utils.synth_video import synth_frames_480

FRAMES, WARMUP, TOP = 22, 12, 30
WEIGHTS = (Path(__file__).resolve().parent.parent / "tests" / "golden"
           / "state_dict_base_trained.npz")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_stream: needs a CUDA device")

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--long-term", action="store_true")
    long_term = parser.parse_args().long_term

    cfg = eval_config("base")
    cfg.merge({"mem_every": 5, "top_k": 30, "stagger_updates": 5,
               "max_mem_frames": 5, "use_long_term": long_term,
               "long_term": {"count_usage": True, "max_mem_frames": 4,
                             "min_mem_frames": 2, "num_prototypes": 64,
                             "max_num_tokens": 4000, "buffer_tokens": 1000}})
    core = InferenceCore(build_model(cfg, str(WEIGHTS)), cfg)
    frames, mask0 = synth_frames_480(FRAMES)
    frames = torch.from_numpy(frames).cuda()

    def step(ti):
        return (core.step(frames[ti], mask0, objects=[1, 2, 3]) if ti == 0
                else core.step(frames[ti]))

    for ti in range(WARMUP):
        step(ti)
    torch.cuda.synchronize()

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    wall = []
    with torch.profiler.profile(activities=acts) as prof:
        for ti in range(WARMUP, FRAMES):
            t0 = time.perf_counter()
            step(ti)
            torch.cuda.synchronize()
            wall.append(1e3 * (time.perf_counter() - t0))
    n = len(wall)
    rows = []
    for ev in prof.key_averages():
        # kernels only: the operator rows repeat their kernels' device time
        if getattr(ev, "device_type", None) != DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        if dev_us > 0:
            rows.append((dev_us, ev.key, ev.count))
    rows.sort(reverse=True)
    dev_ms = sum(r[0] for r in rows) / 1e3 / n if rows else None
    wall_ms = sum(wall) / n
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "long_term": long_term,
        "consolidations": core.consolidations,
        "frames_traced": n,
        "wall_ms_per_frame": wall,
        "mean_wall_ms": wall_ms,
        "device_ms_per_frame": dev_ms,
        "device_busy_share": dev_ms / wall_ms if dev_ms else None,
        "top_kernels": [{"name": k[:90], "ms_per_frame": us / 1e3 / n,
                         "calls_per_frame": c / n}
                        for us, k, c in rows[:TOP]],
    }), flush=True)


if __name__ == "__main__":
    main()
