"""One run of one cell: set-up, the measured window, the check, the result.

The window streams the cell's synthetic video through the port's
InferenceCore in a closed loop, one frame at a time: a frame is timed from
its events (vosbench/events: a deletion, a mask for the step) and handing
the host HxWx3 uint8 frame to InferenceCore.step until
InferenceCore.output_prob_to_mask has returned the host mask. Each video
gets a new InferenceCore on the same network, its first frame carrying the
index mask of its first objects, as cutie_tpu_torch.eval_vos does.

Set-up (setup_s): process start to the window's opening: imports, CUDA
and the model, the seed's weights made on the device, the frame pool, what
the cell's kinds of event set up, and the warm-up, which is the cell's own
traffic (warmup_frames frames, events included) and so uses every shape
the window uses.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import sys
import time
from types import SimpleNamespace
from typing import List, Optional

import torch

from vosbench import check, profiling, schedule, spec as specs
from vosbench.events import Frame, Script
from vosbench.flops import peaks, stage_flops
from vosbench.video import Stream, SyntheticVideo
from vosbench.weights import load_weights, make_weights

# top-level module names that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "cutie_tpu")
CACHE_DIR = specs.BENCH_DIR / ".cache"


def forbidden_modules() -> List[str]:
    """Loaded modules whose whole top-level name is forbidden."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def port_config(model_cfg: dict, core: dict):
    """The port's eval config of a cell: eval_config's defaults, the
    configuration file's model block and the traffic's core settings."""
    from cutie_tpu_torch.config import Config, eval_config

    cfg = eval_config()
    cfg.model = Config(model_cfg)
    cfg.merge({k: v for k, v in core.items()})
    return cfg


def _frame_plan(traffic: dict, stream: Stream, frames: int,
                script: Script) -> List[dict]:
    """The schedule entry of every stream frame up to `frames`."""
    h, w = schedule.internal_size(*traffic["frame"],
                                  traffic["core"].get("max_internal_size", -1))
    tokens = schedule.tokens_per_frame(h, w)
    length = max(stream.clip_frames or 0, stream.warmup, frames)
    one = schedule.video_schedule(traffic["core"], tokens, length, script)
    return [one[stream.position(i)] for i in range(frames)]


def run_cell(spec: dict, workload_name: str, seed: int, seconds: float,
             trace: bool, device: str, t0: float,
             traffic_overrides: Optional[dict] = None,
             program_hook=None, control: bool = False) -> dict:
    """One run; returns the result line's dict. traffic_overrides replaces
    top-level keys of the traffic file (tests); program_hook(core) may
    patch each new InferenceCore (tests that break the timed path); with
    control, the result also holds the control's readings ("control": the
    reference at TF32 in the program's place, vosbench/calibrate.py)."""
    from cutie_tpu_torch.inference import InferenceCore
    from cutie_tpu_torch.utils.get_default_model import build_model

    wl = specs.workload(spec, workload_name)
    cfg_file = specs.config(spec, wl["config"])
    traffic = dict(specs.traffic(wl["traffic"]), **(traffic_overrides or {}))
    limits = specs.limits(workload_name)
    core_settings = traffic["core"]
    cfg = port_config(cfg_file["model"], core_settings)
    dev = torch.device(device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    with torch.device(dev):
        net = build_model(cfg, device=device)
    load_weights(net, make_weights(net, seed, dev))
    warmup = int(traffic["warmup_frames"])
    video = SyntheticVideo(traffic, seed)
    stream = Stream(traffic["clip_frames"], warmup)
    script = Script(traffic)
    setups = script.setup(cfg_file, seed, dev)
    horizon = (warmup + int(traffic["check"]["min_fps"] * seconds)
               + (stream.clip_frames or 0))
    plan = check.SamplePlan(traffic, stream, seed, seconds,
                            _frame_plan(traffic, stream, horizon, script))
    samples: List[dict] = []
    # keep_events: what a sampled frame keeps after its events, outside
    # its time (paused_s)
    state = SimpleNamespace(core=None, kept_bytes=0, keep_events=None, paused_s=0.0)
    # spans only where a profiler reads them
    span = profiling.span if trace else (lambda name: contextlib.nullcontext())
    # the traced sub-window (--trace 1), which keeps no samples
    trace_from = warmup + int(traffic["trace"]["start_frame"])
    trace_to = trace_from + int(traffic["trace"]["frames"])

    def frame(i: int) -> torch.Tensor:
        position = stream.position(i)
        if position == 0:
            state.core = InferenceCore(net, cfg)
            if trace:
                profiling.wrap_steps(state.core)
            if program_hook is not None:
                program_hook(state.core)
        fr = Frame(video, i, position, setups)
        script.program(state.core, fr)
        if state.keep_events is not None:
            t = time.perf_counter()
            state.keep_events()
            state.paused_s += time.perf_counter() - t
        with span("step"):
            prob = fr.step(state.core)
        with span("to_host"):
            state.core.output_prob_to_mask(prob)
        return prob

    def checked(i: int, timed) -> None:
        """Frame i, and its sample for the check when the plan draws it:
        the program's state before and after it (and, for a frame with
        events, after them), and its output, kept outside the frame's
        time."""
        if not plan.wants(i) or (trace and trace_from <= i < trace_to):
            timed(i)
            return
        before = None if stream.position(i) == 0 else check.port_state(state.core)
        s = dict(i=i, kind=plan.kind(i), before=before, events=None)
        if before is not None and script.at(stream.position(i)):
            def keep():
                s["events"] = check.port_state(state.core)
            state.keep_events = keep
        prob = timed(i)
        state.keep_events = None
        s.update(prob=prob.detach().clone(), after=check.port_state(state.core))
        state.kept_bytes += (check.state_bytes(before) + check.state_bytes(s["after"])
                             + check.state_bytes(s["events"]) + s["prob"].numel() * 4)
        samples.append(s)

    for i in range(warmup):
        checked(i, frame)
    sync()
    peak_at_open = int(torch.cuda.max_memory_allocated(dev)) if cuda else 0
    kept_at_open = state.kept_bytes
    setup_s = time.time() - t0

    prof = None
    frame_ms: List[float] = []

    def timed(i: int) -> torch.Tensor:
        ta = time.perf_counter()
        state.paused_s = 0.0
        with span("frame"):
            prob = frame(i)
        frame_ms.append(1e3 * (time.perf_counter() - ta - state.paused_s))
        return prob

    i = warmup
    t_open = time.perf_counter()
    t_close = t_open + seconds
    t_end = t_open
    while t_end < t_close or (trace and i < trace_to):
        if trace and i == trace_from:
            sync()
            prof = profiling.profiler()
            prof.start()
        checked(i, timed)
        t_end = time.perf_counter()
        i += 1
        if prof is not None and i == trace_to:
            sync()
            prof.stop()
    sync()
    window_s = t_end - t_open
    # the program's peak: that of set-up, or of the window less the kept
    # samples (copies the program never holds)
    memory_peak = (max(peak_at_open - kept_at_open,
                       int(torch.cuda.max_memory_allocated(dev)) - state.kept_bytes)
                   if cuda else 0)
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"forbidden modules loaded: {', '.join(found)}")
    trace_obj = None
    if prof is not None:
        trace_obj = profiling.Trace(profiling.load_events(prof))
        del prof
    # the program's state goes before the reference runs
    state.core = None
    del net
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    ref = check.build_reference(cfg_file["model"], seed, dev)

    def reference_steps():
        return {s["i"]: check.step_reference(
                    ref, core_settings, script,
                    Frame(video, s["i"], stream.position(s["i"]), setups), s["before"])
                for s in samples}

    ref_out = reference_steps()
    readings = check.compare(samples, ref_out)
    readings.update(script.numbers(samples, ref_out))
    correct, shown = check.verdict(readings, limits)
    control_readings = None
    if control:
        with check.precision(ref, "tf32"):
            ctl_out = reference_steps()
        control_readings = check.compare(
            [dict(s, prob=ctl_out[s["i"]][0], after=ctl_out[s["i"]][1],
                  events=ctl_out[s["i"]][2]) for s in samples], ref_out)
    samples.clear()
    ref_out.clear()

    h, w = schedule.internal_size(*traffic["frame"],
                                  core_settings.get("max_internal_size", -1))
    hp, wp = -(-h // 16) * 16, -(-w // 16) * 16
    batch = 2 if core_settings.get("flip_aug") else 1
    kind = torch.cuda.get_device_name(dev) if cuda else "cpu"
    traced = _frame_plan(traffic, stream, trace_to, script)[trace_from:trace_to]
    run = SimpleNamespace(
        setup_s=setup_s, window_s=window_s, frame_ms=frame_ms, trace=trace_obj,
        traced_frames=traced, core=core_settings, model=cfg_file["model"],
        batch=batch, queries=(hp // 16) * (wp // 16),
        value_bytes=2 if core_settings.get("amp") else 4,
        peak=peaks(kind) if cuda else None, stage_flops=None)
    if trace:
        # the network's operations at each object count the traced frames use
        counts = {n for f in traced for n in (f["objects"], f["memorized"]) if n}
        run.stage_flops = {n: stage_flops(ref, batch, n, hp, wp, dev)
                           for n in sorted(counts)}
    del ref

    kind_key = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in specs.metrics_for(spec, workload_name, kind_key):
        v = specs.reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device_info = {"platform": "gpu" if cuda else "cpu", "kind": kind,
                   "count": int(wl["chips"]), "memory_peak_bytes": memory_peak}
    result = {"correct": bool(correct), "attempted": len(frame_ms), "failed": 0,
              "metrics": metrics, "device": device_info}
    if trace_obj is not None:
        device_info["busy_s"] = trace_obj.busy_s
        device_info["window_s"] = trace_obj.window_s
        result["breakdown"] = trace_obj.breakdown()
    if control:
        # calibration: the control's readings and verdict, and each kind's
        # and each sample's gaps
        result["control"] = control_readings
        result["control_correct"], _ = check.verdict(control_readings, limits)
        result["kinds"] = readings["kinds"]
        result["samples"] = readings["samples"]
    result["check"] = shown
    return result


def main(argv: List[str], t0: float) -> int:
    parser = argparse.ArgumentParser(
        description="Run one cell of BENCHMARK.json once on the card.")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    spec = specs.load_spec()
    wl = specs.workload(spec, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < wl["chips"]:
        print(f"vosbench: {args.workload} needs {wl['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    CACHE_DIR.mkdir(parents=True, exist_ok=True)
    os.environ["TRITON_CACHE_DIR"] = str(CACHE_DIR / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE_DIR / "torch_extensions")
    result = run_cell(spec, args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda", t0)
    found = forbidden_modules()
    if found:
        print(f"vosbench: forbidden modules loaded: {', '.join(found)}",
              file=sys.stderr)
        return 3
    for name, c in result["check"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
