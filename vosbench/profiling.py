"""The traced run: spans set from the benchmark's files, and the reduction
of the profiler's trace to what the per-layer metrics read.

Spans (torch.profiler.record_function, in the traced run only):
  vosbench.frame        one frame as the window times it
  vosbench.step         InferenceCore.step
  vosbench.to_host      InferenceCore.output_prob_to_mask
  vosbench.<name>       StepFunctions.<name> for each name in STEP_SPANS,
                        wrapped on the core's own `steps` object

A device operation belongs to a span when the host call that issued it
(matched by the profiler's correlation id) lies inside the span.
"""
from __future__ import annotations

import bisect
import functools
import json
import os
import tempfile
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

PREFIX = "vosbench."
STEP_SPANS = ("encode", "read_memory", "segment", "memorize", "consolidate")
# most specific first: an idle gap is labelled by the first span of this
# list that holds the launch of the operation that ends it
LABEL_ORDER = ("read_memory", "encode", "memorize", "consolidate", "segment",
               "step", "to_host", "frame")
LAUNCH_CALLS = frozenset((
    "cudaLaunchKernel", "cudaLaunchKernelExC", "cudaLaunchCooperativeKernel",
    "cuLaunchKernel", "cuLaunchKernelEx", "cudaGraphLaunch", "cuGraphLaunch"))
DEVICE_CATS = frozenset(("kernel", "gpu_memcpy", "gpu_memset"))
TOP = 10


def span(name: str):
    """A benchmark span (a record_function context)."""
    return torch.profiler.record_function(PREFIX + name)


def wrap_steps(core) -> None:
    """Put a span around each StepFunctions method in STEP_SPANS of one
    InferenceCore; the methods call each other through the instance, so
    nested calls are spanned too."""
    steps = core.steps
    for name in STEP_SPANS:
        fn = getattr(steps, name)

        @functools.wraps(fn)
        def spanned(*args, _fn=fn, _name=name, **kwargs):
            with span(_name):
                return _fn(*args, **kwargs)
        setattr(steps, name, spanned)


def profiler() -> torch.profiler.profile:
    return torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])


def load_events(prof: torch.profiler.profile) -> List[dict]:
    """The complete ('X') events of a finished profile, through its chrome
    trace in a temporary file that is removed at once."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            doc = json.load(f)
    finally:
        os.remove(path)
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    return [e for e in events if e.get("ph") == "X"]


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


class _Spans:
    """Intervals of one span name, for point queries."""

    def __init__(self, intervals: List[Tuple[float, float]]):
        self.iv = sorted(intervals)
        self.starts = [s for s, _ in self.iv]

    def holds(self, t: float) -> bool:
        i = bisect.bisect_right(self.starts, t) - 1
        # spans of one name do not overlap, except a span nested in its
        # own name (none here): the latest start before t decides
        return i >= 0 and self.iv[i][1] >= t

    def __len__(self):
        return len(self.iv)


class Trace:
    """The reduction of one traced sub-window (times in seconds).

    window_s        the sub-window: first frame span's start to the last's end
    busy_s          seconds in which some device operation ran (their union)
    launches        host launch calls inside frame spans
    span_count      {span: occurrences}
    span_device_s   {span: device seconds of operations launched inside it}
    op_seconds      {device operation name: seconds}, all operations
    idle_by_label   {label: idle seconds}, each gap labelled by the span
                    that launched the operation ending it
    """

    def __init__(self, events: List[dict]):
        spans: Dict[str, List[Tuple[float, float]]] = defaultdict(list)
        issue_ts: Dict[int, float] = {}
        ops = []
        launch_times = []
        for e in events:
            cat, name = e.get("cat", ""), e.get("name", "")
            ts, dur = float(e["ts"]) * 1e-6, float(e.get("dur", 0.0)) * 1e-6
            if cat == "user_annotation" and name.startswith(PREFIX):
                spans[name[len(PREFIX):]].append((ts, ts + dur))
            elif cat in ("cuda_runtime", "cuda_driver"):
                if name in LAUNCH_CALLS:
                    launch_times.append(ts)
                corr = e.get("args", {}).get("correlation")
                if corr is not None:
                    issue_ts[corr] = ts
            elif cat in DEVICE_CATS:
                ops.append((ts, ts + dur, name, e.get("args", {}).get("correlation")))
        frames = _Spans(spans.get("frame", []))
        if not len(frames):
            raise ValueError("the trace holds no frame span")
        w0, w1 = frames.iv[0][0], max(e for _, e in frames.iv)
        self.window_s = w1 - w0
        self.span_count = {k: len(v) for k, v in spans.items()}
        self.launches = sum(1 for t in launch_times if frames.holds(t))
        by_name = {k: _Spans(v) for k, v in spans.items()}

        inside = [(max(s, w0), min(e, w1), name, corr) for s, e, name, corr in ops
                  if e > w0 and s < w1]
        busy = _union([(s, e) for s, e, _, _ in inside])
        self.busy_s = sum(e - s for s, e in busy)
        self.op_seconds: Dict[str, float] = defaultdict(float)
        self.span_device_s: Dict[str, float] = defaultdict(float)
        for s, e, name, corr in inside:
            self.op_seconds[name] += e - s
            t = issue_ts.get(corr)
            if t is None:
                continue
            for k, sp in by_name.items():
                if sp.holds(t):
                    self.span_device_s[k] += e - s

        def label(t: Optional[float]) -> str:
            if t is not None:
                for k in LABEL_ORDER:
                    if k in by_name and by_name[k].holds(t):
                        return k
            return "outside_frames"

        by_start = sorted(inside, key=lambda op: op[0])
        starts = [op[0] for op in by_start]
        self.idle_by_label: Dict[str, float] = defaultdict(float)
        prev_end = w0
        for s, e in busy:
            if s > prev_end:
                i = bisect.bisect_left(starts, s)
                t = issue_ts.get(by_start[i][3]) if i < len(starts) else None
                self.idle_by_label[label(t)] += s - prev_end
            prev_end = max(prev_end, e)
        if w1 > prev_end:
            self.idle_by_label["outside_frames"] += w1 - prev_end

    def breakdown(self) -> dict:
        """The result line's breakdown: the device operations that took
        most time, and idle time by what the host was inside."""
        def top(d):
            return [[k[:200], v] for k, v in
                    sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
        return {"device_ops": top(self.op_seconds),
                "idle_gaps": top(self.idle_by_label)}
