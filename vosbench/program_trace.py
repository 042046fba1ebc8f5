"""The traced run by the program's own spans: the port's "cutie.*"
record_function ranges (cutie_tpu_torch/utils/tracing.py), which nest
(one host thread), reduced from the same profiler events as
profiling.Trace.

    python3 vosbench/program_trace.py --workload <name> --seed <n> --seconds <s>

runs the cell as vosbench/run.py does with --trace 1, prints the same
result line last on standard output, and then prints the traced
sub-window by program span, a frame, to standard error (ProgramTrace.table).

A host call or device operation is put down to the innermost program span
that holds it: a host call by its own start, a device operation by the
start of the host call that launched it (matched by the profiler's
correlation id). Each span name then gets, over the traced sub-window
(profiling.Trace's: the first frame span's start to the last's end):

  count        occurrences
  device_s     device seconds of the operations launched inside the span,
               at any depth; self_device_s: where it is the innermost
  launches     kernel and graph launch calls (profiling.LAUNCH_CALLS),
               at any depth
  waits        host calls that wait for the card (WAIT_CALLS), at any
               depth
  idle_s       the card's idle gaps (the gaps of the union of device
               intervals, as profiling.Trace takes them) whose ending
               operation was launched inside the span, at any depth;
               self_idle_s: innermost. Gaps that no program span ended
               (and the tail after the last operation) are outside_idle_s,
               so the self idle of every name plus outside_idle_s is the
               sub-window's idle, window_s - busy_s.

A trace with no program span (a program without them) reduces to empty
spans, and every gap is outside.
"""
from __future__ import annotations

import bisect
import contextlib
import sys
import time
from collections import defaultdict
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, FrozenSet, Iterable, List, Tuple

if __name__ == "__main__":
    T0 = time.time()
    # the checkout's root, in place of this directory, as vosbench/run.py
    sys.path[0] = str(Path(__file__).resolve().parent.parent)

from vosbench import profiling  # noqa: E402

PREFIX = "cutie."
# host calls that block until the card (or a stream of it) has caught up:
# the synchronize calls and the synchronous copies, as the CUDA runtime and
# driver name them; PyTorch's .cpu() and its pageable uploads are an async
# copy followed by cudaStreamSynchronize
WAIT_CALLS = frozenset((
    "cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
    "cuStreamSynchronize", "cuCtxSynchronize", "cuEventSynchronize",
    "cudaMemcpy", "cudaMemcpy2D",
    "cuMemcpy", "cuMemcpyDtoH", "cuMemcpyHtoD", "cuMemcpyDtoH_v2",
    "cuMemcpyHtoD_v2"))


@dataclass
class SpanStats:
    count: int = 0
    device_s: float = 0.0
    self_device_s: float = 0.0
    launches: int = 0
    waits: int = 0
    idle_s: float = 0.0
    self_idle_s: float = 0.0


class _Innermost:
    """The innermost program span at a time: the spans' change points in
    time order, each with the index of the span that holds from it on
    (-1: none), and each span's name and the names of it and its
    enclosing spans."""

    def __init__(self, spans: List[Tuple[float, float, str]]):
        self.names: List[str] = []
        self.chains: List[FrozenSet[str]] = []
        self.times: List[float] = []
        self.ids: List[int] = []
        stack: List[Tuple[int, float]] = []   # (span index, its end)

        def close_until(t: float) -> None:
            while stack and stack[-1][1] <= t:
                end = stack.pop()[1]
                self._mark(end, stack[-1][0] if stack else -1)

        for start, end, name in sorted(spans, key=lambda s: (s[0], -s[1])):
            close_until(start)
            if stack:
                # a child ends with its parent at the latest (the clock's
                # rounding aside)
                end = min(end, stack[-1][1])
            k = len(self.names)
            self.names.append(name)
            parent = self.chains[stack[-1][0]] if stack else frozenset()
            self.chains.append(parent | {name})
            stack.append((k, end))
            self._mark(start, k)
        close_until(float("inf"))

    def _mark(self, t: float, k: int) -> None:
        if self.times and self.times[-1] == t:
            self.ids[-1] = k
        else:
            self.times.append(t)
            self.ids.append(k)

    def at(self, t) -> int:
        """The index of the innermost span holding t, or -1."""
        if t is None:
            return -1
        i = bisect.bisect_right(self.times, t) - 1
        return self.ids[i] if i >= 0 else -1


class ProgramTrace:
    """The reduction of one traced sub-window by program span (seconds).

    spans           {name without "cutie.": SpanStats}
    window_s        the sub-window, as profiling.Trace's
    busy_s          seconds in which some device operation ran
    outside_idle_s  idle not ended by an operation launched in a program span
    frame_device_s  device seconds of operations launched inside the
                    benchmark's frame spans
    covered_s       of those, the seconds launched inside some program span
    frames          the benchmark's frame spans
    frame_s         their host seconds in all
    """

    def __init__(self, events: List[dict]):
        prog: List[Tuple[float, float, str]] = []
        frames: List[Tuple[float, float]] = []
        issue_ts: Dict[int, float] = {}
        launch_ts: List[float] = []
        wait_ts: List[float] = []
        ops = []
        for e in events:
            cat, name = e.get("cat", ""), e.get("name", "")
            ts, dur = float(e["ts"]) * 1e-6, float(e.get("dur", 0.0)) * 1e-6
            if cat == "user_annotation":
                if name.startswith(PREFIX):
                    prog.append((ts, ts + dur, name[len(PREFIX):]))
                elif name == profiling.PREFIX + "frame":
                    frames.append((ts, ts + dur))
            elif cat in ("cuda_runtime", "cuda_driver"):
                if name in profiling.LAUNCH_CALLS:
                    launch_ts.append(ts)
                elif name in WAIT_CALLS:
                    wait_ts.append(ts)
                corr = e.get("args", {}).get("correlation")
                if corr is not None:
                    issue_ts[corr] = ts
            elif cat in profiling.DEVICE_CATS:
                ops.append((ts, ts + dur, e.get("args", {}).get("correlation")))
        if not frames:
            raise ValueError("the trace holds no frame span")
        w0, w1 = min(s for s, _ in frames), max(e for _, e in frames)
        self.window_s = w1 - w0
        self.frames = len(frames)
        self.frame_s = sum(e - s for s, e in frames)
        in_frame = profiling._Spans(frames)
        inner = self._inner = _Innermost(prog)
        self.spans: Dict[str, SpanStats] = defaultdict(SpanStats)
        for name in inner.names:
            self.spans[name].count += 1

        def credit(t, field: str, amount, innermost: bool = False) -> int:
            k = inner.at(t)
            if k >= 0:
                if innermost:
                    stats = self.spans[inner.names[k]]
                    setattr(stats, "self_" + field,
                            getattr(stats, "self_" + field) + amount)
                for name in inner.chains[k]:
                    stats = self.spans[name]
                    setattr(stats, field, getattr(stats, field) + amount)
            return k

        for t in launch_ts:
            credit(t, "launches", 1)
        self._wait_spans = [inner.at(t) for t in wait_ts]
        for t in wait_ts:
            credit(t, "waits", 1)

        inside = [(max(s, w0), min(e, w1), corr) for s, e, corr in ops
                  if e > w0 and s < w1]
        self.frame_device_s = self.covered_s = 0.0
        for s, e, corr in inside:
            t = issue_ts.get(corr)
            k = credit(t, "device_s", e - s, innermost=True)
            if t is not None and in_frame.holds(t):
                self.frame_device_s += e - s
                if k >= 0:
                    self.covered_s += e - s

        busy = profiling._union([(s, e) for s, e, _ in inside])
        self.busy_s = sum(e - s for s, e in busy)
        by_start = sorted(inside, key=lambda op: op[0])
        starts = [op[0] for op in by_start]
        self.outside_idle_s = 0.0
        prev_end = w0
        for s, e in busy:
            if s > prev_end:
                i = bisect.bisect_left(starts, s)
                t = issue_ts.get(by_start[i][2]) if i < len(starts) else None
                if credit(t, "idle_s", s - prev_end, innermost=True) < 0:
                    self.outside_idle_s += s - prev_end
            prev_end = max(prev_end, e)
        if w1 > prev_end:
            self.outside_idle_s += w1 - prev_end
        self.spans = dict(self.spans)

    def waits_within(self, names: Iterable[str]) -> int:
        """Wait calls inside any span of these names (each call once)."""
        names = set(names)
        return sum(1 for k in self._wait_spans
                   if k >= 0 and self._inner.chains[k] & names)

    def figures(self) -> Dict[str, float]:
        """Three figures of the frame's layers (empty for a trace without
        the program's spans):
          steps.segment_ms        device ms launched inside
                                  cutie.steps.segment, a call
          steps.segment_idle_ms   idle ms ended by an operation launched
                                  inside it, at any depth, a step span
          inference_core.syncs_per_frame
                                  wait calls inside cutie.inference_core.step
                                  or cutie.inference_core.to_host, a step span
        """
        seg = self.spans.get("steps.segment")
        step = self.spans.get("inference_core.step")
        if seg is None or step is None:
            return {}
        return {
            "steps.segment_ms": 1e3 * seg.device_s / seg.count,
            "steps.segment_idle_ms": 1e3 * seg.idle_s / step.count,
            "inference_core.syncs_per_frame": self.waits_within(
                ("inference_core.step", "inference_core.to_host")) / step.count}

    def table(self) -> List[str]:
        """One line a span name, a frame (the benchmark's frame spans):
        calls, device ms (at any depth, and innermost), launches and waits
        at any depth, innermost idle ms; then the idle outside every
        program span, the idle credited in all as a share of the sub-window,
        and the coverage of the frames' device time, the frames' host ms
        and the figures."""
        n = max(self.frames, 1)
        lines = [f"{'span':40s} {'calls':>6s} {'dev_ms':>9s} {'self_ms':>9s} "
                 f"{'launches':>9s} {'waits':>6s} {'idle_ms':>8s}"]
        for name in sorted(self.spans):
            s = self.spans[name]
            lines.append(
                f"cutie.{name:34s} {s.count / n:6.2f} {1e3 * s.device_s / n:9.3f} "
                f"{1e3 * s.self_device_s / n:9.3f} {s.launches / n:9.1f} "
                f"{s.waits / n:6.2f} {1e3 * s.self_idle_s / n:8.3f}")
        lines.append(f"{'outside':40s} {'':6s} {'':9s} {'':9s} {'':9s} {'':6s} "
                     f"{1e3 * self.outside_idle_s / n:8.3f}")
        idle = sum(v.self_idle_s for v in self.spans.values()) + self.outside_idle_s
        lines.append(f"idle credited to program spans and outside: "
                     f"{100 * idle / self.window_s:.3f}% of the window")
        if self.frame_device_s > 0:
            lines.append(f"device time launched in frames inside program spans: "
                         f"{100 * self.covered_s / self.frame_device_s:.2f}%")
        lines.append(f"frames: {self.frames}, {1e3 * self.frame_s / n:.3f} ms a frame "
                     "(host, frame spans)")
        lines += [f"{k}: {v:.4f}" for k, v in self.figures().items()]
        return lines


@contextlib.contextmanager
def keeping_events():
    """Within it, profiling.load_events also keeps what it loads in the
    list it yields: the traced run calls it once, after its profiler
    stops."""
    kept: List[dict] = []
    load = profiling.load_events

    def keep(prof):
        events = load(prof)
        kept.extend(events)
        return events
    profiling.load_events = keep
    try:
        yield kept
    finally:
        profiling.load_events = load


def main(argv: List[str], t0: float) -> int:
    from vosbench import harness
    with keeping_events() as events:
        rc = harness.main(list(argv) + ["--trace", "1"], t0)
    if events:
        print("by program span, a frame:", file=sys.stderr)
        for line in ProgramTrace(events).table():
            print(line, file=sys.stderr)
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T0))
