"""inference_core.launches_per_frame: host calls that launch work on the
card (kernel and graph launches, as the profiler records the CUDA runtime
and driver calls) inside the traced frames, a frame."""


def read(run):
    t = run.trace
    if t is None or not t.span_count.get("frame"):
        return None
    return t.launches / t.span_count["frame"]
