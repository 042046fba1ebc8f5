"""ritm.launches_per_click: kernel and graph launch calls inside the
cutie.ritm.click spans, a click (vosbench/ritm_trace.py)."""
from vosbench import ritm_trace


def read(run):
    t = ritm_trace.last()
    if run.trace is None or t is None or not t.count:
        return None
    return t.launches / t.count
