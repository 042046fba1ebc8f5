"""The click's program spans in a traced run, for the ritm.* per-layer
metrics (vosbench/metrics/ritm.*.py).

The harness reduces the profiler's events to profiling.Trace, which keeps
the benchmark's own vosbench.* spans only; the click's work is in the
port's cutie.ritm.* spans (cutie_tpu_torch/utils/tracing.py). install(),
called by the click event's setup, wraps profiling.load_events (as
program_trace.keeping_events does) for one load, so that the traced run's
events are also reduced here, to ClickSpans, which last() returns until
the next install(). (A harness that handed the readers the traced run's
program spans would make this module unnecessary.) A program without the
spans reduces to a count of 0, and the metrics read nothing.
"""
from __future__ import annotations

from typing import List, Optional

from vosbench import profiling
from vosbench.program_trace import PREFIX, ProgramTrace

CLICK = "ritm.click"
EVALUATE = "ritm.brs.evaluate"
_LAST: List[Optional["ClickSpans"]] = [None]


class ClickSpans:
    """The cutie.ritm.click spans of one traced sub-window (seconds):

    count        click spans
    device_s     device seconds of the operations launched inside them
    launches     kernel and graph launch calls inside them
    waits        host calls inside them that wait for the card
    evaluations  cutie.ritm.brs.evaluate spans (all inside clicks)
    host_s       the click spans' host seconds
    busy_s       of those, the seconds in which some device operation ran
    """

    def __init__(self, events: List[dict]):
        pt = ProgramTrace(events)
        click = pt.spans.get(CLICK)
        self.count = click.count if click else 0
        self.device_s = click.device_s if click else 0.0
        self.launches = click.launches if click else 0
        self.waits = pt.waits_within([CLICK])
        evaluate = pt.spans.get(EVALUATE)
        self.evaluations = evaluate.count if evaluate else 0
        spans = profiling._union([
            (float(e["ts"]) * 1e-6, (float(e["ts"]) + float(e.get("dur", 0.0))) * 1e-6)
            for e in events if e.get("cat") == "user_annotation"
            and e.get("name") == PREFIX + CLICK])
        busy = profiling._union([
            (float(e["ts"]) * 1e-6, (float(e["ts"]) + float(e.get("dur", 0.0))) * 1e-6)
            for e in events if e.get("cat") in profiling.DEVICE_CATS])
        self.host_s = sum(e - s for s, e in spans)
        self.busy_s = _overlap(spans, busy)


def _overlap(a, b) -> float:
    """Seconds in both of two sorted lists of disjoint intervals."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        total += max(0.0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def install() -> None:
    """Reduce the next traced run's events to ClickSpans as well, and
    forget the last run's. The wrap undoes itself once it has run: the
    harness loads a traced run's events once, after its profiler stops."""
    _LAST[0] = None
    load = profiling.load_events
    if getattr(load, "keeps_click_spans", False):
        return

    def keep(prof):
        profiling.load_events = load
        events = load(prof)
        _LAST[0] = ClickSpans(events)
        return events
    keep.keeps_click_spans = True
    profiling.load_events = keep


def last() -> Optional[ClickSpans]:
    """The traced run's click spans since install(), or None."""
    return _LAST[0]
