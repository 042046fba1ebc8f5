"""ritm.click_idle_pct: the share of the cutie.ritm.click spans' host time
in which no operation ran on the card: the drive's host reads, the
launches and the host's own work inside a click (vosbench/ritm_trace.py)."""
from vosbench import ritm_trace


def read(run):
    t = ritm_trace.last()
    if run.trace is None or t is None or not t.count or t.host_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.host_s)
