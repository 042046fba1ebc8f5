"""ritm.click_ms: device ms of the operations launched inside the port's
cutie.ritm.click spans (one ClickController.interact: the zoom-in, HRNet
and its OCR head, the f-BRS drive's evaluations and the D2H copy of the
click's probabilities), a click, over the traced frames
(vosbench/ritm_trace.py)."""
from vosbench import ritm_trace


def read(run):
    t = ritm_trace.last()
    if run.trace is None or t is None or not t.count:
        return None
    return 1e3 * t.device_s / t.count
