"""steps.memorize_ms: device ms of the operations launched inside
StepFunctions.memorize (the mask encoder, the summarizer and the memory
writes), a memorize call, over the traced frames."""


def read(run):
    t = run.trace
    if t is None or not t.span_count.get("memorize"):
        return None
    return 1e3 * t.span_device_s.get("memorize", 0.0) / t.span_count["memorize"]
