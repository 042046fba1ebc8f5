"""models.encode_ms: device ms of the operations launched inside
StepFunctions.encode (the pixel encoder's trunk, pix_feat_proj and the key
projection), a frame, over the traced frames."""


def read(run):
    t = run.trace
    if t is None or not t.span_count.get("encode"):
        return None
    return 1e3 * t.span_device_s.get("encode", 0.0) / t.span_count["encode"]
