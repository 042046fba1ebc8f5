"""frame_mfu: the whole frame's share of the card's peak over the traced
sub-window: the model operations of the traced frames (convolutions,
matmuls and attention from the frozen reference network at the cell's
shapes, the read and consolidation from the schedule; vosbench/flops.py)
over the sub-window's seconds times the peak (fp32; bf16 under amp)."""
from vosbench import flops


def read(run):
    t = run.trace
    if t is None or run.peak is None or run.stage_flops is None:
        return None
    m, sf = run.model, run.stage_flops
    total = 0.0
    for f in run.traced_frames:
        total += sf["encode"]
        if f["kind"] in ("first", "memory"):
            total += sf["memorize"]
        if f["read_tokens"]:
            total += sf["segment"] + run.batch * flops.read_ops(
                run.queries, f["read_tokens"], m["key_dim"], run.core["top_k"],
                run.objects, m["value_dim"])
        if f["consolidate"]:
            lt = run.core["long_term"]
            cand = (lt["max_mem_frames"] - lt["min_mem_frames"]) * run.queries
            total += run.batch * flops.consolidation_ops(
                cand, lt["num_prototypes"], m["key_dim"], run.objects,
                m["value_dim"])
    peak = run.peak["bf16_flops" if run.core.get("amp") else "fp32_flops"]
    return 100.0 * total / (t.window_s * peak)
