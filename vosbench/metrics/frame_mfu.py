"""frame_mfu: the whole frame's share of the card's peak over the traced
sub-window: the model operations of the traced frames (convolutions,
matmuls and attention from the frozen reference network at the cell's
shapes, at the objects each frame segments and memorizes; the reads, one a
bucket over its valid tokens and objects, and consolidation from the
schedule; vosbench/flops.py) over the sub-window's seconds times the peak
(fp32; bf16 under amp)."""
from vosbench import flops


def read(run):
    t = run.trace
    if t is None or run.peak is None or not run.stage_flops:
        return None
    m, sf = run.model, run.stage_flops
    encode = sf[max(sf)]["encode"]      # the same at every object count
    total = 0.0
    for f in run.traced_frames:
        total += encode
        if f["memorized"]:
            total += sf[f["memorized"]]["memorize"]
        if f["reads"]:
            total += sf[f["objects"]]["segment"] + run.batch * sum(
                flops.read_ops(run.queries, tokens, m["key_dim"], run.core["top_k"],
                               objects, m["value_dim"])
                for tokens, objects in f["reads"])
        if f["consolidate"]:
            lt = run.core["long_term"]
            cand = (lt["max_mem_frames"] - lt["min_mem_frames"]) * run.queries
            total += run.batch * flops.consolidation_ops(
                cand, lt["num_prototypes"], m["key_dim"], f["memorized"],
                m["value_dim"])
    peak = run.peak["bf16_flops" if run.core.get("amp") else "fp32_flops"]
    return 100.0 * total / (t.window_s * peak)
