"""radix_topk_readout_roofline: the memory read kernel's share of its
roofline over the traced frames: the sum, over every read the schedule
says those frames make (one a bucket, over that bucket's valid tokens and
for its objects), of the least time the card could take (the larger of its
operations at the fp32 peak and its bytes at the memory bandwidth,
vosbench/flops.py), over the device time of the kernel's two stages, found
by name in the trace (csrc/radix_topk_readout.cu)."""
from vosbench import flops

KERNELS = ("similarity_kernel", "select_readout_kernel")


def read(run):
    t = run.trace
    if t is None or run.peak is None:
        return None
    kernel_s = sum(s for name, s in t.op_seconds.items()
                   if any(k in name for k in KERNELS))
    if kernel_s <= 0:
        return None
    m = run.model
    bound = 0.0
    for f in run.traced_frames:
        for tokens, objects in f["reads"]:
            ops = flops.read_ops(run.queries, tokens, m["key_dim"],
                                 run.core["top_k"], objects, m["value_dim"])
            nbytes = flops.read_bytes(run.queries, tokens, m["key_dim"],
                                      objects, m["value_dim"], run.value_bytes)
            bound += run.batch * flops.read_bound_s(ops, nbytes, run.peak)
    return 100.0 * bound / kernel_s
