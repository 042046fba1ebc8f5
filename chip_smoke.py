"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line with its wall seconds:
  env        the card, the CUDA version and nvidia-smi's name and power limit;
  build      nvcc builds both read kernels into cutie_tpu_torch/_build/, one
             process per source, started together; ptxas's report, and the
             resident blocks per SM of each path;
  stream     the working-memory path: InferenceCore.step of cutie-base on the
             trained test weights, 12 frames of the synthetic 480x854
             three-object video, held to the recorded reference masks; the
             read kernel must have been launched there, and it is held to its
             plain version again on the stream's own read inputs;
  lt_stream  the long-term path: the same in long-term mode over the 26
             frames of the long-term golden, with consolidation and reads
             over three value segments (perm | lt | work);
  kernel     the read kernel against its plain version on the card: random
             cases at the working-memory shapes and edge cases, and the
             long-term sizes of the lvos-val presets built from the
             long-term stream's own keys and values (N = 27,948 at 480p, and
             past the 28,666 keys one block's shared memory holds: N = 29,568
             at 480p with a late object, N = 38,134 at 600p); which path each
             case took, times; both paths on the N = 27,948 case, bit for bit;
  fused      the streaming kernel (fused_topk_readout) against the plain
             version and against the read kernel: tau bit for bit;
  kernels    one line listing every ported kernel.
The last line is {"ok": true, "device": {...}}. Any failure raises and the
script exits non-zero. It needs a CUDA device and the repository around it.
"""
import json
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from cutie_tpu_torch.config import eval_config
from cutie_tpu_torch.inference import InferenceCore
from cutie_tpu_torch.ops import cuda_build, read_kernel
from cutie_tpu_torch.ops.memory import _float_order_key, get_similarity, topk_threshold
from cutie_tpu_torch.utils.get_default_model import build_model, set_fp32_precision
from cutie_tpu_torch.utils.synth_video import synth_frames_480

REPO = Path(__file__).resolve().parent
GOLDEN = REPO / "tests" / "golden"

# H100 SXM data sheet: HBM3 bandwidth and fp32 (non-tensor-core) peak.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

# Kernel vs plain version. Both evaluate the similarity by the same fp32
# operations in the same order (ops/memory.py:get_similarity), so tau must
# agree bit for bit on every query and both keep the same tokens. The
# weights exp(sim) and their sums are fp32 in another order (and usage is
# summed with atomics in a varying order): readout and usage agree to ~1e-6
# of their scale; READ_RTOL leaves a hundredfold margin.
READ_RTOL = 1e-4
IOU_MEDIAN, IOU_MIN = 0.97, 0.90   # tests/test_parity_480p.py:47-48
ARGS = ("mk", "ms", "valid", "qk", "qe", "values")

T_START = time.perf_counter()


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi_line():
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return res.stdout.strip().splitlines()[0] if res.returncode == 0 else \
        f"nvidia-smi failed: {res.stderr.strip()}"


def cuda_time_ms(fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ------------------------------------------------------------------ inputs

def read_case(rng, *, p, caps, o, ck=64, cv=256, n_valid=None, pad_queries=0,
              dtype=torch.float32, dup_tie=False, k=30):
    """Random read inputs in the port's unpadded segment layout, on the
    card. Keys ~ N(0,1), shrinkage >= 1 (d^2 + 1), selection in (0,1) as
    the model produces them."""
    n = sum(caps)
    mk = rng.normal(size=(n, ck)).astype(np.float32)
    ms = (1 + rng.normal(size=(n,)) ** 2).astype(np.float32)
    valid = np.ones((n,), bool)
    if n_valid is not None:
        valid[n_valid:] = False
    qk = rng.normal(size=(p, ck)).astype(np.float32)
    qe = rng.uniform(size=(p, ck)).astype(np.float32)
    segs = [rng.normal(size=(o, c, cv)).astype(np.float32) for c in caps]
    dev = "cuda"
    t = lambda x: torch.from_numpy(x).to(dev)
    case = dict(mk=t(mk), ms=t(ms), valid=t(valid), qk=t(qk), qe=t(qe),
                values=tuple(t(s).to(dtype) for s in segs))
    if dup_tie:
        # copy query 0's k-th token over a token outside its top-k: the two
        # copies tie exactly at tau and both must be kept
        sim = plain_similarity(case)[0]
        order = torch.argsort(sim, descending=True)
        src, dst = int(order[k - 1]), int(order[-1])
        case["mk"][dst] = case["mk"][src]
        case["ms"][dst] = case["ms"][src]
        case["valid"][dst] = case["valid"][src]
        case["tie_tokens"] = (src, dst)
    if pad_queries:
        case["qk"] = torch.cat([case["qk"], torch.full((pad_queries, ck), 1e6, device=dev)])
        case["qe"] = torch.cat([case["qe"], torch.ones((pad_queries, ck), device=dev)])
        case["n_pad_queries"] = pad_queries
    return case


def preset_case(src, rng, *, frame_tokens, perm_frames, perm_valid_frames,
                lt_valid, work_frames, work_live, queries):
    """Read inputs at a long-term preset's sizes, built from a stream's own
    read inputs `src` (the long-term stream's last read): its perm, live
    long-term and live working-memory tokens are the pool the three
    segments are tiled from (keys, shrinkage and values together; copies
    after the first get keys perturbed by 0.02 N(0, 1), so that the tiling
    adds no exact ties), and its queries, tiled the same way, are the
    queries. Segments: perm_frames frames (the first perm_valid_frames
    valid), a long-term store of 10,128 slots (max_num_tokens 10,000 plus
    128 prototypes) with lt_valid of them live, and a ring of work_frames
    frame slots with work_live live frames."""
    valid = src["valid"]
    pool = torch.nonzero(valid).flatten()
    vals = torch.cat(src["values"], dim=1)
    dev = valid.device

    def tile(count, offset):
        idx = pool[(offset + torch.arange(count, device=dev)) % pool.numel()]
        copy = (offset + torch.arange(count, device=dev)) // pool.numel()
        key = src["mk"][idx] + 0.02 * (copy > 0)[:, None] * torch.from_numpy(
            rng.normal(size=(count, src["mk"].shape[1])).astype(np.float32)).to(dev)
        return key, src["ms"][idx], vals[:, idx]

    lcap = 10_128
    caps = (perm_frames * frame_tokens, lcap, work_frames * frame_tokens)
    seg_valid = (torch.arange(caps[0], device=dev) < perm_valid_frames * frame_tokens,
                 torch.arange(lcap, device=dev) < lt_valid,
                 torch.arange(caps[2], device=dev) < work_live * frame_tokens)
    keys, shr, values, off = [], [], [], 0
    for cap in caps:
        k, s, v = tile(cap, off)
        keys.append(k)
        shr.append(s)
        values.append(v.contiguous())
        off += cap
    qi = torch.arange(queries, device=dev) % src["qk"].shape[0]
    copy = (torch.arange(queries, device=dev) // src["qk"].shape[0] > 0)[:, None]
    qk = src["qk"][qi] + 0.02 * copy * torch.from_numpy(
        rng.normal(size=(queries, src["qk"].shape[1])).astype(np.float32)).to(dev)
    return dict(mk=torch.cat(keys).contiguous(), ms=torch.cat(shr),
                valid=torch.cat(seg_valid), qk=qk.contiguous(),
                qe=src["qe"][qi].contiguous(), values=tuple(values))


def plain_similarity(case):
    return get_similarity(case["mk"][None], case["ms"][None], case["qk"][None],
                          case["qe"][None], valid=case["valid"][None])[0]


def ulps(a, b):
    """Elementwise distance in fp32 ulps (order keys count the floats)."""
    return (_float_order_key(a) - _float_order_key(b)).abs()


def rel_err(a, b):
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def compare(case, k, kernel=read_kernel.radix_topk_readout_cuda):
    """A kernel against the plain version on every query of the case.
    Returns (ok, results, (readout, usage, tau))."""
    args = {key: case[key] for key in ARGS}
    if kernel is read_kernel.fused_topk_readout_cuda:
        args["values"] = torch.cat([v.float() for v in args["values"]], dim=1)
    rd, us, tau = kernel(**args, top_k=k)
    rd_p, us_p = read_kernel.radix_topk_readout_plain(**args, top_k=k)
    tau_p = topk_threshold(plain_similarity(case), k)[:, 0]
    torch.cuda.synchronize()
    tau_ulps = int(ulps(tau, tau_p).max())
    res = dict(tokens=int(case["mk"].shape[0]), queries=int(tau.shape[0]),
               readout_max_abs=float((rd - rd_p).abs().max()),
               readout_rel=rel_err(rd, rd_p), usage_rel=rel_err(us, us_p),
               tau_max_ulps=tau_ulps)
    ok = (res["readout_rel"] <= READ_RTOL and res["usage_rel"] <= READ_RTOL
          and tau_ulps == 0
          and bool(torch.isfinite(rd).all()) and bool(torch.isfinite(us).all()))
    if "n_pad_queries" in case:
        npad = case["n_pad_queries"]
        pad_out = float(rd[:, -npad:].abs().max())
        res["padded_query_readout_max"] = pad_out
        ok = ok and pad_out == 0.0
    if "tie_tokens" in case:
        src, dst = case["tie_tokens"]
        res["tie_usage"] = [float(us[src]), float(us[dst])]
        ok = ok and float(us[src]) > 0 and float(us[dst]) > 0
    return ok, res, (rd, us, tau)


def read_bound_ms(args, usage, k):
    """Least time for one read on these inputs: each input byte read once
    (value rows only where some query kept the token), each output written
    once, against the operations of the similarity over the valid tokens
    (4 fp32 operations per query, token and key channel: a difference, two
    products and a sum; invalid tokens need none) and of the readout, at the
    fp32 peak."""
    mk, ms, valid, qk, qe, values = args
    values = read_kernel._as_segments(values)
    n, ck = mk.shape
    n_valid = int(valid.sum())
    p = qk.shape[0]
    o, _, cv = values[0].shape
    esize = values[0].element_size()
    touched = int((usage > 0).sum())
    nbytes = (mk.numel() * 4 + ms.numel() * 4 + valid.numel() + 2 * p * ck * 4
              + touched * o * cv * esize + o * p * cv * 4 + n * 4)
    flops = 4.0 * p * n_valid * ck + 2.0 * p * k * o * cv
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops else "operations")


def timed_case(case, k, plain_iters=20):
    """Kernel, plain and bound times of the read kernel on one case."""
    args = tuple(case[key] for key in ARGS)
    ms_kernel = cuda_time_ms(lambda: read_kernel.radix_topk_readout(*args, top_k=k))
    ms_plain = cuda_time_ms(
        lambda: read_kernel.radix_topk_readout_plain(*args, top_k=k),
        iters=plain_iters, warmup=1)
    _, usage, _ = read_kernel.radix_topk_readout_cuda(*args, top_k=k)
    bound, bound_by = read_bound_ms(args, usage, k)
    return dict(kernel_ms=ms_kernel, plain_ms=ms_plain, bound_ms=bound,
                bound_by=bound_by)


def stream_ious(core, probs, masks, size):
    ious = []
    for ti, prob in enumerate(probs):
        if not (bool(torch.isfinite(prob).all()) and prob.shape == (4,) + size):
            raise RuntimeError(f"frame {ti}: bad output {tuple(prob.shape)}")
        m = core.output_prob_to_mask(prob)
        for obj in (1, 2, 3):
            a, b = m == obj, masks[ti] == obj
            union = np.logical_or(a, b).sum()
            ious.append(float(np.logical_and(a, b).sum() / union) if union else 1.0)
    return np.asarray(ious)


def run_stream(core, frames, mask0):
    """Step the core through every frame, synchronised per frame; returns
    (probs, frame_ms, read launches during the run)."""
    read_kernel.radix_topk_readout.launches = 0
    read_kernel.fused_topk_readout.launches = 0
    probs, frame_ms = [], []
    for ti in range(frames.shape[0]):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        probs.append(core.step(frames[ti], mask0, objects=[1, 2, 3]) if ti == 0
                     else core.step(frames[ti]))
        torch.cuda.synchronize()
        frame_ms.append(1e3 * (time.perf_counter() - t1))
    launches = {"radix_topk_readout": read_kernel.radix_topk_readout.launches,
                "fused_topk_readout": read_kernel.fused_topk_readout.launches}
    return probs, frame_ms, launches


# ------------------------------------------------------------------ phases

def phase_env():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script runs only on a CUDA device")
    t0 = time.perf_counter()
    smi = nvidia_smi_line()
    emit({"phase": "env", "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "nvidia_smi": smi,
          "seconds": time.perf_counter() - t0})
    print(smi, flush=True)
    return smi


def phase_build(k=30):
    t0 = time.perf_counter()
    cuda_build.load_libraries([read_kernel.SOURCE, read_kernel.FUSED_SOURCE])
    max_tokens = read_kernel.radix_topk_readout_max_tokens()
    occupancy = {f"radix_topk_readout N={n} ({read_kernel.radix_topk_readout_path(n)})":
                 read_kernel.radix_topk_readout_occupancy(n)
                 for n in (8_100, 12_164, 27_948, 29_568, 38_134)}
    occupancy[f"fused_topk_readout k={k}"] = read_kernel.fused_topk_readout_occupancy(k)
    emit({"phase": "build", "kernels": cuda_build.BUILD_LOG,
          "radix_shared_max_tokens": max_tokens,
          "resident_blocks_per_sm": occupancy,
          "seconds": time.perf_counter() - t0})


def phase_stream(k=30):
    t0 = time.perf_counter()
    set_fp32_precision()
    cfg = eval_config("base")
    # tools/report_parity_480p.py:55-63, the settings the goldens were made with
    cfg.merge({"mem_every": 5, "top_k": k, "stagger_updates": 5,
               "max_mem_frames": 5, "use_long_term": False, "flip_aug": False})
    model = build_model(cfg, str(GOLDEN / "state_dict_base_trained.npz"), device="cuda")
    rec = np.load(GOLDEN / "stream480_work_trained.npz")
    t = int(rec["t"])
    frames, mask0 = synth_frames_480(t)
    if not (mask0 == rec["mask0"]).all():
        raise RuntimeError("synthetic video differs from the golden's first mask")
    core = InferenceCore(model, cfg)
    probs, frame_ms, launches = run_stream(core, frames, mask0)
    fps = (t - 1) / (1e-3 * sum(frame_ms[1:]))
    # frame 2 is the first plain frame: it carries the one-time lazy loading
    # of the CUDA/cuDNN kernels its shapes need
    fps_steady = (t - 2) / (1e-3 * sum(frame_ms[2:]))
    ious = stream_ious(core, probs, rec["masks"], (480, 854))

    # the kernel against its plain version on the stream's own read inputs
    # (the next frame's read over the memory the stream built)
    feats = core.steps.encode(torch.from_numpy(frames[-1]).cuda(), pad=core.pad)
    args = core.steps.read_inputs(core.state, feats, rep=0, row=0)
    case = dict(zip(ARGS, args))
    ok_read, res, _ = compare(case, k)
    times = timed_case(case, k)
    # the fp32 similarity against the same direct form in fp64, at the tokens
    # kept: exact to fp32 rounding means within Ck + 8 ulps (its relative
    # error is at most about Ck + 7 units of fp32 roundoff)
    sim32 = plain_similarity(case)
    mk, qk, qe = case["mk"].double(), case["qk"].double(), case["qe"].double()
    sim64 = torch.zeros_like(sim32, dtype=torch.float64)
    for c in range(qk.shape[1]):
        sim64 += qe[:, c:c + 1] * (mk[None, :, c] - qk[:, c:c + 1]) ** 2
    sim64 *= -case["ms"].double()[None] / float(qk.shape[1]) ** 0.5
    kept = (sim32 >= topk_threshold(sim32, k)) & case["valid"][None]
    sim_ulps = int(ulps(sim32, sim64.float())[kept].max())
    sim_ok = sim_ulps <= qk.shape[1] + 8

    ok = (launches["radix_topk_readout"] > 0 and float(np.median(ious)) > IOU_MEDIAN
          and float(ious.min()) > IOU_MIN and ok_read and sim_ok)
    emit({"phase": "stream", "frames": t, "objects": 3, "size": [480, 854],
          "tokens": int(args[0].shape[0]), "queries": int(args[3].shape[0]),
          "launches": launches, "fps_frames_2_to_12": fps,
          "fps_frames_3_to_12": fps_steady,
          "frame_ms": frame_ms, **times,
          "sim_fp32_ulps_vs_fp64_at_kept_tokens": sim_ulps,
          "iou_median": float(np.median(ious)), "iou_min": float(ious.min()),
          "read_on_stream_inputs": dict(res, ok=ok_read),
          "ok": ok, "seconds": time.perf_counter() - t0})
    if not ok:
        raise RuntimeError("stream phase failed")
    return dict(launches=launches, max_abs=res["readout_max_abs"], case=case,
                **times)


def phase_lt_stream(k=30):
    t0 = time.perf_counter()
    cfg = eval_config("base")
    # tools/gen_golden.py:stream480_cfg(True), the settings the long-term
    # golden was recorded with
    cfg.merge({"mem_every": 5, "top_k": k, "stagger_updates": 5,
               "max_mem_frames": 5, "use_long_term": True, "flip_aug": False,
               "long_term": {"count_usage": True, "max_mem_frames": 4,
                             "min_mem_frames": 2, "num_prototypes": 64,
                             "max_num_tokens": 4000, "buffer_tokens": 1000}})
    model = build_model(cfg, str(GOLDEN / "state_dict_base_trained.npz"), device="cuda")
    rec = np.load(GOLDEN / "stream480_lt_trained.npz")
    t = int(rec["t"])
    frames, mask0 = synth_frames_480(t)
    if not (mask0 == rec["mask0"]).all():
        raise RuntimeError("synthetic video differs from the golden's first mask")
    core = InferenceCore(model, cfg)
    probs, frame_ms, launches = run_stream(core, frames, mask0)
    fps_steady = (t - 2) / (1e-3 * sum(frame_ms[2:]))
    ious = stream_ious(core, probs, rec["masks"], (480, 854))

    # the read inputs of the frame after the last: perm | lt | work
    feats = core.steps.encode(torch.from_numpy(frames[-1]).cuda(), pad=core.pad)
    args = core.steps.read_inputs(core.state, feats, rep=0, row=0)
    case = dict(zip(ARGS, args))
    ok_read, res, _ = compare(case, k)
    times = timed_case(case, k)
    segments = [int(v.shape[1]) for v in args[5]]

    ok = (launches["radix_topk_readout"] > 0 and core.consolidations >= 1
          and len(segments) == 3 and core.state.lt_count > 0
          and float(np.median(ious)) > IOU_MEDIAN and float(ious.min()) > IOU_MIN
          and ok_read)
    emit({"phase": "lt_stream", "frames": t, "objects": 3, "size": [480, 854],
          "consolidations": core.consolidations, "lt_count": core.state.lt_count,
          "tokens": int(args[0].shape[0]), "segment_tokens": segments,
          "valid_tokens": int(args[2].sum()), "queries": int(args[3].shape[0]),
          "launches": launches, "fps_frames_3_to_26": fps_steady,
          "frame_ms": frame_ms, **times,
          "iou_median": float(np.median(ious)), "iou_min": float(ious.min()),
          "read_on_stream_inputs": dict(res, ok=ok_read),
          "ok": ok, "seconds": time.perf_counter() - t0})
    if not ok:
        raise RuntimeError("lt_stream phase failed")
    return dict(launches=launches, max_abs=res["readout_max_abs"], case=case,
                **times)


def phase_kernel(lt_case, k=30):
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    hw = 30 * 54  # 480x854 pads to 480x864: 30x54 tokens a frame
    d17 = dict(p=hw, caps=(hw, 4 * hw), o=3)
    cases = {
        "d17": read_case(rng, **d17),
        "fewer_valid_than_k": read_case(rng, p=512, caps=(256, 768), o=2, n_valid=5),
        "padded_queries": read_case(rng, p=480, caps=(512, 1024), o=2, pad_queries=32),
        "bf16_values": read_case(rng, **d17, dtype=torch.bfloat16),
        "tie_at_tau": read_case(rng, p=256, caps=(700, 1300), o=2, dup_tie=True),
        # lvos-val 480p (eval_config): 1,620 perm + 10,128 long-term + a ring
        # of 10 frames (27,948 keys, 718 under the shared-memory ceiling), and
        # a second perm frame once an object appears late
        "lvos480": preset_case(
            lt_case, rng, frame_tokens=hw, perm_frames=1, perm_valid_frames=1,
            lt_valid=9_984, work_frames=10, work_live=6, queries=hw),
        "lvos480_late_object": preset_case(
            lt_case, rng, frame_tokens=hw, perm_frames=2, perm_valid_frames=1,
            lt_valid=9_984, work_frames=10, work_live=6, queries=hw),
        # lvos-val 600p (eval_plus_config): 38x67 = 2,546 tokens a frame
        "lvos600": preset_case(
            lt_case, rng, frame_tokens=2_546, perm_frames=1, perm_valid_frames=1,
            lt_valid=9_984, work_frames=10, work_live=6, queries=2_546),
    }
    results, all_ok, max_abs = {}, True, 0.0
    for name, case in cases.items():
        ok, res, _ = compare(case, k)
        res["path"] = read_kernel.radix_topk_readout_path(res["tokens"])
        if name.startswith("lvos") or name == "d17":
            res.update(timed_case(case, k, plain_iters=5))
        res["ok"] = ok
        results[name] = res
        all_ok &= ok
        max_abs = max(max_abs, res["readout_max_abs"])

    # both scratch paths on a memory either can hold: the same kernel body,
    # so the same tau, kept set and readout, bit for bit
    case = cases["lvos480"]
    args = [case[key] for key in ARGS[:5]] + [case["values"], k]
    shared = read_kernel._radix_launch(*args, global_scratch=False)
    glob = read_kernel._radix_launch(*args, global_scratch=True)
    torch.cuda.synchronize()
    paths = {"tau_bit_equal": torch.equal(shared[2].view(torch.int32),
                                          glob[2].view(torch.int32)),
             "kept_equal": torch.equal(shared[1] > 0, glob[1] > 0),
             "readout_bit_equal": torch.equal(shared[0], glob[0]),
             "usage_rel": rel_err(glob[1], shared[1]),
             "shared_ms": cuda_time_ms(
                 lambda: read_kernel._radix_launch(*args, global_scratch=False)),
             "global_ms": cuda_time_ms(
                 lambda: read_kernel._radix_launch(*args, global_scratch=True))}
    paths_ok = (paths["tau_bit_equal"] and paths["kept_equal"]
                and paths["readout_bit_equal"] and paths["usage_rel"] <= READ_RTOL)
    results["lvos480"]["both_paths"] = dict(paths, ok=paths_ok)
    all_ok &= paths_ok
    emit({"phase": "kernel", "cases": results, "ok": all_ok,
          "seconds": time.perf_counter() - t0})
    if not all_ok:
        raise RuntimeError("kernel disagrees with its plain version")
    return dict(max_abs=max_abs, cases=cases, results=results)


def phase_fused(stream_case, large_case, k=30):
    """The streaming kernel against the plain version and the read kernel:
    tau bit for bit equal to both on every query."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(1)
    cases = {
        # tests/test_pallas_kernel.py:6-37 and :40-61
        "700_of_1024_valid": read_case(rng, p=256, caps=(1024,), o=3, cv=128,
                                       n_valid=700),
        "fewer_valid_than_k": read_case(rng, p=128, caps=(256,), o=1, cv=128,
                                        n_valid=5),
        "tie_at_tau": read_case(rng, p=256, caps=(2000,), o=2, dup_tie=True),
        "padded_queries": read_case(rng, p=100, caps=(3000,), o=2, pad_queries=28),
        "d17_stream": stream_case,
        "lvos600": large_case,
    }
    results, all_ok, max_abs = {}, True, 0.0
    for name, case in cases.items():
        ok, res, (rd, _, tau) = compare(case, k, read_kernel.fused_topk_readout_cuda)
        rd1, _, tau1 = read_kernel.radix_topk_readout_cuda(
            **{key: case[key] for key in ARGS}, top_k=k)
        torch.cuda.synchronize()
        res["tau_max_ulps_vs_radix_kernel"] = int(ulps(tau, tau1).max())
        res["readout_max_abs_vs_radix_kernel"] = float((rd - rd1).abs().max())
        ok = ok and res["tau_max_ulps_vs_radix_kernel"] == 0
        if name in ("d17_stream", "lvos600"):
            args = {key: case[key] for key in ARGS}
            args["values"] = torch.cat([v.float() for v in args["values"]], dim=1)
            res["kernel_ms"] = cuda_time_ms(
                lambda: read_kernel.fused_topk_readout(**args, top_k=k))
            res["radix_kernel_ms"] = cuda_time_ms(
                lambda: read_kernel.radix_topk_readout(**args, top_k=k))
            res["plain_ms"] = cuda_time_ms(
                lambda: read_kernel.radix_topk_readout_plain(**args, top_k=k),
                iters=5, warmup=1)
            _, usage = read_kernel.fused_topk_readout(**args, top_k=k)
            res["bound_ms"], res["bound_by"] = read_bound_ms(
                tuple(args[key] for key in ARGS), usage, k)
        res["ok"] = ok
        results[name] = res
        all_ok &= ok
        max_abs = max(max_abs, res["readout_max_abs"])
    emit({"phase": "fused", "cases": results, "ok": all_ok,
          "seconds": time.perf_counter() - t0})
    if not all_ok:
        raise RuntimeError("fused_topk_readout disagrees")
    return dict(max_abs=max_abs, **results["d17_stream"])


def main():
    smi = phase_env()
    phase_build()
    sres = phase_stream()
    lres = phase_lt_stream()
    kres = phase_kernel(lres["case"])
    fres = phase_fused(sres["case"], kres["cases"]["lvos600"])
    t0 = time.perf_counter()
    by_path = {"stream": sres["launches"], "lt_stream": lres["launches"]}
    emit({"kernels": [{
        "name": "radix_topk_readout", "route": "cuda",
        "source": "cutie_tpu_torch/csrc/radix_topk_readout.cu",
        "replaces": "cutie_tpu/ops/pallas_kernels.py:380",
        "launches": sum(v["radix_topk_readout"] for v in by_path.values()),
        "launches_by_path": {p: v["radix_topk_readout"] for p, v in by_path.items()},
        "max_abs_err": max(kres["max_abs"], sres["max_abs"], lres["max_abs"]),
        "ms": sres["kernel_ms"], "plain_ms": sres["plain_ms"],
        "bound_ms": sres["bound_ms"], "bound_by": sres["bound_by"],
        "library_ms": None,
        "lt_stream": {key: lres[key] for key in ("kernel_ms", "plain_ms", "bound_ms")},
        "lvos600": {key: kres["results"]["lvos600"][key]
                    for key in ("path", "kernel_ms", "plain_ms", "bound_ms")},
    }, {
        "name": "fused_topk_readout", "route": "cuda",
        "source": "cutie_tpu_torch/csrc/fused_topk_readout.cu",
        "replaces": "cutie_tpu/ops/pallas_kernels.py:486",
        "launches": sum(v["fused_topk_readout"] for v in by_path.values()),
        "max_abs_err": fres["max_abs"],
        "ms": fres["kernel_ms"], "plain_ms": fres["plain_ms"],
        "bound_ms": fres["bound_ms"], "bound_by": fres["bound_by"],
        "library_ms": None,
    }]})
    emit({"phase": "kernels", "seconds": time.perf_counter() - t0})
    print(smi, flush=True)
    emit({"total_seconds": time.perf_counter() - T_START})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
