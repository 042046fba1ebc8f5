"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line with its wall seconds:
  env        the card, the CUDA version and nvidia-smi's name and power limit;
  build      nvcc builds both read kernels into cutie_tpu_torch/_build/, one
             process per source, started together; ptxas's report, and the
             resident blocks per SM of each kernel and stage;
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
             long-term stream's own keys and values (N = 27,948 and 29,568
             at 480p, N = 38,134 at 600p), Ck = 96, and every key tied (the
             select stage's fallbacks); on every case, its readout and
             tau bit for bit equal to the streaming kernel's, the same read
             in waves of 192 queries bit for bit equal to the default waves,
             and how many keys the select stage's pivot leaves; times, and
             each stage's time alone at d17 and lvos600;
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


def all_tied(case):
    """The case with every key, shrinkage and validity those of token 0:
    every similarity of a query ties, and every token is kept."""
    for key in ("mk", "ms", "valid"):
        case[key][:] = case[key][0]
    return case


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


def clocks_during(fn, seconds=1.0):
    """The SM clock (MHz) and power draw (W) nvidia-smi samples every 50 ms
    while fn runs back to back for about `seconds`: medians and sample
    count (no samples if nvidia-smi gives none)."""
    proc = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                             "--format=csv,noheader,nounits", "-lms", "50"],
                            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
                            text=True)
    try:
        end = time.perf_counter() + seconds
        while time.perf_counter() < end:
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
    finally:
        proc.terminate()
        out, _ = proc.communicate(timeout=30)
    rows = []
    for line in out.splitlines():
        try:
            rows.append([float(x) for x in line.split(",")])
        except ValueError:
            continue
    rows = [r for r in rows if len(r) == 2]
    if not rows:
        return {"samples": 0}
    clock, power = np.median(np.asarray(rows), axis=0)
    return {"samples": len(rows), "sm_clock_mhz": float(clock),
            "power_w": float(power)}


def stage_times(case, k):
    """Each stage of the read kernel alone (CUDA events), over one wave of
    every query, and the SM clock while the similarity stage runs."""
    sim, sel = read_kernel.radix_topk_readout_stages(
        *(case[key] for key in ARGS), top_k=k)
    sim_ms = cuda_time_ms(sim)
    return {"similarity_ms": sim_ms, "select_readout_ms": cuda_time_ms(sel),
            "during_similarity": clocks_during(sim)}


def fused_agreement(case, k, result):
    """Kernel #2 on the same keys, the segments concatenated to fp32 values:
    tau and readout bit for bit equal to the read kernel's `result`."""
    args = {key: case[key] for key in ARGS}
    args["values"] = torch.cat([v.float() for v in args["values"]], dim=1)
    rd2, _, tau2 = read_kernel.fused_topk_readout_cuda(**args, top_k=k)
    torch.cuda.synchronize()
    rd, _, tau = result
    return {"readout_bit_equal_to_fused": torch.equal(rd, rd2),
            "tau_bit_equal_to_fused": torch.equal(tau.view(torch.int32),
                                                  tau2.view(torch.int32))}


def candidate_stats(case, k):
    """What the select stage's pivot leaves to select from, on these inputs,
    beside what a first 8-bit radix pass would: per query, the keys >= the
    k-th largest of the 256 threads' maxima (thread t holds keys 4t..4t+3
    of every 1,024, as in the kernel), and the keys whose top byte is at
    least tau's (the keys above tau's bin plus tau's bin)."""
    keys = _float_order_key(plain_similarity(case))  # [P, N] int64
    p, n = keys.shape
    kk = min(k, n)
    width = -(-n // 1024) * 1024
    padded = torch.zeros((p, width), dtype=keys.dtype, device=keys.device)
    padded[:, :n] = keys
    maxima = padded.view(p, -1, 256, 4).amax(dim=(1, 3))
    pivot = (maxima.topk(kk, dim=1).values[:, -1:] if kk <= 256
             else torch.zeros((p, 1), dtype=keys.dtype, device=keys.device))
    cand = (keys >= pivot).sum(1).float()
    tau = keys.topk(kk, dim=1).values[:, -1:]
    top_bin = ((keys >> 24) >= (tau >> 24)).sum(1).float()
    return {"pivot_candidates_median": float(cand.median()),
            "pivot_candidates_max": int(cand.max()),
            "over_candidate_capacity": int((cand > 2048).sum()),
            "tau_top_byte_bin_and_above_median": float(top_bin.median()),
            "tau_top_byte_bin_and_above_max": int(top_bin.max())}


WAVE_QUERIES = 192  # the wave-boundary check's wave: divides no case's P


def wave_boundary(case, k, result):
    """The same read in waves of WAVE_QUERIES queries: tau, kept set and
    readout bit for bit equal to `result`, the read in the default waves
    (one wave at every size but lvos600's), usage within READ_RTOL (atomics
    in another order)."""
    n = case["mk"].shape[0]
    p = case["qk"].shape[0]
    budget = 4 * read_kernel.workspace_ld(n) * WAVE_QUERIES
    segs = tuple(v for v in case["values"] if v.shape[1])
    args = [case[key] for key in ARGS[:5]] + [segs, k]
    waves = read_kernel.radix_topk_readout_waves(n, p, budget)
    rd, us, tau = read_kernel._radix_launch(*args, workspace_bytes=budget)
    torch.cuda.synchronize()
    rd1, us1, tau1 = result
    res = {"waves": len(waves), "last_wave_queries": waves[-1][1],
           "tau_bit_equal": torch.equal(tau.view(torch.int32), tau1.view(torch.int32)),
           "kept_equal": torch.equal(us > 0, us1 > 0),
           "readout_bit_equal": torch.equal(rd, rd1),
           "usage_rel": rel_err(us, us1)}
    res["ok"] = (len(waves) > 1 and p % WAVE_QUERIES != 0 and res["tau_bit_equal"]
                 and res["kept_equal"] and res["readout_bit_equal"]
                 and res["usage_rel"] <= READ_RTOL)
    return res


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
    occupancy = {
        "radix_topk_readout fp32 values": read_kernel.radix_topk_readout_occupancy(),
        "radix_topk_readout bf16 values":
            read_kernel.radix_topk_readout_occupancy(bf16=True),
        f"fused_topk_readout k={k}": read_kernel.fused_topk_readout_occupancy(k)}
    emit({"phase": "build", "kernels": cuda_build.BUILD_LOG,
          "resident_blocks_per_sm": occupancy,
          "seconds": time.perf_counter() - t0})
    return occupancy


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
        # Ck = 96: two channel chunks, the second a partial one
        "ck96": read_case(rng, p=300, caps=(900, 1100), o=2, ck=96),
        # every key the same: past the select stage's 2,048 candidates and
        # 1,024 kept tokens, so its fallbacks over the row in global memory
        "all_tied": all_tied(read_case(rng, p=200, caps=(1000, 2000), o=2)),
    }
    results, all_ok, max_abs = {}, True, 0.0
    for name, case in cases.items():
        ok, res, result = compare(case, k)
        res.update(fused_agreement(case, k, result))
        res["wave_boundary"] = wave_boundary(case, k, result)
        res["candidates"] = candidate_stats(case, k)
        ok = (ok and res["readout_bit_equal_to_fused"]
              and res["tau_bit_equal_to_fused"] and res["wave_boundary"]["ok"])
        res["waves"] = len(read_kernel.radix_topk_readout_waves(
            res["tokens"], res["queries"]))
        if name.startswith("lvos") or name == "d17":
            res.update(timed_case(case, k, plain_iters=5))
        if name in ("d17", "lvos600"):
            res.update(stage_times(case, k))
            args = tuple(case[key] for key in ARGS[:5]) + (
                tuple(v for v in case["values"] if v.shape[1]), k)
            res["kernel_ms_32MiB_workspace"] = cuda_time_ms(
                lambda: read_kernel._radix_launch(*args, workspace_bytes=1 << 25))
        res["ok"] = ok
        results[name] = res
        all_ok &= ok
        max_abs = max(max_abs, res["readout_max_abs"])

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
    occupancy = phase_build()
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
        "stage_ms": {case: {key: kres["results"][case][key]
                            for key in ("similarity_ms", "select_readout_ms")}
                     for case in ("d17", "lvos600")},
        "blocks_per_sm": occupancy["radix_topk_readout fp32 values"],
        "lt_stream": {key: lres[key] for key in ("kernel_ms", "plain_ms", "bound_ms")},
        "lvos600": {key: kres["results"]["lvos600"][key]
                    for key in ("waves", "kernel_ms", "plain_ms", "bound_ms")},
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
