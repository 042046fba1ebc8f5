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
             plain version again on the stream's own read inputs; then the
             kernel time a frame of 4 more frames under torch.profiler;
  lt_stream  the long-term path: the same in long-term mode over the 26
             frames of the long-term golden, with consolidation and reads
             over three value segments (perm | lt | work);
  resize_stream  max_internal_size = 480 on 960x1708 frames, held to
             stream480_resize_trained.npz at 960x1708;
  flip_stream    flip_aug, two kernel #1 launches (batch rows) a read frame,
             held to stream480_flip_trained.npz;
  adddel_stream  object 3 added at frame 4 (a second bucket), object 2
             deleted before frame 8, held to stream480_adddel_trained.npz;
  amp_stream the stream phase's run with amp = True, held to the fp32
             golden; each model stage's output dtype as cutie_tpu's; kernel
             #1 on bf16 values against its plain version on the stream's
             own read inputs; amp and fp32 frame and kernel times;
  config     update_config mid-stream: the working memory grown and top_k
             changed, and the long-term ring shrunk until update_config
             consolidates it; state on the card and buffers resized;
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
             version (tau 0 ulps) and against the read kernel (tau and
             readout bit for bit): the TPU kernel tests' cases, copies of one
             key across its split boundaries and past a split's top-k list,
             top_k = 256 at the d17 shapes and 4096 (its state in global
             memory), the d17 stream's and lvos600's inputs; times, and each
             stage's time alone, on the last two;
  eval       the eval harness (eval_vos, dataset d17-val, on the card, with
             score dumps) over the stream phase's 12 frames written as a
             DAVIS-style directory of PNGs: the saved masks held to the
             golden, kernel #1 launched as often as in the stream phase,
             their pixel agreement with the stream phase's id maps, and
             merge_multi_scale over the score dump;
  eval_lt    the same over the long-term golden's 26 frames with the
             generic preset, whose get_dataset_cfg turns long-term mode on;
  scripting  python -m cutie_tpu_torch.scripting_demo_add_del_objects in a
             subprocess on the default device: objects [1] -> [1, 2] -> [2]
             across t = 4 and t = 10, a mask for every frame;
  kernels    one line listing every ported kernel.
The last line is {"ok": true, "device": {...}}. Any failure raises and the
script exits non-zero. It needs a CUDA device and the repository around it.
"""
import dataclasses
import functools
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType

from cutie_tpu_torch.config import eval_config
from cutie_tpu_torch.eval_vos import eval_vos
from cutie_tpu_torch.inference import InferenceCore
from cutie_tpu_torch.ops import cuda_build, read_kernel
from cutie_tpu_torch.ops.memory import _float_order_key, get_similarity, topk_threshold
from cutie_tpu_torch.ops.resize import bilinear_resize
from cutie_tpu_torch.scripts.merge_multi_scale import merge
from cutie_tpu_torch.utils.get_default_model import (build_model, load_torch_npz,
                                                     set_fp32_precision)
from cutie_tpu_torch.utils.image_io import read_png, write_png
from cutie_tpu_torch.utils.palette import davis_palette
from cutie_tpu_torch.utils.synth_video import synth_frames_480, synth_gt_masks_480

REPO = Path(__file__).resolve().parent
GOLDEN = REPO / "tests" / "golden"
TRAINED_WEIGHTS = GOLDEN / "state_dict_base_trained.npz"

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
        case["tie_tokens"] = [src, dst]
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


def split_boundary_ties(rng, k=30):
    """Copies of one key R across the streaming kernel's split boundaries
    (at P = 256 and N = 8,100 it runs one 128-key tile a split on an H100):
    one copy on each side of 12 boundaries, and 40 inside one split, more
    than its top-k list holds. The first 16 queries are R and the next 16
    R + 0.05 N(0, 1): for them tau is R's similarity, tied 64 times over
    several splits, and every copy must be kept."""
    n, p = 8_100, 256
    case = read_case(rng, p=p, caps=(n,), o=2, cv=128)
    k_tiles = -(-n // read_kernel.KEY_TILE)
    _, splits, _ = read_kernel.fused_topk_readout_geometry(
        n, p, k, read_kernel._sm_count(case["mk"].device))
    first = [s * k_tiles // splits * read_kernel.KEY_TILE for s in range(splits)]
    pos = sorted({f + d for f in first[8:20] for d in (-1, 0)}
                 | set(range(first[3] + 10, first[3] + 50)))
    idx = torch.tensor(pos, device=case["mk"].device)
    r = case["mk"][pos[0]].clone()
    case["mk"][idx] = r
    case["ms"][idx] = case["ms"][pos[0]].clone()
    case["qk"][:16] = r
    case["qk"][16:32] = r + 0.05 * torch.from_numpy(
        rng.normal(size=(16, r.numel())).astype(np.float32)).to(r.device)
    case["tie_tokens"] = pos
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
        tie_usage = us[case["tie_tokens"]]
        res["tie_tokens"] = len(case["tie_tokens"])
        res["tie_usage_min"] = float(tie_usage.min())
        ok = ok and res["tie_usage_min"] > 0
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


def stream_ious(id_maps, masks):
    """Per-frame IoU of objects 1, 2 and 3 in the port's object-id maps
    against the golden's, as tools/report_parity_480p.py:_obj_ious computes
    it (an object in neither map counts 1.0)."""
    ious = []
    for m, ref in zip(id_maps, masks):
        for obj in (1, 2, 3):
            a, b = m == obj, ref == obj
            union = np.logical_or(a, b).sum()
            ious.append(float(np.logical_and(a, b).sum() / union) if union else 1.0)
    return np.asarray(ious)


def first_mask_step(mask0):
    """run_stream's step: objects 1, 2 and 3 from mask0 on frame 0."""
    def step(core, ti, frame):
        return (core.step(frame, mask0, objects=[1, 2, 3]) if ti == 0
                else core.step(frame))
    return step


def run_stream(core, frames, step, size):
    """Step the core through every frame with step(core, ti, frame),
    synchronised per frame. Each output must be finite probabilities of
    shape (objects + 1,) + size. Returns (object-id maps, frame_ms, read
    launches during the run, kernel #1's launches in each frame)."""
    read_kernel.radix_topk_readout.launches = 0
    read_kernel.fused_topk_readout.launches = 0
    id_maps, frame_ms, per_frame = [], [], []
    for ti in range(frames.shape[0]):
        before = read_kernel.radix_topk_readout.launches
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        prob = step(core, ti, frames[ti])
        torch.cuda.synchronize()
        frame_ms.append(1e3 * (time.perf_counter() - t1))
        per_frame.append(read_kernel.radix_topk_readout.launches - before)
        shape = (core.object_manager.num_obj + 1,) + tuple(size)
        if not (tuple(prob.shape) == shape and valid_probabilities(prob)):
            raise RuntimeError(f"frame {ti}: bad output {tuple(prob.shape)}, "
                               f"expected {shape}")
        id_maps.append(core.output_prob_to_mask(prob))
    launches = {"radix_topk_readout": read_kernel.radix_topk_readout.launches,
                "fused_topk_readout": read_kernel.fused_topk_readout.launches}
    return id_maps, frame_ms, launches, per_frame


def valid_probabilities(prob):
    """Finite, in [0, 1], summing to 1 over the channels."""
    return bool(torch.isfinite(prob).all() and prob.min() >= 0 and prob.max() <= 1
                and (prob.sum(0) - 1).abs().max() < 1e-3)


def fps_steady(frame_ms):
    """Frames per second over frames 3 to the last: frame 2 is the first
    plain frame and carries the one-time lazy loading of the CUDA and
    cuDNN kernels its shapes need."""
    return (len(frame_ms) - 2) / (1e-3 * sum(frame_ms[2:]))


def iou_ok(ious):
    return float(np.median(ious)) > IOU_MEDIAN and float(ious.min()) > IOU_MIN


def last_read_case(core, frame):
    """The read inputs of the frame after the stream's last, over the
    memory the stream built (batch row 0, the first bucket), at the
    internal size."""
    image = torch.from_numpy(frame).cuda()
    image = bilinear_resize(image, *core.internal_size(*image.shape[-2:]))
    feats = core.steps.encode(image, pad=core.pad)
    return dict(zip(ARGS, core.steps.read_inputs(core.state, feats, rep=0, row=0)))


def kernel_ms_per_frame(core, frames, first):
    """Kernel time a frame (torch.profiler's device time, all kernels) over
    frames[first:], continuing the stream; None where the profiler records
    no device time."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for ti in range(first, frames.shape[0]):
            core.step(frames[ti])
        torch.cuda.synchronize()
    us = sum(getattr(ev, "self_device_time_total", 0) for ev in prof.key_averages()
             if getattr(ev, "device_type", None) == DeviceType.CUDA)
    return us / 1e3 / (frames.shape[0] - first) if us > 0 else None


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


def phase_build():
    t0 = time.perf_counter()
    cuda_build.load_libraries([read_kernel.SOURCE, read_kernel.FUSED_SOURCE])
    occupancy = {
        "radix_topk_readout fp32 values": read_kernel.radix_topk_readout_occupancy(),
        "radix_topk_readout bf16 values":
            read_kernel.radix_topk_readout_occupancy(bf16=True),
        "fused_topk_readout": read_kernel.fused_topk_readout_occupancy()}
    emit({"phase": "build", "kernels": cuda_build.BUILD_LOG,
          "resident_blocks_per_sm": occupancy,
          "seconds": time.perf_counter() - t0})
    return occupancy


@functools.cache
def trained_weights():
    return load_torch_npz(str(TRAINED_WEIGHTS))


def base_core(**settings):
    """cutie-base on the trained test weights on the card, at the settings
    the 480p goldens were recorded with (tools/report_parity_480p.py:55-63:
    d17 working memory), updated with `settings`; TF32 off."""
    set_fp32_precision()
    cfg = eval_config("base")
    cfg.merge({"mem_every": 5, "top_k": 30, "stagger_updates": 5,
               "max_mem_frames": 5, "use_long_term": False, "flip_aug": False,
               "max_internal_size": -1})
    cfg.merge(settings)
    return InferenceCore(build_model(cfg, device="cuda",
                                     state_dict=trained_weights()), cfg)


def golden_video(name, h=480, w=854, extra_frames=0, objects0=(1, 2, 3)):
    """A 480p golden and the synthetic video it was recorded on (with
    extra_frames more frames after its own); the first mask holds objects0."""
    rec = np.load(GOLDEN / name)
    frames, mask0 = synth_frames_480(int(rec["t"]) + extra_frames, h, w)
    mask0 = np.where(np.isin(mask0, objects0), mask0, 0)
    if not (mask0 == rec["mask0"]).all():
        raise RuntimeError(f"synthetic video differs from {name}'s first mask")
    return rec, frames, mask0


PROFILED_FRAMES = 4   # frames traced after a stream for its kernel time


def phase_stream(k=30):
    t0 = time.perf_counter()
    core = base_core(top_k=k)
    rec, frames, mask0 = golden_video("stream480_work_trained.npz",
                                      extra_frames=PROFILED_FRAMES)
    t = int(rec["t"])
    id_maps, frame_ms, launches, _ = run_stream(
        core, frames[:t], first_mask_step(mask0), (480, 854))
    fps = (t - 1) / (1e-3 * sum(frame_ms[1:]))
    ious = stream_ious(id_maps, rec["masks"])

    # the kernel against its plain version on the stream's own read inputs
    # (the next frame's read over the memory the stream built)
    case = last_read_case(core, frames[t - 1])
    args = tuple(case[key] for key in ARGS)
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

    ok = (launches["radix_topk_readout"] > 0 and iou_ok(ious) and ok_read
          and sim_ok)
    kernel_ms = kernel_ms_per_frame(core, frames, t)
    emit({"phase": "stream", "frames": t, "objects": 3, "size": [480, 854],
          "tokens": int(args[0].shape[0]), "queries": int(args[3].shape[0]),
          "launches": launches, "fps_frames_2_to_12": fps,
          "fps_frames_3_to_12": fps_steady(frame_ms),
          "kernel_ms_per_frame_13_to_16": kernel_ms,
          "frame_ms": frame_ms, **times,
          "sim_fp32_ulps_vs_fp64_at_kept_tokens": sim_ulps,
          "iou_median": float(np.median(ious)), "iou_min": float(ious.min()),
          "read_on_stream_inputs": dict(res, ok=ok_read),
          "ok": ok, "seconds": time.perf_counter() - t0})
    if not ok:
        raise RuntimeError("stream phase failed")
    return dict(launches=launches, max_abs=res["readout_max_abs"], case=case,
                fps=fps_steady(frame_ms), kernel_ms_per_frame=kernel_ms,
                id_maps=id_maps, **times)


# tools/gen_golden.py:stream480_cfg(True), the settings the long-term golden
# was recorded with
LT_SETTINGS = {"use_long_term": True,
               "long_term": {"count_usage": True, "max_mem_frames": 4,
                             "min_mem_frames": 2, "num_prototypes": 64,
                             "max_num_tokens": 4000, "buffer_tokens": 1000}}


def phase_lt_stream(k=30):
    t0 = time.perf_counter()
    core = base_core(top_k=k, **LT_SETTINGS)
    rec, frames, mask0 = golden_video("stream480_lt_trained.npz")
    t = int(rec["t"])
    id_maps, frame_ms, launches, _ = run_stream(
        core, frames, first_mask_step(mask0), (480, 854))
    ious = stream_ious(id_maps, rec["masks"])

    # the read inputs of the frame after the last: perm | lt | work
    case = last_read_case(core, frames[-1])
    args = tuple(case[key] for key in ARGS)
    ok_read, res, _ = compare(case, k)
    times = timed_case(case, k)
    segments = [int(v.shape[1]) for v in args[5]]

    ok = (launches["radix_topk_readout"] > 0 and core.consolidations >= 1
          and len(segments) == 3 and core.state.lt_count > 0
          and iou_ok(ious) and ok_read)
    emit({"phase": "lt_stream", "frames": t, "objects": 3, "size": [480, 854],
          "consolidations": core.consolidations, "lt_count": core.state.lt_count,
          "tokens": int(args[0].shape[0]), "segment_tokens": segments,
          "valid_tokens": int(args[2].sum()), "queries": int(args[3].shape[0]),
          "launches": launches, "fps_frames_3_to_26": fps_steady(frame_ms),
          "frame_ms": frame_ms, **times,
          "iou_median": float(np.median(ious)), "iou_min": float(ious.min()),
          "read_on_stream_inputs": dict(res, ok=ok_read),
          "ok": ok, "seconds": time.perf_counter() - t0})
    if not ok:
        raise RuntimeError("lt_stream phase failed")
    return dict(launches=launches, max_abs=res["readout_max_abs"], case=case,
                fps=fps_steady(frame_ms), id_maps=id_maps, **times)


def variant_result(name, rec, run, t0, ok, size=(480, 854), **extra):
    """Emit a golden stream phase's line: IoU against the golden at the
    bars, kernel #1 launched, and ok; raise if it failed."""
    id_maps, frame_ms, launches, per_frame = run
    ious = stream_ious(id_maps, rec["masks"])
    ok = ok and launches["radix_topk_readout"] > 0 and iou_ok(ious)
    emit({"phase": name, "frames": len(frame_ms), "size": list(size),
          "launches": launches,
          "radix_launches_per_frame": per_frame, **extra,
          "fps_frames_3_to_12": fps_steady(frame_ms), "frame_ms": frame_ms,
          "iou_median": float(np.median(ious)), "iou_min": float(ious.min()),
          "ok": bool(ok), "seconds": time.perf_counter() - t0})
    if not ok:
        raise RuntimeError(f"{name} phase failed")
    return launches


def phase_resize_stream():
    """max_internal_size = 480 on 960x1708 frames: segmented at 480x854,
    the output upsampled back (stream480_resize_trained.npz)."""
    t0 = time.perf_counter()
    core = base_core(max_internal_size=480)
    rec, frames, mask0 = golden_video("stream480_resize_trained.npz", 960, 1708)
    run = run_stream(core, frames, first_mask_step(mask0), (960, 1708))
    case = last_read_case(core, frames[-1])
    return variant_result(
        "resize_stream", rec, run, t0, True, size=(960, 1708),
        internal_size=list(core.internal_size(960, 1708)),
        tokens=int(case["mk"].shape[0]), queries=int(case["qk"].shape[0]))


def phase_flip_stream():
    """flip_aug: batch row 1 holds the flipped frame, so every read frame
    launches kernel #1 once a batch row (stream480_flip_trained.npz)."""
    t0 = time.perf_counter()
    core = base_core(flip_aug=True)
    rec, frames, mask0 = golden_video("stream480_flip_trained.npz")
    run = run_stream(core, frames, first_mask_step(mask0), (480, 854))
    per_frame = run[3]
    # frame 0 carries the first mask and reads nothing
    ok = per_frame[0] == 0 and all(n == 2 for n in per_frame[1:])
    return variant_result("flip_stream", rec, run, t0, ok,
                          batch_rows=int(core.state.sensory.shape[0]))


def phase_adddel_stream():
    """Objects 1 and 2 from frame 0, object 3 added with its mask at frame 4
    (a second bucket, read by a second launch a frame), object 2 deleted
    before frame 8 (stream480_adddel_trained.npz, object-id maps)."""
    t0 = time.perf_counter()
    core = base_core()
    rec, frames, mask0 = golden_video("stream480_adddel_trained.npz",
                                      objects0=(1, 2))
    gt4 = synth_gt_masks_480(5)[4].astype(np.int64)

    def step(core, ti, frame):
        if ti == 0:
            return core.step(frame, mask0, objects=[1, 2])
        if ti == 4:
            return core.step(frame, gt4, objects=[1, 2, 3])
        if ti == 8:
            core.delete_objects([2])
        return core.step(frame)

    run = run_stream(core, frames, step, (480, 854))
    per_frame = run[3]
    ok = (all(n == 1 for n in per_frame[1:5]) and all(n == 2 for n in per_frame[5:])
          and core.object_manager.all_obj_ids == [1, 3])
    return variant_result("adddel_stream", rec, run, t0, ok,
                          launches_before_deletion=sum(per_frame[:8]),
                          launches_after_deletion=sum(per_frame[8:]))


def amp_stage_dtypes(model, frame, n=2):
    """{stage: output dtypes} of the model's stages on one frame [3, H, W]
    (H, W multiples of 16) and n empty objects, on the model's device."""
    dev = model.pixel_mean.device
    mc = model.model_cfg
    h, w = frame.shape[-2] // 16, frame.shape[-1] // 16
    ones = torch.ones(1, n, device=dev)
    names = lambda xs: [str(x.dtype).replace("torch.", "") for x in xs]
    with torch.no_grad():
        x = torch.as_tensor(frame, device=dev)[None]
        (f16, f8, f4), pix = model.encode_image(x)
        sens = torch.zeros(1, n, mc.sensory_dim, h, w, device=dev)
        masks = torch.zeros(1, n, *frame.shape[-2:], device=dev)
        mv, new_sens, summ, _ = model.encode_mask(x, pix, sens, masks)
        fused = model.pixel_fusion(
            pix, torch.zeros(1, n, mc.value_dim, h, w, device=dev), sens, masks)
        r, aux = model.readout_query(fused, summ[:, :, None], selector=ones)
        return {
            "encode_image": names([f16, f8, f4, pix]),
            "transform_key": names(model.transform_key(f16)),
            "encode_mask": names([mv, new_sens, summ]),
            "pixel_fusion": names([fused]),
            "readout_query": names([r, aux["logits"], aux["attn_mask"]]),
            "segment": names(model.segment((f16, f8, f4), r, sens, selector=ones)),
        }


# cutie_tpu's stage output dtypes under amp (tests/test_torch_amp.py holds
# the port's to them on the CPU, against cutie_tpu itself)
AMP_STAGE_DTYPES = {
    "encode_image": ["bfloat16"] * 4,
    "transform_key": ["bfloat16"] * 3,
    "encode_mask": ["bfloat16", "float32", "float32"],
    "pixel_fusion": ["bfloat16"],
    "readout_query": ["bfloat16", "bfloat16", "bool"],
    "segment": ["float32"] * 3,
}


def phase_amp_stream(fp32, k=30):
    """The d17 stream with amp = True (bf16 conv and transformer stacks,
    fp32 islands, bf16 value stores), held to the fp32 golden; every stage's
    output dtype on the card as in cutie_tpu; kernel #1 on bf16 values,
    against its plain version on the stream's own last read inputs; the
    fp32 and amp frame times side by side (fp32: the stream phase, same
    call)."""
    t0 = time.perf_counter()
    core = base_core(top_k=k, amp=True)
    rec, frames, mask0 = golden_video("stream480_work_trained.npz",
                                      extra_frames=PROFILED_FRAMES)
    t = int(rec["t"])
    dtypes = amp_stage_dtypes(core.network, frames[0][:, :480, :848])
    run = run_stream(core, frames[:t], first_mask_step(mask0), (480, 854))
    case = last_read_case(core, frames[t - 1])
    ok_read, res, _ = compare(case, k)
    times = timed_case(case, k)
    bf16_values = all(v.dtype == torch.bfloat16 for v in case["values"])
    kernel_ms = kernel_ms_per_frame(core, frames, t)
    launches = variant_result(
        "amp_stream", rec, run, t0,
        ok_read and bf16_values and dtypes == AMP_STAGE_DTYPES,
        stage_dtypes=dtypes, stage_dtypes_ok=dtypes == AMP_STAGE_DTYPES,
        bf16_values=bf16_values, read_on_stream_inputs=dict(res, ok=ok_read),
        **times, fp32_fps_frames_3_to_12=fp32["fps"],
        kernel_ms_per_frame_13_to_16=kernel_ms,
        fp32_kernel_ms_per_frame_13_to_16=fp32["kernel_ms_per_frame"])
    return dict(launches=launches, max_abs=res["readout_max_abs"], **times)


def state_tensors(state):
    return {f.name: getattr(state, f.name) for f in dataclasses.fields(state)
            if torch.is_tensor(getattr(state, f.name))}


def phase_config():
    """update_config mid-stream, twice. (a) The d17 stream: after frame 6
    max_mem_frames 5 -> 8 and top_k 30 -> 20. (b) The long-term stream:
    after frame 20 long_term.max_mem_frames 4 -> 3 with max_num_tokens
    4000 -> 6000, then 3 -> 2, which leaves the ring exactly full, so that
    update_config consolidates it (the ring holds two frames there; a ring
    of three slots does not need draining). Structural checks: state on the
    card, buffers at their new sizes, counters, valid outputs, kernel #1
    launched with the new top_k."""
    t0 = time.perf_counter()
    read_kernel.radix_topk_readout.launches = 0
    read_kernel.fused_topk_readout.launches = 0
    top_ks = []
    launch = read_kernel.radix_topk_readout_cuda

    def recording(*args, **kwargs):
        top_ks.append(kwargs.get("top_k", args[-1] if len(args) > 6 else None))
        return launch(*args, **kwargs)

    read_kernel.radix_topk_readout_cuda = recording
    try:
        res_a, ok_a = config_run_a()
        res_b, ok_b = config_run_b()
    finally:
        read_kernel.radix_topk_readout_cuda = launch
    launches = {"radix_topk_readout": read_kernel.radix_topk_readout.launches,
                "fused_topk_readout": read_kernel.fused_topk_readout.launches}
    top_k_after = top_ks[res_a.pop("reads_before_update"):res_a["reads"]]
    ok = ok_a and ok_b and bool(top_k_after) and set(top_k_after) == {20}
    emit({"phase": "config", "a": res_a, "b": res_b, "launches": launches,
          "top_k_of_reads_after_update_a": sorted(set(top_k_after)),
          "ok": ok, "seconds": time.perf_counter() - t0})
    if not ok:
        raise RuntimeError("config phase failed")
    return dict(launches=launches)


def on_card(core):
    return all(t.is_cuda for t in state_tensors(core.state).values())


def config_run_a():
    core = base_core()
    frames, mask0 = synth_frames_480(12)
    step = first_mask_step(mask0)
    ok = True
    for ti in range(7):
        ok &= valid_probabilities(step(core, ti, frames[ti]))
    reads_before = read_kernel.radix_topk_readout.launches
    core.update_config(dict(core.cfg.to_dict(), max_mem_frames=8, top_k=20))
    st = core.state
    ok &= (on_card(core) and st.work_key.shape[1] == 7 == core.ring_frames
           and st.work_value.shape[2] == 7 and core.steps.top_k == 20)
    for ti in range(7, 12):
        ok &= valid_probabilities(step(core, ti, frames[ti]))
    ok &= on_card(core) and st.work_count <= 7
    return {"ring_frames": core.ring_frames, "work_count": core.state.work_count,
            "reads_before_update": reads_before,
            "reads": read_kernel.radix_topk_readout.launches}, bool(ok)


def config_run_b():
    core = base_core(**LT_SETTINGS)
    frames, mask0 = synth_frames_480(26)
    step = first_mask_step(mask0)
    ok = True
    for ti in range(21):
        ok &= valid_probabilities(step(core, ti, frames[ti]))
    before = dict(consolidations=core.consolidations, lt_count=core.state.lt_count,
                  work_count=core.state.work_count)
    cfg = core.cfg.to_dict()
    cfg["long_term"].update(max_mem_frames=3, max_num_tokens=6000)
    core.update_config(cfg)
    ok &= (on_card(core) and core.ring_frames == 3 == core.state.work_key.shape[1]
           and core.state.lt_key.shape[1] == 6000 + 64 == core.lt_capacity
           and core.consolidations == before["consolidations"])
    cfg["long_term"].update(max_mem_frames=2)
    core.update_config(cfg)
    st = core.state
    done = core.consolidations - before["consolidations"]
    ok &= (on_card(core) and done >= 1 and core.ring_frames == 2
           and st.work_key.shape[1] == 2 and st.work_count <= 2
           and st.lt_count == before["lt_count"] + 64 * done
           and st.lt_value.shape[2] == 6064)
    for ti in range(21, 26):
        ok &= valid_probabilities(step(core, ti, frames[ti]))
    ok &= on_card(core)
    return {"before_update": before, "consolidations_in_update_config": done,
            "ring_frames": core.ring_frames, "work_count": core.state.work_count,
            "lt_count": core.state.lt_count,
            "lt_capacity": int(core.state.lt_key.shape[1])}, bool(ok)


def write_davis_video(root, frames, mask0):
    """frames [t, 3, H, W] (multiples of 1/255, so PNG loses nothing) as
    root/JPEGImages/video1/*.png and mask0 as a DAVIS-palette PNG
    root/Annotations/video1/00000.png, through the port's PNG writer."""
    img_dir = root / "JPEGImages" / "video1"
    mask_dir = root / "Annotations" / "video1"
    img_dir.mkdir(parents=True)
    mask_dir.mkdir(parents=True)
    for ti, frame in enumerate(frames):
        pixels = np.round(np.transpose(frame, (1, 2, 0)) * 255).astype(np.uint8)
        write_png(str(img_dir / f"{ti:05d}.png"), pixels)
    write_png(str(mask_dir / "00000.png"), mask0.astype(np.uint8), davis_palette)


def phase_harness(name, golden, dataset, settings, stream, long_term):
    """eval_vos on the card over `golden`'s synthetic video written as a
    DAVIS-style directory, with score dumps. The saved masks, read back
    through image_io, are held to the golden; kernel #1 must run once a
    frame after the first, as in the stream phase `stream` of the same
    video; get_dataset_cfg must leave long-term mode `long_term` and
    mem_every 5; merge_multi_scale over the score dump must give the argmax
    of the dumped scores exactly. Also reported: the saved masks' pixel
    agreement with the stream phase's id maps and the merged masks'."""
    t0 = time.perf_counter()
    rec, frames, mask0 = golden_video(golden)
    t = int(rec["t"])
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        write_davis_video(root, frames[:t], mask0)
        cfg = eval_config("base")
        cfg.merge({"dataset": dataset, "output_dir": str(root / "out"),
                   "weights": str(TRAINED_WEIGHTS), "save_scores": True,
                   "image_directory": str(root / "JPEGImages"),
                   "mask_directory": str(root / "Annotations")})
        cfg.merge(settings)
        read_kernel.radix_topk_readout.launches = 0
        read_kernel.fused_topk_readout.launches = 0
        t1 = time.perf_counter()
        stats = eval_vos(cfg)
        eval_seconds = time.perf_counter() - t1
        launches = {"radix_topk_readout": read_kernel.radix_topk_readout.launches,
                    "fused_topk_readout": read_kernel.fused_topk_readout.launches}
        out = root / "out"
        saved = [read_png(str(out / "Annotations" / "video1" / f"{ti:05d}.png"))[0]
                 for ti in range(t)]
        merge([str(out / "Scores")], str(out / "merged"), dataset="D", num_proc=1)
        scores = out / "Scores" / "video1"
        backward = {int(k): int(v)
                    for k, v in dict(np.load(scores / "backward.npz")).items()}
        merged_ok, merged_agree = True, []
        for ti in range(t):
            winner = np.load(scores / f"{ti:05d}.npz")["prob"].argmax(0)
            expect = np.zeros_like(winner, dtype=np.uint8)
            for obj_id, tmp_idx in backward.items():
                expect[winner == tmp_idx] = obj_id
            merged = read_png(str(out / "merged" / "video1" / f"{ti:05d}.png"))[0]
            merged_ok &= bool((merged == expect).all())
            merged_agree.append(float((merged == saved[ti]).mean()))
    ious = stream_ious(saved, rec["masks"])
    agree = [float((a == b).mean()) for a, b in zip(saved, stream["id_maps"])]
    radix = launches["radix_topk_readout"]
    ok = (radix == t - 1 == stream["launches"]["radix_topk_readout"]
          and stats["total_frames"] == t and cfg.use_long_term is long_term
          and cfg.mem_every == 5 and iou_ok(ious) and merged_ok)
    emit({"phase": name, "dataset": dataset, "frames": t,
          "total_frames": stats["total_frames"], "harness_fps": stats["fps"],
          "stream_phase_fps_frames_3_on": stream["fps"],
          "eval_vos_seconds": eval_seconds,
          "use_long_term": cfg.use_long_term, "mem_every": cfg.mem_every,
          "size": cfg.size, "launches": launches,
          "iou_median": float(np.median(ious)), "iou_min": float(ious.min()),
          "agreement_with_stream_min": min(agree),
          "agreement_with_stream_mean": float(np.mean(agree)),
          "merged_equals_dump_argmax": merged_ok,
          "merged_agreement_with_saved_min": min(merged_agree),
          "ok": bool(ok), "seconds": time.perf_counter() - t0})
    if not ok:
        raise RuntimeError(f"{name} phase failed")
    return launches


def phase_eval(stream):
    """The d17-val preset (size 480: the 480x854 frames are not resized)
    over the stream phase's 12 frames."""
    return phase_harness("eval", "stream480_work_trained.npz", "d17-val", {},
                         stream, long_term=False)


def phase_eval_lt(lt):
    """The generic preset, whose get_dataset_cfg turns long-term mode on,
    at the long-term golden's budgets over its 26 frames."""
    return phase_harness("eval_lt", "stream480_lt_trained.npz", "generic",
                         {"long_term": LT_SETTINGS["long_term"]}, lt,
                         long_term=True)


ADD_DEL_OBJECTS = {t: [1] for t in range(4)} | {t: [1, 2] for t in range(4, 10)} \
    | {t: [2] for t in range(10, 14)}


def phase_scripting():
    """The add/delete scripting demo as a user runs it, in a subprocess, on
    the default device (the card), with the trained base weights."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "demo"
        proc = subprocess.run(
            [sys.executable, "-m", "cutie_tpu_torch.scripting_demo_add_del_objects",
             "--model", "base", "--weights", str(TRAINED_WEIGHTS),
             "--output", str(out)],
            cwd=REPO, capture_output=True, text=True, timeout=600)
        pngs = sorted(p.name for p in out.glob("*.png")) if out.exists() else []
    objects = {int(m.group(1)): json.loads(m.group(2))
               for m in re.finditer(r"^t=(\d+): objects (\[.*\])$", proc.stdout, re.M)}
    ok = (proc.returncode == 0 and objects == ADD_DEL_OBJECTS
          and pngs == [f"{t:05d}.png" for t in range(14)])
    emit({"phase": "scripting", "returncode": proc.returncode,
          "objects_by_frame": objects, "masks_written": len(pngs),
          "stderr_tail": proc.stderr[-2000:] if not ok else "",
          "ok": bool(ok), "seconds": time.perf_counter() - t0})
    if not ok:
        raise RuntimeError("scripting phase failed")


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


def fused_stage_times(case, k, splits):
    """Each stage of the streaming kernel alone (CUDA events), and the
    partial stage at other split counts than the geometry's `splits`: one
    fewer, one more (a second round of blocks) and twice as many."""
    args = {key: case[key] for key in ARGS}
    args["values"] = torch.cat([v.float() for v in args["values"]], dim=1)
    partial, merge = read_kernel.fused_topk_readout_stages(**args, top_k=k)
    by_splits = {}
    for s in sorted({max(1, splits - 1), splits + 1, 2 * splits}):
        other, _ = read_kernel.fused_topk_readout_stages(**args, top_k=k, splits=s)
        by_splits[s] = cuda_time_ms(other)
    return {"partial_topk_ms": cuda_time_ms(partial),
            "merge_readout_ms": cuda_time_ms(merge),
            "partial_topk_ms_at_other_splits": by_splits}


def phase_fused(stream_case, large_case, k=30):
    """The streaming kernel against the plain version (tau 0 ulps) and the
    read kernel (tau and readout bit for bit), each case at its top_k."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(1)
    hw = 30 * 54
    cases = {
        # tests/test_pallas_kernel.py:6-37 and :40-61
        "700_of_1024_valid": (read_case(rng, p=256, caps=(1024,), o=3, cv=128,
                                        n_valid=700), k),
        "fewer_valid_than_k": (read_case(rng, p=128, caps=(256,), o=1, cv=128,
                                         n_valid=5), k),
        "tie_at_tau": (read_case(rng, p=256, caps=(2000,), o=2, dup_tie=True), k),
        "padded_queries": (read_case(rng, p=100, caps=(3000,), o=2, pad_queries=28), k),
        "split_boundary_ties": (split_boundary_ties(rng, k), k),
        # state in global memory: top_k past what shared memory holds
        "d17_top_k_256": (read_case(rng, p=hw, caps=(hw, 4 * hw), o=3), 256),
        "top_k_4096": (read_case(rng, p=256, caps=(8100,), o=2), 4096),
        "d17_stream": (stream_case, k),
        "lvos600": (large_case, k),
    }
    results, all_ok, max_abs = {}, True, 0.0
    for name, (case, kc) in cases.items():
        ok, res, (rd, _, tau) = compare(case, kc, read_kernel.fused_topk_readout_cuda)
        rd1, _, tau1 = read_kernel.radix_topk_readout_cuda(
            **{key: case[key] for key in ARGS}, top_k=kc)
        torch.cuda.synchronize()
        res["top_k"] = kc
        res["splits"] = read_kernel.fused_topk_readout_geometry(
            res["tokens"], res["queries"], kc,
            read_kernel._sm_count(rd.device))[1]
        res["tau_max_ulps_vs_radix_kernel"] = int(ulps(tau, tau1).max())
        res["readout_bit_equal_to_radix_kernel"] = torch.equal(rd, rd1)
        ok = (ok and res["tau_max_ulps_vs_radix_kernel"] == 0
              and res["readout_bit_equal_to_radix_kernel"])
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
            res.update(fused_stage_times(case, k, res["splits"]))
        res["ok"] = ok
        results[name] = res
        all_ok &= ok
        max_abs = max(max_abs, res["readout_max_abs"])
    emit({"phase": "fused", "cases": results, "ok": all_ok,
          "seconds": time.perf_counter() - t0})
    if not all_ok:
        raise RuntimeError("fused_topk_readout disagrees")
    return dict(max_abs=max_abs, results=results, **results["d17_stream"])


def main():
    smi = phase_env()
    occupancy = phase_build()
    sres = phase_stream()
    lres = phase_lt_stream()
    by_path = {"stream": sres["launches"], "lt_stream": lres["launches"],
               "resize_stream": phase_resize_stream(),
               "flip_stream": phase_flip_stream(),
               "adddel_stream": phase_adddel_stream()}
    ares = phase_amp_stream(sres)
    by_path["amp_stream"] = ares["launches"]
    by_path["config"] = phase_config()["launches"]
    by_path["eval"] = phase_eval(sres)
    by_path["eval_lt"] = phase_eval_lt(lres)
    phase_scripting()
    kres = phase_kernel(lres["case"])
    fres = phase_fused(sres["case"], kres["cases"]["lvos600"])
    t0 = time.perf_counter()
    emit({"kernels": [{
        "name": "radix_topk_readout", "route": "cuda",
        "source": "cutie_tpu_torch/csrc/radix_topk_readout.cu",
        "replaces": "cutie_tpu/ops/pallas_kernels.py:380",
        "launches": sum(v["radix_topk_readout"] for v in by_path.values()),
        "launches_by_path": {p: v["radix_topk_readout"] for p, v in by_path.items()},
        "max_abs_err": max(kres["max_abs"], sres["max_abs"], lres["max_abs"],
                           ares["max_abs"]),
        "ms": sres["kernel_ms"], "plain_ms": sres["plain_ms"],
        "bound_ms": sres["bound_ms"], "bound_by": sres["bound_by"],
        "library_ms": None,
        "stage_ms": {case: {key: kres["results"][case][key]
                            for key in ("similarity_ms", "select_readout_ms")}
                     for case in ("d17", "lvos600")},
        "blocks_per_sm": occupancy["radix_topk_readout fp32 values"],
        "lt_stream": {key: lres[key] for key in ("kernel_ms", "plain_ms", "bound_ms")},
        "amp_stream_bf16_values": {key: ares[key]
                                   for key in ("kernel_ms", "plain_ms", "bound_ms")},
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
        "stage_ms": {case: {key: fres["results"][case][key]
                            for key in ("partial_topk_ms", "merge_readout_ms")}
                     for case in ("d17_stream", "lvos600")},
        "blocks_per_sm": occupancy["fused_topk_readout"],
        "lvos600": {key: fres["results"]["lvos600"][key]
                    for key in ("kernel_ms", "plain_ms", "bound_ms")},
    }]})
    emit({"phase": "kernels", "seconds": time.perf_counter() - t0})
    print(smi, flush=True)
    emit({"total_seconds": time.perf_counter() - T_START})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
