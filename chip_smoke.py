"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line with its wall seconds:
  env        the card, the CUDA version and nvidia-smi's name and power limit,
             g++'s version (it builds the JPEG decoder), whether scipy is
             installed, the CPU count;
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
  formats    the image files cutie_tpu reads through Pillow, read without it:
             (a) every progressive JPEG fixture (the decoder matrix's twin,
             the 12 frames of vos_progressive/), every other coding
             (jpeg_codings/: Adobe segments, RGB ids, sampling factors,
             CMYK/YCCK, lossless, arithmetic, block smoothing; the 12
             frames of vos_encodings/) and the PNGs of other modes (Adam7,
             16-bit, tRNS, a 480x854 RGB mask) against the hashes of
             Pillow's decode and conversions in manifest.json, and ms to
             read a 480x854 frame in each coding beside baseline; (b)
             eval_vos (d17-val) over synth_a as committed, over its
             progressive / Adam7 twin and over its encodings twin
             (arithmetic sequential and progressive, Adobe YCbCr, lossless
             RGB in turn), twice each in turns: frames bit-equal, saved
             masks at agreement >= 0.9999 (1.0 for the encodings twin) and
             the IoU bars, kernel #1 launched once a frame after the first
             in each run; (c) the four scripts/data tools as subprocesses,
             their outputs against the reference scripts'
             (tests/torch_fixtures/scripts_data_expected.json);
  scripting  python -m cutie_tpu_torch.scripting_demo_add_del_objects in a
             subprocess on the default device: objects [1] -> [1, 2] -> [2]
             across t = 4 and t = 10, a mask for every frame;
  train      the training step (training/trainer.py:Trainer.do_pass) on
             batches of the synthetic video made in memory, cutie-base from
             the trained test weights: pre-training (single-object, batch
             2, T=3, 384x384, fp32, remat), the hand-off into a multi-object
             model, main training from there (batch 2, T=8, 480x480, 3
             objects, 12,544 points, amp, remat; losses finite and
             descending over six steps, every aux term, fp32 parameters
             that moved), each stage also without remat, and main training
             straight from the trained weights; ms a step, frames a second,
             peak memory, one profiled step's largest kernels and busy
             share; the fp32 step on the card against the CPU (outputs and
             every parameter's gradient, TRAIN_OUT_RTOL, TRAIN_GRAD_RTOL);
             the training read's direct and expanded similarity (bytes kept
             for the backward, ms); neither read kernel is launched;
  train_entry  the two-stage train entry (train.py:run_stage) on the
             committed JPEG/PNG fixtures (tests/torch_fixtures/): every
             JPEG, baseline and progressive, decoded without Pillow against
             the SHA-256 of Pillow's decode, ms to read a 480x854 frame; the
             loader alone at main training's batch of 16 (frames a second);
             pre-training, the hand-off, main training with a curriculum
             rebuild of the loader,
             and a resume from its checkpoint at the right it, epoch and
             max_skip; ms a step with the loader feeding it against phase
             train's in-memory step, and the loader's wait a step; neither
             read kernel is launched;
  ritm       RITM click segmentation (cutie_tpu_torch/ritm/): the host C++
             dist-map library built into _build/ and held to the torch maps
             on the card; HRNet-18/OCR-64 loaded strictly from
             tests/golden/ritm_state_dict.npz, its forward held to
             ritm_stages.npz and to the CPU's; ClickController (the GUI's
             predictor parameters) on frame 0 of the synthetic 480x854
             video with bench.py's two-pass protocol, with NoBRS, and
             f-BRS-B with each L-BFGS driver (the device drive of
             ritm/lbfgs.py, the default, and scipy's on the host,
             host_lbfgs=True), each in fp32 and amp: the median warm click
             of the second pass, L-BFGS evaluations a click, the drive's
             host reads and the synchronizing CUDA calls a click, a profiled
             pass, probabilities in [0, 1], fp32 masks against a CPU
             controller's, the device drive's masks against the host
             drive's (IoU > 0.8 in fp32), its evaluations (not all 0) and
             budget; DeepLab on seeded random weights, card against CPU;
             neither read kernel is launched;
  gui        the interactive GUI's controller (cutie_tpu_torch/gui/): (a)
             the stream phase's golden through MainController (a workspace
             of PNGs, the first mask imported as a palette PNG, on_propagate
             forward, close), the saved masks held to the golden, kernel #1
             launched once a frame after the first; (b) the GUI's own
             session at interactive_demo.py's defaults (amp, long-term
             memory, max_internal_size 480, two objects) on the committed
             480x854 JPEG frames: f-BRS-B clicks on both objects (the
             driver that ran and its evaluations reported), commit,
             propagation forward, a click on the last frame, propagation
             backward, mem_every changed, binary-mask export, video export
             (an ImportError naming PyAV and cv2 where neither is
             installed); probabilities finite, a mask and a visualization
             for every frame, each visualization JPEG >= 30 dB PSNR from its
             image, the memory gauges against the memorize calls; ms a
             click and a propagated frame (beside the stream phase's), the
             save queue's drain; (c) the JPEG encoder (g++ here) byte for
             byte against the committed Pillow and cv2 references in
             tests/torch_fixtures/jpeg_enc/, ms to encode 480x854 at q95;
  render     the software-rendered GUI session
             (python -m cutie_tpu_torch.tools.render_gui_session) on the card
             and on the CPU (cutie-base, the trained test weights): refresh
             and panel counts equal, the storyboard PNG read back, six
             masks saved by each, kernel #1 launched in the propagation;
  multi      the multi-device layer (cutie_tpu_torch/parallel/), ranks
             spawned with a file:// rendezvous at world 1 on NCCL and at
             world 2 on gloo with both ranks on cuda:0 (NCCL takes one rank
             a card; world 2 is a one-card number): (a) the sharded read on
             the lt_stream phase's read inputs (fp32 and bf16 values) and
             the kernel phase's lvos600 case against kernel #1 on the same
             inputs, ms a read beside kernel #1's; (b) the long-term golden
             stream, at world 1 through kernel #1 (its launches are the
             phase's) and at world 2 with mem_mesh_devices = 2 (half the
             long-term slots a rank), against the golden and the lt_stream
             phase's id maps; (c) main training at full width (T=8,
             480x480, amp, remat, global batch 2, 3 steps), the parameters
             bit-equal across the ranks after every step, ms a step, and at
             world 2 the fp32 gradient against one process on the global
             batch (TRAIN_GRAD_RTOL);
  kernels    one line listing every ported kernel.
The last line is {"ok": true, "device": {...}}. Any failure raises and the
script exits non-zero. It needs a CUDA device and the repository around it.
"""
import dataclasses
import functools
import hashlib
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType

from cutie_tpu_torch import train as train_entry
from cutie_tpu_torch.config import Config, eval_config
from cutie_tpu_torch.data.setup_training_data import setup_main_training_datasets
from cutie_tpu_torch.eval_vos import eval_vos
from cutie_tpu_torch.gui.main_controller import FETCH_DEPTH, MainController
from cutie_tpu_torch.inference import InferenceCore
from cutie_tpu_torch.ops import cuda_build, read_kernel
from cutie_tpu_torch.ops.memory import (_float_order_key, get_similarity,
                                        get_similarity_expanded, readout,
                                        softmax_affinity, topk_threshold)
from cutie_tpu_torch.models.layers import FrozenBatchNorm
from cutie_tpu_torch.ops.resize import bilinear_resize
from cutie_tpu_torch.parallel import (make_mesh, shard_batch, shard_memory,
                                      sharded_composite_readout)
from cutie_tpu_torch.parallel.launch import spawn_ranks
from cutie_tpu_torch.ritm import dist_maps
from cutie_tpu_torch.ritm.deeplab import DeepLabISModel
from cutie_tpu_torch.ritm.utils import ClickController, load_is_model
from cutie_tpu_torch.scripts.merge_multi_scale import merge
from cutie_tpu_torch.train import train_config
from cutie_tpu_torch.training.train_forward import train_forward
from cutie_tpu_torch.training.trainer import Trainer
from cutie_tpu_torch.utils.get_default_model import (apply_object_surgery, build_model,
                                                     load_torch_npz,
                                                     set_fp32_precision)
from cutie_tpu_torch.utils import host_build
from cutie_tpu_torch.utils.image_io import (JPEG_ENCODE_SOURCE, decode_jpeg, encode_jpeg,
                                            read_any, read_image, read_jpeg, read_mask,
                                            read_png, read_rgba, write_png)
from cutie_tpu_torch.utils.logger import TensorboardLogger
from cutie_tpu_torch.utils.palette import davis_palette
from cutie_tpu_torch.utils.synth_video import synth_frames_480, synth_gt_masks_480

REPO = Path(__file__).resolve().parent
GOLDEN = REPO / "tests" / "golden"
FIXTURES = REPO / "tests" / "torch_fixtures"   # tests/test_torch_jpeg.py writes them
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


def is_device_op(ev):
    """Whether a key_averages() entry is a device operation: CUDA-typed, and
    not a record_function range's device-side copy (a gpu_user_annotation,
    such as the port's cutie.* spans), whose time is its range's length
    and would count the kernels under it again."""
    return (getattr(ev, "device_type", None) == DeviceType.CUDA
            and not getattr(ev, "is_user_annotation", False))


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
             if is_device_op(ev))
    return us / 1e3 / (frames.shape[0] - first) if us > 0 else None


# ------------------------------------------------------------------ phases

def phase_env():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script runs only on a CUDA device")
    t0 = time.perf_counter()
    smi = nvidia_smi_line()
    gxx = subprocess.run(["g++", "--version"], capture_output=True, text=True, timeout=60)
    emit({"phase": "env", "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "nvidia_smi": smi,
          "gxx": gxx.stdout.splitlines()[0] if gxx.returncode == 0 else gxx.stderr,
          "scipy": importlib.util.find_spec("scipy") is not None,
          "cpu_count": os.cpu_count(), "seconds": time.perf_counter() - t0})
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
                id_maps=id_maps, frame_ms=frame_ms, **times)


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
                fps=fps_steady(frame_ms), id_maps=id_maps,
                consolidations=core.consolidations, **times)


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


def amp_stage_dtypes(model, frame, n=2, grad=False):
    """{stage: output dtypes} of the model's stages on one frame [3, H, W]
    (H, W multiples of 16) and n empty objects, on the model's device;
    with autograd recording when grad (as in training)."""
    dev = model.pixel_mean.device
    mc = model.model_cfg
    h, w = frame.shape[-2] // 16, frame.shape[-1] // 16
    ones = torch.ones(1, n, device=dev)
    names = lambda xs: [str(x.dtype).replace("torch.", "") for x in xs]
    with torch.set_grad_enabled(grad):
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


# ------------------------------------------------------------- formats

VOS_TWIN = FIXTURES / "vos_progressive"   # synth_a: progressive JPEG, Adam7 first mask
# synth_a: frame ti in the coding ENCODINGS[ti % 4] (tests/test_torch_jpeg_codings.py)
VOS_ENCODINGS = FIXTURES / "vos_encodings"
ENCODINGS = ("arithmetic_sequential", "arithmetic_progressive", "adobe_ycbcr", "lossless_rgb")
# what the reference scripts/data/*.py give on scripts_data_tree (written
# with them by tests/test_torch_jpeg.py:write_fixtures; the tools' CPU test
# holds the port's tools to them and to this file)
SCRIPTS_DATA_EXPECTED = FIXTURES / "scripts_data_expected.json"
FORMATS_AGREEMENT_MIN = 0.9999


def sha256_of(pixels):
    return hashlib.sha256(np.ascontiguousarray(pixels).tobytes()).hexdigest()


def is_new_format(rel):
    """The manifest's fixtures that the formats phase decodes: progressive
    JPEGs, the progressive VOS twin, the other codings and their VOS twin,
    and the PNGs of other modes."""
    return "progressive" in rel or rel.startswith(("png/", "jpeg_codings/", "vos_encodings/"))


def check_fixture(rel, entry):
    """One manifest fixture through the port's readers (no Pillow): the
    decode, and for a PNG its mode, dtype and conversions, against the
    hashes of Pillow's. Returns the list of what differs."""
    path = str(FIXTURES / rel)
    if rel.endswith(".jpg"):
        pixels, mode = read_jpeg(path)
    else:
        pixels, mode, _ = read_any(path)
    bad = []
    if list(pixels.shape) != entry["shape"] or sha256_of(pixels) != entry["sha256"]:
        bad.append(rel)
    if "mode" in entry and (mode, str(pixels.dtype)) != (entry["mode"], entry["dtype"]):
        bad.append(f"{rel}: mode {mode} {pixels.dtype}")
    readers = {"RGB": read_image, "RGBA": read_rgba,
               "L": lambda p: read_mask(p, "L"), "P": lambda p: read_mask(p, "P")}
    for target, sha in entry.get("convert", {}).items():
        if sha256_of(readers[target](path)) != sha:
            bad.append(f"{rel}: convert({target!r})")
    return bad


def read_ms(frame, iters=20):
    read_image(frame)
    t1 = time.perf_counter()
    for _ in range(iters):
        read_image(frame)
    return 1e3 * (time.perf_counter() - t1) / iters


def scripts_data_tree(root):
    """A copy of the VOS fixture at root/vos for the scripts/data tools,
    edited so that each has something to find: synth_a's first mask keeps
    object 1 only (objects 2 and 3 first appear in frame 1), synth_b's
    masks are grayscale PNGs with frames 3-5 empty, synth_c's first mask is
    empty, and synth_empty has an annotation directory without masks."""
    vos = Path(root) / "vos"
    shutil.copytree(FIXTURES / "vos", vos)
    ann = vos / "Annotations"
    mask, _, palette = read_png(str(ann / "synth_a" / "00000.png"))
    write_png(str(ann / "synth_a" / "00000.png"), np.where(mask == 1, mask, 0), palette)
    for f in sorted((ann / "synth_b").iterdir()):
        mask = read_png(str(f))[0]
        write_png(str(f), mask * np.uint8(not 3 <= int(f.stem) <= 5))
    mask, _, palette = read_png(str(ann / "synth_c" / "00000.png"))
    write_png(str(ann / "synth_c" / "00000.png"), np.zeros_like(mask), palette)
    (ann / "synth_empty").mkdir()
    return vos


def scripts_data_args(vos, out):
    """Each tool's command-line arguments over the tree, writing under out."""
    return {"expand_long_vid": [str(vos), str(out / "expanded"), "2"],
            "find_empty_mask": [str(vos / "Annotations"), str(out / "empty_masks.json")],
            "find_empty_video": [str(vos / "Annotations")],
            "preprocess_lvos": [str(vos / "Annotations"), str(out / "lvos")]}


def scripts_data_summary(out, empty_video_stdout):
    """What the tools wrote under out: the expanded tree's files and the
    SHA-256 of their bytes, the empty-mask JSON, the empty videos printed,
    and each preprocessed mask's mode, shape and decoded pixels' and
    palette's SHA-256."""
    expanded = {f.relative_to(out / "expanded").as_posix():
                hashlib.sha256(f.read_bytes()).hexdigest()
                for f in sorted((out / "expanded").rglob("*")) if f.is_file()}
    lvos = {}
    for f in sorted((out / "lvos").rglob("*")):
        if f.is_file():
            pixels, mode, palette = read_png(str(f))
            lvos[f.relative_to(out / "lvos").as_posix()] = {
                "mode": mode, "shape": list(pixels.shape), "sha256": sha256_of(pixels),
                "palette_sha256": (None if palette is None
                                   else sha256_of(np.asarray(palette, np.uint8)))}
    return {"expand_long_vid": expanded,
            "find_empty_mask": json.loads((out / "empty_masks.json").read_text()),
            "find_empty_video": empty_video_stdout.splitlines(),
            "lvos_dirs": sorted(d.name for d in (out / "lvos").iterdir()),
            "preprocess_lvos": lvos}


def run_scripts_data(vos, out, command):
    """Every tool in a subprocess (command(tool) + its arguments), from the
    repository root; raises if one fails. Returns scripts_data_summary."""
    out.mkdir(parents=True, exist_ok=True)
    stdout = {}
    for tool, args in scripts_data_args(vos, out).items():
        res = subprocess.run([*command(tool), *args], cwd=REPO, capture_output=True,
                             text=True, timeout=300)
        if res.returncode != 0:
            raise RuntimeError(f"{tool} exited {res.returncode}: {res.stderr[-2000:]}")
        stdout[tool] = res.stdout
    return scripts_data_summary(out, stdout["find_empty_video"])


def formats_eval(image_dir, mask_dir, out):
    """eval_vos (d17-val, cutie-base, the trained test weights) over one
    video directory: its saved masks, kernel #1's launches, and the
    harness's stats."""
    cfg = eval_config("base")
    cfg.merge({"dataset": "d17-val", "output_dir": str(out),
               "weights": str(TRAINED_WEIGHTS), "image_directory": str(image_dir),
               "mask_directory": str(mask_dir)})
    read_kernel.radix_topk_readout.launches = 0
    read_kernel.fused_topk_readout.launches = 0
    stats = eval_vos(cfg)
    launches = {"radix_topk_readout": read_kernel.radix_topk_readout.launches,
                "fused_topk_readout": read_kernel.fused_topk_readout.launches}
    saved = [read_png(str(f))[0] for f in sorted((out / "Annotations" / "synth_a").iterdir())]
    return saved, launches, stats


def phase_formats():
    """The image files cutie_tpu reads through Pillow, on the card's
    machine without Pillow: (a) every progressive JPEG, other coding and
    other-mode PNG fixture against the hashes of Pillow's decode and
    conversions in manifest.json, and ms to read a 480x854 frame in each
    coding beside baseline; (b) eval_vos over synth_a as committed
    (baseline JPEG, the palette PNG), over its progressive / Adam7 twin
    and over its encodings twin, twice each in turns: frames decoded
    bit-equal, the saved masks of every later run at pixel agreement >=
    FORMATS_AGREEMENT_MIN (the encodings twin's at 1.0) and the stream
    phases' IoU bars against the first run's, kernel #1 launched once a
    frame after the first in each run; (c) the four scripts/data tools as
    subprocesses over scripts_data_tree, their outputs against
    scripts_data_expected.json."""
    t0 = time.perf_counter()
    manifest = json.loads((FIXTURES / "manifest.json").read_text())
    new = sorted(rel for rel in manifest if is_new_format(rel))
    mismatched = [bad for rel in new for bad in check_fixture(rel, manifest[rel])]
    base_dir = FIXTURES / "vos" / "JPEGImages" / "synth_a"
    twin_dir = VOS_TWIN / "JPEGImages" / "synth_a"
    enc_dir = VOS_ENCODINGS / "JPEGImages" / "synth_a"
    frames = sorted(f.name for f in base_dir.iterdir())
    frames_equal = {
        name: sorted(f.name for f in d.iterdir()) == frames and all(
            np.array_equal(read_image(str(base_dir / f)), read_image(str(d / f)))
            for f in frames)
        for name, d in (("progressive", twin_dir), ("encodings", enc_dir))}
    # one 480x854 frame of each coding: frame i of the encodings twin is
    # ENCODINGS[i]
    readers = {"baseline": base_dir / frames[0], "progressive": twin_dir / frames[0],
               **{coding: enc_dir / frames[i] for i, coding in enumerate(ENCODINGS)}}
    times = {name: [] for name in readers}
    for _ in range(2):   # interleaved, twice each
        for name, frame in readers.items():
            times[name].append(read_ms(str(frame)))
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        ann = tmp / "base" / "Annotations" / "synth_a"
        ann.mkdir(parents=True)
        shutil.copytree(base_dir, tmp / "base" / "JPEGImages" / "synth_a")
        shutil.copy(FIXTURES / "vos" / "Annotations" / "synth_a" / "00000.png", ann)
        # in turns, baseline, twin, encodings, encodings, twin, baseline:
        # the first run of a process also loads the card's kernels
        order = ("baseline", "progressive", "encodings", "encodings", "progressive", "baseline")
        for i, name in enumerate(order):
            root = {"baseline": tmp / "base", "progressive": VOS_TWIN,
                    "encodings": VOS_ENCODINGS}[name]
            t1 = time.perf_counter()
            saved, launches, stats = formats_eval(root / "JPEGImages", root / "Annotations",
                                                  tmp / f"out_{i}")
            runs[f"{name}_{i}"] = {"saved": saved, "launches": launches,
                                   "harness_fps": stats["fps"],
                                   "total_frames": stats["total_frames"],
                                   "seconds": time.perf_counter() - t1}
        vos = scripts_data_tree(tmp)
        t1 = time.perf_counter()
        scripts = run_scripts_data(vos, tmp / "scripts_out",
                                   lambda tool: [sys.executable, "-m",
                                                 f"cutie_tpu_torch.scripts.data.{tool}"])
        scripts_seconds = time.perf_counter() - t1
    expected = json.loads(SCRIPTS_DATA_EXPECTED.read_text())
    scripts_ok = {k: scripts.get(k) == v for k, v in expected.items()}
    base = runs["baseline_0"]["saved"]
    twins = [r["saved"] for k, r in runs.items() if k != "baseline_0"]
    agree = [float((a == b).mean()) for twin in twins for a, b in zip(twin, base)]
    agree_encodings = [float((a == b).mean()) for k, r in runs.items()
                       if k.startswith("encodings") for a, b in zip(r["saved"], base)]
    ious = np.concatenate([stream_ious(twin, base) for twin in twins])
    gt = [read_png(str(f))[0]
          for f in sorted((FIXTURES / "vos" / "Annotations" / "synth_a").iterdir())]
    checks = {
        "fixtures_match_pillow": not mismatched and len(new) > 0,
        "frames_bit_equal": all(frames_equal.values()),
        "masks_agree": all(len(t) == len(base) == len(frames) for t in twins)
        and min(agree) >= FORMATS_AGREEMENT_MIN,
        "encodings_masks_equal": len(agree_encodings) == 2 * len(frames)
        and min(agree_encodings) == 1.0,
        "iou_bars": bool(iou_ok(ious)),
        "launches": all(r["launches"]["radix_topk_readout"] == len(frames) - 1
                        and r["total_frames"] == len(frames) for r in runs.values()),
        "scripts_data": scripts == expected,
    }
    ok = all(checks.values())
    emit({"phase": "formats", "fixtures": len(new), "mismatched": mismatched,
          "read_ms_480x854": times,
          "runs": {k: {key: v[key]
                       for key in ("launches", "harness_fps", "total_frames", "seconds")}
                   for k, v in runs.items()},
          "frames_bit_equal": frames_equal,
          "agreement_min": min(agree), "agreement_min_encodings": min(agree_encodings),
          "iou_median": float(np.median(ious)),
          "iou_min": float(ious.min()),
          "iou_vs_annotations": {k: {"median": float(np.median(stream_ious(v["saved"], gt))),
                                     "min": float(stream_ious(v["saved"], gt).min())}
                                 for k, v in runs.items()},
          "scripts_data": scripts_ok, "scripts_data_seconds": scripts_seconds,
          "checks": checks, "nvidia_smi": nvidia_smi_line(), "ok": ok,
          "seconds": time.perf_counter() - t0})
    if not ok:
        raise RuntimeError("formats phase failed")
    return {k: sum(r["launches"][k] for r in runs.values())
            for k in ("radix_topk_readout", "fused_topk_readout")}


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


# ------------------------------------------------------------------ training

TRAIN_OUT_KEYS = ("logits", "logits_low", "sensory_logits", "q_logits")
# card against CPU (the training step's fp32 path, TF32 off): each output
# within 1e-3 of its largest value; each parameter's gradient within 3e-2
# of its norm (tests/test_torch_training.py's bar against cutie_tpu), a
# norm below 1e-6 of the largest counted at that floor
TRAIN_OUT_RTOL, TRAIN_GRAD_RTOL = 1e-3, 3e-2


def train_batch(t, size, num_objects, batch, device):
    """A training batch made in memory: the synthetic video drawn at
    size x size (numpy seeds 9, 10, ...; every second sequence runs
    backwards), its class maps with objects 1..num_objects as classes, the
    first frame's one-hot and an all-ones selector, on `device`."""
    frames, cls = [], []
    for bi in range(batch):
        f, _ = synth_frames_480(t, size, size, seed=9 + bi)
        m = synth_gt_masks_480(t, size, size)
        c = np.where(m <= num_objects, m, 0).astype(np.uint8)
        if bi % 2:
            f, c = f[::-1], c[::-1]
        frames.append(f)
        cls.append(c)
    cls = np.stack(cls)
    first = cls[:, 0, None] == np.arange(1, num_objects + 1)[None, :, None, None]
    data = {"frames": np.stack(frames), "first_frame_gt": first.astype(np.float32),
            "selector": np.ones((batch, num_objects), np.float32), "cls_gt": cls}
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in data.items()}


def train_steps(trainer, data, steps, first_it=0):
    """`steps` do_pass steps, each synchronised, with the same seeded draws
    every step (one fixed objective, so that a lower loss means descent).
    Returns (each step's losses, each step's ms, peak bytes allocated over
    the steps after the first)."""
    losses, ms = [], []
    for i in range(steps):
        if i == 1:
            torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = trainer.do_pass(data, first_it + i, torch.Generator().manual_seed(0))
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t1))
        losses.append({k: v.item() for k, v in out.items()})
    return losses, ms, torch.cuda.max_memory_allocated()


def profiled(fn, wall_ms):
    """fn() under torch.profiler: device time, kernel launches, the ten
    largest kernels, and the busy share against `wall_ms`, fn's unprofiled
    wall time."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    evs = [ev for ev in prof.key_averages()
           if is_device_op(ev) and getattr(ev, "self_device_time_total", 0) > 0]
    kernel_ms = sum(ev.self_device_time_total for ev in evs) / 1e3
    top = sorted(evs, key=lambda ev: -ev.self_device_time_total)[:10]
    return {"kernel_ms": kernel_ms, "device_ops": sum(ev.count for ev in evs),
            "busy_share": kernel_ms / wall_ms if kernel_ms else None,
            "top_kernels": [{"name": ev.key[:100], "count": ev.count,
                             "ms": ev.self_device_time_total / 1e3} for ev in top]}


def profiled_step(trainer, data, it, step_ms):
    """One do_pass under torch.profiler (profiled)."""
    return profiled(lambda: trainer.do_pass(data, it, torch.Generator().manual_seed(0)),
                    step_ms)


def run_stage(name, cfg, stage, model, data, steps, profile=False,
              require_descent=True):
    """Train `model` for `steps` steps of `stage` on `data`: losses, ms a
    step (mean over the steps after the first), sequences and frames a
    second, peak memory; the checks of tests/test_training.py:152-172 (the
    last loss below the first over three steps or more, when
    require_descent)."""
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    trainer = Trainer(cfg, stage, model)
    losses, ms, peak = train_steps(trainer, data, steps)
    b, t = data["frames"].shape[:2]
    step_ms = float(np.mean(ms[1:] or ms))
    keys = set(losses[-1])
    levels = cfg.model.object_transformer.num_blocks + 1
    want = ({"loss_ce", "loss_dice", "aux_sensory_ce", "aux_sensory_dice", "total_loss"}
            | {f"aux_query_{k}_l{level}" for k in ("ce", "dice") for level in range(levels)})
    unchanged = [n for n, p in model.named_parameters() if torch.equal(p, before[n])]
    res = {"stage": name, "batch": b, "frames": t, "size": list(data["frames"].shape[-2:]),
           "objects": int(data["selector"].shape[1]), "amp": bool(stage.amp),
           "remat": bool(stage.remat), "points": stage.train_num_points,
           "ms_per_step": ms, "step_ms_after_first": step_ms,
           "sequences_per_s": b / (step_ms / 1e3), "frames_per_s": b * t / (step_ms / 1e3),
           "peak_allocated_gib": peak / 2 ** 30,
           "total_loss": [x["total_loss"] for x in losses],
           "finite": all(np.isfinite(v) for x in losses for v in x.values()),
           "loss_keys_ok": want <= keys,
           "params_fp32": all(p.dtype == torch.float32 for p in model.parameters()),
           "params_unchanged": unchanged}
    if steps > 2:
        res["last_below_first"] = losses[-1]["total_loss"] < losses[0]["total_loss"]
    if profile:
        res["profiled_step"] = profiled_step(trainer, data, steps, step_ms)
    res["ok"] = (res["finite"] and res["loss_keys_ok"] and res["params_fp32"]
                 and (res.get("last_below_first", True) or not require_descent)
                 and len(unchanged) <= 0.05 * len(before))
    return res, trainer


def main_training_cfg(amp=True):
    cfg = train_config()
    cfg.amp = amp
    stage = cfg.main_training.copy()
    stage.batch_size = 2
    return cfg, stage


def read_memory_forms(b=2, p=900, t=3, ck=64, cv=256, o=3):
    """The training read's similarity, softmax and readout at main-training
    shapes (B=2, 30x30 queries, 3 memory frames) in the direct form (the
    port's get_similarity, the read's form before the expanded one) and the
    expanded form: bytes autograd keeps for the backward, peak bytes, and
    the forward and backward's ms."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    mk = torch.randn(b, t * p, ck, device=dev, generator=g).requires_grad_()
    qk = torch.randn(b, p, ck, device=dev, generator=g).requires_grad_()
    qe = torch.rand(b, p, ck, device=dev, generator=g).requires_grad_()
    ms = (1 + torch.rand(b, t * p, device=dev, generator=g)).requires_grad_()
    mv = torch.randn(b, o, t * p, cv, device=dev, generator=g).requires_grad_()
    res = {}
    for name, form in (("direct", get_similarity), ("expanded", get_similarity_expanded)):
        def run():
            return readout(softmax_affinity(form(mk, ms, qk, qe)), mv)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = run()
        torch.cuda.synchronize()
        kept = torch.cuda.memory_allocated() - base - out.numel() * 4
        peak = torch.cuda.max_memory_allocated() - base
        del out
        res[name] = {"saved_for_backward_mib": kept / 2 ** 20,
                     "peak_mib": peak / 2 ** 20,
                     "fwd_bwd_ms": cuda_time_ms(lambda: run().sum().backward(),
                                                iters=3, warmup=1)}
    return res


def grads_of_train_forward(model, data, stage, weights):
    """train_forward's outputs and every parameter's gradient of the linear
    functional sum(weights[k] * out[k]), on the CPU."""
    model.zero_grad(set_to_none=True)
    out = train_forward(model, data, torch.Generator().manual_seed(0), stage)
    sum((out[k] * weights[k].to(out[k].device)).sum() for k in TRAIN_OUT_KEYS).backward()
    return ({k: v.detach().cpu() for k, v in out.items()},
            {n: p.grad.detach().cpu() for n, p in model.named_parameters()})


def card_against_cpu():
    """The fp32 training step (TF32 off) on the card and on the CPU in this
    process: cutie-base width, batch 1, T=3, 192x192, 2 objects,
    num_ref_frames 2, deep_update_prob 0 (nothing random on the path)."""
    cfg, stage = main_training_cfg(amp=False)
    stage.merge({"seq_length": 3, "num_ref_frames": 2, "deep_update_prob": 0.0,
                 "remat": False})
    rng = np.random.default_rng(0)
    runs = []
    for device in ("cuda", "cpu"):
        model = build_model(cfg, device=device, state_dict=trained_weights())
        data = train_batch(3, 192, 2, 1, device)
        if not runs:
            with torch.no_grad():
                shapes = {k: v.shape for k, v in train_forward(
                    model, data, torch.Generator(), stage).items()}
            weights = {k: torch.from_numpy(rng.normal(size=shapes[k]).astype(np.float32))
                       for k in TRAIN_OUT_KEYS}
        runs.append(grads_of_train_forward(model, data, stage, weights))
        del model
    (out_c, g_c), (out_h, g_h) = runs
    out_err = {k: float((out_c[k] - out_h[k]).abs().max() / out_h[k].abs().max())
               for k in TRAIN_OUT_KEYS}
    floor = 1e-6 * max(float(v.norm()) for v in g_h.values())
    grad_err = {n: float((g_c[n] - g_h[n]).norm()) / max(float(g_h[n].norm()), floor)
                for n in g_h}
    worst = sorted(grad_err.items(), key=lambda kv: -kv[1])[:5]
    return {"output_rel_err": out_err, "grad_rel_err_max": worst[0][1],
            "grad_rel_err_worst": worst,
            "grad_rel_err_median": float(np.median(list(grad_err.values()))),
            "ok": (max(out_err.values()) <= TRAIN_OUT_RTOL
                   and worst[0][1] <= TRAIN_GRAD_RTOL)}


def phase_train():
    """The training step on the card, cutie-base from the trained test
    weights. Pre-training: a single-object model (the weights through the
    object surgery), batch 2, T=3, 384x384, 8,192 points, fp32, remat,
    three steps, then two without remat. The hand-off: through the surgery
    into a multi-object model, loaded strictly; main training from there at
    full width (batch 2, T=8, 480x480, 3 objects, 12,544 points, amp,
    remat) for six steps, one of them profiled, then two without remat.
    Main training straight from the trained weights: six steps, whose loss
    rises after the first (AdamW's first step moves every parameter by
    about the LR, and these weights already fit the synthetic task), so
    their descent is reported, not required. Then the fp32 step on the card
    against the CPU, and the training read's two similarity forms."""
    t0 = time.perf_counter()
    read_kernel.radix_topk_readout.launches = 0
    read_kernel.fused_topk_readout.launches = 0
    dev = torch.device("cuda")
    res = {}

    pcfg = train_config()
    pcfg.amp = False
    pre = pcfg.pre_training.copy()
    pre.batch_size = 2
    pdata = train_batch(pre.seq_length, pre.crop_size[0], pre.num_objects, 2, dev)
    single = apply_object_surgery(trained_weights(), True, pcfg.model.sensory_dim,
                                  pcfg.model.value_dim)
    model = build_model(pcfg, device="cuda", state_dict=single, single_object=True)
    res["pre"], trainer = run_stage("pre_training", pcfg, pre, model, pdata, 3)
    del trainer
    torch.cuda.empty_cache()
    pre_no_remat = pre.copy()
    pre_no_remat.remat = False
    res["pre_no_remat"], trainer = run_stage("pre_training", pcfg, pre_no_remat, model,
                                             pdata, 2)
    handed = apply_object_surgery(trainer.get_state_dict(), False,
                                  pcfg.model.sensory_dim, pcfg.model.value_dim)
    del trainer, model, pdata
    torch.cuda.empty_cache()

    cfg, stage = main_training_cfg()
    data = train_batch(stage.seq_length, stage.crop_size[0], stage.num_objects, 2, dev)
    model = build_model(cfg, device="cuda", state_dict=handed)
    dtypes = amp_stage_dtypes(model, data["frames"][0, 0].cpu().numpy(), grad=True)
    res["main"], trainer = run_stage("main_training after the hand-off", cfg, stage,
                                     model, data, 6, profile=True)
    res["main"]["stage_dtypes_with_grad_ok"] = dtypes == AMP_STAGE_DTYPES
    res["main"]["ok"] &= dtypes == AMP_STAGE_DTYPES
    del trainer
    torch.cuda.empty_cache()
    no_remat = stage.copy()
    no_remat.remat = False
    res["main_no_remat"], trainer = run_stage("main_training", cfg, no_remat, model,
                                              data, 2)
    del trainer, model
    torch.cuda.empty_cache()
    model = build_model(cfg, device="cuda", state_dict=trained_weights())
    res["main_from_trained"], trainer = run_stage(
        "main_training from the trained weights", cfg, stage, model, data, 6,
        require_descent=False)
    del trainer, model, data
    torch.cuda.empty_cache()

    res["card_vs_cpu"] = card_against_cpu()
    res["read_memory_forms"] = read_memory_forms()
    launches = {"radix_topk_readout": read_kernel.radix_topk_readout.launches,
                "fused_topk_readout": read_kernel.fused_topk_readout.launches}
    ok = all(res[k]["ok"] for k in ("pre", "pre_no_remat", "main", "main_no_remat",
                                    "main_from_trained", "card_vs_cpu"))
    emit({"phase": "train", **res, "launches": launches, "ok": ok,
          "seconds": time.perf_counter() - t0})
    if not ok:
        raise RuntimeError("train phase failed")
    return launches, res["main"]["step_ms_after_first"]


# ------------------------------------------------------------------ train entry

def fixture_train_cfg():
    """train_config() (cutie-base, the stages at their widths) over the
    committed fixtures: the static images for pre-training, the three VOS
    videos (36 frames, 480x854 JPEG) for main training. Each stage at batch
    2 (pre-training 3 steps, main training 4); main training's curriculum
    switches max_skip from 5 to 10 at half way, which rebuilds the loader;
    a checkpoint every 3 steps, image grids every 2."""
    cfg = train_config()
    cfg.merge({
        "log_text_interval": 2, "log_image_interval": 2,
        "save_weights_interval": 1000, "save_checkpoint_interval": 3,
        "data": {
            "image_datasets": {"base": str(FIXTURES),
                               "FIXTURE": {"directory": "static", "data_structure": 1,
                                           "multiplier": 1}},
            "vos_datasets": {"base": str(FIXTURES / "vos"),
                             "FIXTURE": {"image_directory": "JPEGImages",
                                         "mask_directory": "Annotations",
                                         "multiplier": 1, "frame_interval": 1,
                                         "subset": None, "empty_masks": None}},
            "pre_training": {"datasets": ["FIXTURE"]},
            "main_training": {"datasets": ["FIXTURE"]},
        }})
    cfg.pre_training.merge({"batch_size": 2, "num_iterations": 3})
    cfg.main_training.merge({"batch_size": 2, "num_iterations": 4,
                             "max_skip_schedule": [5, 10],
                             "max_skip_schedule_fraction": [0.0, 0.5]})
    return cfg


def check_decoder():
    """Every committed JPEG of tests/torch_fixtures/manifest.json, baseline
    and progressive, through the port's decoder: the supported ones hash to
    the SHA-256 of Pillow's decode there, the others raise. Then ms to read one 480x854 frame
    (read_image: the file read and the decode), the mean of 20."""
    manifest = {rel: entry for rel, entry in json.loads(
        (FIXTURES / "manifest.json").read_text()).items() if rel.endswith(".jpg")}
    mismatched, refused = [], []
    for rel, entry in sorted(manifest.items()):
        data = (FIXTURES / rel).read_bytes()
        if not entry["supported"]:
            try:
                decode_jpeg(data, rel)
                mismatched.append(f"{rel}: decoded, should raise")
            except ValueError as e:
                refused.append(str(e))
            continue
        pixels = decode_jpeg(data, rel)
        if (list(pixels.shape) != entry["shape"]
                or hashlib.sha256(pixels.tobytes()).hexdigest() != entry["sha256"]):
            mismatched.append(rel)
    frame = str(FIXTURES / "vos" / "JPEGImages" / "synth_a" / "00000.jpg")
    read_image(frame)
    t1 = time.perf_counter()
    for _ in range(20):
        read_image(frame)
    return {"files": len(manifest), "mismatched": mismatched, "refused": refused,
            "read_ms_480x854": 1e3 * (time.perf_counter() - t1) / 20,
            "ok": not mismatched and len(refused) == sum(
                not e["supported"] for e in manifest.values())}


def loader_alone(cfg, n_batches=2):
    """ShardedLoader over the VOS fixture at main training's real batch
    (16 sequences of T=8, a 480x480 crop, 3 objects, merge_probability
    0.5, cfg.num_workers threads), no training: n_batches batches, from a
    cold start, and the frames a second they give."""
    stage = cfg.main_training.copy()
    stage.batch_size = 16
    loader = setup_main_training_datasets(cfg, stage, stage.max_skip_schedule[0])[1]
    t0 = time.perf_counter()
    stamps, frames = [], 0
    batches = loader.epoch(0)
    try:
        for batch in batches:
            stamps.append(time.perf_counter() - t0)
            shape = list(batch["frames"].shape)
            frames += shape[0] * shape[1]
            if len(stamps) == n_batches:
                break
    finally:
        batches.close()
    if len(stamps) < n_batches:
        raise RuntimeError(f"the loader gave {len(stamps)} batches, not {n_batches}")
    return {"batch_shape": shape, "num_workers": cfg.num_workers,
            "cpu_count": os.cpu_count(), "batches": len(stamps),
            "batch_ready_s": stamps, "frames_per_s": frames / stamps[-1]}


def stage_summary(trace):
    """A run_stage trace: each step's it, epoch, max_skip, ms and loader
    wait; the means over the steps after the first; the losses."""
    later = trace[1:] or trace
    losses = [r["losses"]["total_loss"] for r in trace]
    return {"its": [r["it"] for r in trace], "epochs": [r["epoch"] for r in trace],
            "max_skip": [r["max_skip"] for r in trace],
            "step_ms": [r["step_ms"] for r in trace],
            "wait_ms": [r["wait_ms"] for r in trace],
            "step_ms_after_first": float(np.mean([r["step_ms"] for r in later])),
            "wait_ms_after_first": float(np.mean([r["wait_ms"] for r in later])),
            "total_loss": losses,
            "finite": all(np.isfinite(v) for r in trace for v in r["losses"].values())}


def phase_train_entry(in_memory_step_ms=None):
    """The two-stage train entry (cutie_tpu_torch/train.py:run_stage) on the
    committed JPEG/PNG fixtures, cutie-base from the trained test weights:
    the decoder against Pillow's hashes; the loader alone at main
    training's batch of 16; pre-training (single-object model, 384x384,
    T=3, batch 2, 3 steps), the hand-off, main training (480x480, T=8,
    batch 2, amp, remat, 4 steps, the loader rebuilt by the curriculum at
    step 2), and a resume from the checkpoint written at step 3, which
    must continue at it 3, epoch 3 // batches_per_epoch and max_skip 10, as
    cutie_tpu's run_stage computes them. ms a step with the loader feeding
    it, beside in_memory_step_ms (phase train's main-training step in this
    call), and the loader's wait a step."""
    t0 = time.perf_counter()
    read_kernel.radix_topk_readout.launches = 0
    read_kernel.fused_topk_readout.launches = 0
    cfg = fixture_train_cfg()
    res = {"decoder": check_decoder(), "loader_alone": loader_alone(cfg)}
    logger = TensorboardLogger(None, enabled=False)
    grids = []
    logger.log_image = lambda tag, img, it: grids.append((tag, it, list(img.shape)))
    sensory, value = cfg.model.sensory_dim, cfg.model.value_dim
    traces = {"pre": [], "main": [], "resume": []}
    with tempfile.TemporaryDirectory() as run_path:
        single = apply_object_surgery(trained_weights(), True, sensory, value)
        sd = train_entry.run_stage(cfg, cfg.pre_training, single, run_path, logger,
                                   trace=traces["pre"])
        handed = apply_object_surgery(sd, False, sensory, value)
        torch.cuda.empty_cache()
        train_entry.run_stage(cfg, cfg.main_training, handed, run_path, logger,
                              trace=traces["main"])
        torch.cuda.empty_cache()
        ckpt = str(Path(run_path) / "checkpoint.pt")
        saved_it = int(torch.load(ckpt, map_location="cpu", weights_only=True)["it"])
        cfg.checkpoint = ckpt
        train_entry.run_stage(cfg, cfg.main_training, handed, run_path, logger,
                              trace=traces["resume"])
        files = sorted(os.listdir(run_path))
    torch.cuda.empty_cache()
    main = cfg.main_training
    per_epoch = setup_main_training_datasets(cfg, main, 5)[1].batches_per_epoch()
    skip_i = max(i for i, f in enumerate(main.max_skip_schedule_fraction)
                 if saved_it >= f * main.num_iterations)
    want_resume = {"its": list(range(saved_it, main.num_iterations)),
                   "epochs": [saved_it // per_epoch] * (main.num_iterations - saved_it),
                   "max_skip": [main.max_skip_schedule[skip_i]] * (main.num_iterations - saved_it)}
    steps = {k: stage_summary(v) for k, v in traces.items()}
    checks = {
        "pre_its": steps["pre"]["its"] == [0, 1, 2],
        "main_curriculum": (steps["main"]["its"], steps["main"]["epochs"],
                            steps["main"]["max_skip"]) == ([0, 1, 2, 3], [0, 0, 1, 1],
                                                           [5, 5, 10, 10]),
        "handoff": handed["mask_encoder.conv1.weight"].shape[1] == 5
        and sd["mask_encoder.conv1.weight"].shape[1] == 4,
        "resume": saved_it == 3 and all(steps["resume"][k] == v
                                        for k, v in want_resume.items()),
        "files": {"weights_pre_training_final.npz", "weights_main_training_final.npz",
                  "checkpoint.pt", "checkpoint_final.pt"} <= set(files),
        "grids": [t for t, _, _ in grids] == ["train/pre_training", "train/main_training",
                                              "train/main_training", "train/main_training"],
        "finite": all(v["finite"] for v in steps.values()),
    }
    launches = {"radix_topk_readout": read_kernel.radix_topk_readout.launches,
                "fused_topk_readout": read_kernel.fused_topk_readout.launches}
    ok = res["decoder"]["ok"] and all(checks.values())
    emit({"phase": "train_entry", **res, "steps": steps, "resume_expected": want_resume,
          "batches_per_epoch": per_epoch, "checks": checks, "files": files,
          "grids": grids, "in_memory_main_step_ms": in_memory_step_ms,
          "main_step_ms_with_loader": steps["main"]["step_ms_after_first"],
          "main_loader_wait_ms": steps["main"]["wait_ms_after_first"],
          "launches": launches, "nvidia_smi": nvidia_smi_line(), "ok": ok,
          "seconds": time.perf_counter() - t0})
    if not ok:
        raise RuntimeError("train_entry phase failed")
    return launches


# ---------------------------------------------------------------- RITM

RITM_WEIGHTS = GOLDEN / "ritm_state_dict.npz"   # random values at the shipped widths
RITM_RTOL, RITM_ATOL = 2e-3, 5e-3   # tests/test_ritm.py:65, the golden forward
# The card's fp32 forward against the CPU's, and DeepLab's: cuDNN (TF32 off)
# and the CPU's kernels sum in other orders; 1e-4 of the logits' largest
# magnitude is ~100 times the fp32 rounding seen in the stream phases.
RITM_CARD_CPU_REL = 1e-4
# The BFS against the vectorised maps: the same fp32 formula, contracted to
# an FMA on the card: relative 1e-6 (an ulp is 6e-8).
DIST_MAPS_RTOL = 1e-6
CLICK_IOU_MIN = 0.99    # NoBRS fp32 masks, card against CPU, every click
CLICKS = 5              # bench.py:144-170: an anchor click, then 5, in two passes


def click_pass(ctrl, image, h, w):
    """bench.py:bench_click_latency's pass: the anchor click at (w/3, h/3),
    then CLICKS clicks 10 px apart, alternately positive and negative; the
    anchor's and each click's wall ms (the probabilities fetched to the
    host), the outputs and, with f-BRS, each click's L-BFGS evaluations and
    the device drive's report (lbfgs_drive's info; None with scipy)."""
    ctrl.unanchor()
    t0 = time.perf_counter()
    outs = [ctrl.interact(image, w // 3, h // 3, True)]
    anchor_ms = (time.perf_counter() - t0) * 1e3
    ms, evals, drive = [], [], []
    for i in range(CLICKS):
        t0 = time.perf_counter()
        outs.append(ctrl.interact(image, w // 3 + 10 * (i + 1), h // 3, i % 2 == 0))
        ms.append((time.perf_counter() - t0) * 1e3)
        functor = getattr(ctrl.controller.predictor, "opt_functor", None)
        evals.append(functor.n_evals if functor is not None else 0)
        drive.append(functor.drive_info if functor is not None else None)
    return anchor_ms, ms, evals, outs, drive


def synchronizing_calls(ctrl, image, h, w):
    """click_pass under torch.cuda.set_sync_debug_mode('warn'): the CUDA
    calls that make the host wait (reads of the device, blocking uploads)
    of each click after the anchor, counted by their warnings."""
    import warnings
    ctrl.unanchor()
    counts = []
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            ctrl.interact(image, w // 3, h // 3, True)
            for i in range(CLICKS):
                seen = len(rec)
                ctrl.interact(image, w // 3 + 10 * (i + 1), h // 3, i % 2 == 0)
                counts.append(len(rec) - seen)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return counts


def mask_iou(a, b):
    a, b = a > 0.5, b > 0.5
    union = np.logical_or(a, b).sum()
    return float(np.logical_and(a, b).sum() / union) if union else 1.0


def ritm_dist_maps():
    """The host C++ BFS (built into _build/) against the torch maps on the
    card, at 480x854 on random whole-pixel clicks (8 positive, 8 negative,
    3 of each padding)."""
    t0 = time.perf_counter()
    dist_maps.library()
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    pts = np.concatenate([rng.integers(0, (480, 854), size=(16, 2)),
                          np.arange(16)[:, None]], 1).astype(np.float32)
    pts[[5, 6, 7, 13, 14, 15]] = -1
    bfs = dist_maps.get_dist_maps_cpu(pts, 480, 854, 5.0)
    card = dist_maps.get_dist_maps(torch.from_numpy(pts)[None].cuda(), 480, 854, 5.0)
    card = card[0].cpu().numpy()
    err = np.abs(bfs - card)
    return {"library": host_build.library_path(dist_maps.SOURCE).name,
            "build_seconds": build_s, "max_abs_err": float(err.max()),
            "max_rel_err": float((err / np.maximum(np.abs(bfs), 1e-30)).max()),
            "ok": bool(np.allclose(card, bfs, rtol=DIST_MAPS_RTOL, atol=0))}


def ritm_forward():
    """HRNet-18/OCR-64 (the shipped checkpoint's configuration,
    tools/gen_golden.py:441-477) loaded strictly from the golden state dict
    by load_is_model on the card: the recorded forward (ritm_stages.npz),
    and the card against the CPU on it and on a 480x854 input with six
    clicks."""
    rec = dict(np.load(GOLDEN / "ritm_stages.npz"))
    rng = np.random.default_rng(1)
    image480 = np.concatenate([synth_frames_480(1)[0][0], rng.random((1, 480, 854))]
                              ).astype(np.float32)[None]
    pts480 = np.full((1, 8, 3), -1.0, np.float32)
    pts480[0, :4] = [[160, 284, 0], [200, 300, 1], [300, 500, 2], [-1, -1, -1]]
    pts480[0, 4:7] = [[100, 700, 3], [400, 100, 4], [50, 50, 5]]
    outs = {}
    for device in ("cuda", "cpu"):
        model = load_is_model(str(RITM_WEIGHTS), device)
        with torch.no_grad():
            outs[device] = [model(torch.from_numpy(x).to(device),
                                  torch.from_numpy(p).to(device))["instances"].cpu().numpy()
                            for x, p in ((rec["image"], rec["points"]), (image480, pts480))]
    golden_err = float(np.abs(outs["cuda"][0] - rec["instances"]).max())
    golden_ok = bool(np.allclose(outs["cuda"][0], rec["instances"],
                                 rtol=RITM_RTOL, atol=RITM_ATOL))
    rel = [float(np.abs(c - p).max() / np.abs(p).max())
           for c, p in zip(outs["cuda"], outs["cpu"])]
    return {"golden_max_abs_err": golden_err, "golden_ok": golden_ok,
            "card_vs_cpu_rel_err": dict(zip(("golden_input", "480x854"), rel)),
            "ok": golden_ok and max(rel) <= RITM_CARD_CPU_REL
            and all(np.isfinite(o).all() for o in outs["cuda"])}


RITM_DRIVER_IOU_MIN = 0.8   # tests/test_ritm.py:377, between cutie_tpu's two drivers


def ritm_clicks():
    """ClickController on the golden weights on the card, on frame 0 of the
    synthetic 480x854 video, with bench.py's two-pass protocol: NoBRS, and
    f-BRS-B with the device drive (the default) and with scipy's L-BFGS on
    the host (host_lbfgs=True), each in fp32 and amp. Per run: the median
    warm click of the second pass, L-BFGS evaluations a click, the
    synchronizing CUDA calls a click (a third pass), a fourth pass under
    torch.profiler, the probabilities' range, the run's seconds; fp32 masks
    against a CPU controller's on the same clicks (NoBRS and the default
    driver); the device drive's masks against the host drive's (IoU >
    RITM_DRIVER_IOU_MIN in fp32), its evaluations (not all 0) and its
    budget (below maxfun before the last line search)."""
    frame = synth_frames_480(1)[0][0]
    h, w = frame.shape[1:]
    runs, ok = {}, True
    for brs_mode, host_lbfgs in (("NoBRS", False), ("f-BRS-B", False), ("f-BRS-B", True)):
        name = brs_mode + (" host" if host_lbfgs else "")
        for amp in (False, True):
            t0 = time.perf_counter()
            ctrl = ClickController(str(RITM_WEIGHTS), brs_mode=brs_mode, amp=amp,
                                   host_lbfgs=host_lbfgs)
            _, first_ms, _, _, _ = click_pass(ctrl, frame, h, w)
            anchor_ms, ms, evals, outs, drive = click_pass(ctrl, frame, h, w)
            valid = all(np.isfinite(o).all() and o.min() >= 0.0 and o.max() <= 1.0
                        and o.shape == (1, 1, h, w) for o in outs)
            run = {"median_warm_click_ms": float(np.median(ms)), "click_ms": ms,
                   "first_pass_click_ms": first_ms, "lbfgs_evals": evals,
                   "probabilities_valid": valid,
                   "synchronizing_calls": synchronizing_calls(ctrl, frame, h, w),
                   "profiled_pass": profiled(lambda: click_pass(ctrl, frame, h, w),
                                             anchor_ms + sum(ms))}
            if brs_mode != "NoBRS":
                pred = ctrl.controller.predictor
                run["driver"] = "scipy fmin_l_bfgs_b" if pred.host_lbfgs else "lbfgs_drive"
            if drive[0] is not None:
                run["drive"] = drive
                run["drive_host_reads"] = [d["host_reads"] for d in drive]
                maxfun = ctrl.controller.predictor.opt_functor.optimizer_params["maxfun"]
                run["within_budget"] = all(
                    e - (d["linesearch_steps"] or [0])[-1] < maxfun
                    for e, d in zip(evals, drive))
                ok &= sum(evals) > 0 and run["within_budget"]
            key = f"{name} {'amp' if amp else 'fp32'}"
            if not amp and not host_lbfgs:
                cpu = ClickController(str(RITM_WEIGHTS), brs_mode=brs_mode, device="cpu")
                cpu_outs = click_pass(cpu, frame, h, w)[3]
                run["card_vs_cpu_mask_iou"] = [mask_iou(a, b)
                                               for a, b in zip(outs, cpu_outs)]
                if brs_mode == "NoBRS":
                    ok &= min(run["card_vs_cpu_mask_iou"]) >= CLICK_IOU_MIN
            if host_lbfgs and not amp:
                ok &= all(e >= 1 for e in evals)
            fp32 = runs.get(f"{name} fp32")
            if amp:
                run["amp_vs_fp32_mask_iou"] = [mask_iou(a, b)
                                               for a, b in zip(outs, fp32["outs"])]
            device = runs.get(f"f-BRS-B {'amp' if amp else 'fp32'}")
            if host_lbfgs:
                iou = [mask_iou(a, b) for a, b in zip(device["outs"], outs)]
                run["device_drive_vs_host_drive_mask_iou"] = iou
                if not amp:
                    ok &= min(iou) > RITM_DRIVER_IOU_MIN
            ok &= valid
            run["outs"] = outs
            run["seconds"] = time.perf_counter() - t0
            runs[key] = run
            del ctrl
            torch.cuda.empty_cache()
    for run in runs.values():
        del run["outs"]
    return {"runs": runs, "ok": bool(ok)}


def ritm_deeplab():
    """DeepLabISModel on seeded random weights (and BN statistics drawn as
    tools/gen_golden.py draws them), card against CPU at 480x854."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = DeepLabISModel().eval()
        g = torch.Generator().manual_seed(1)
        for mod in model.modules():
            if isinstance(mod, FrozenBatchNorm):
                mod.running_mean.copy_(torch.randn(mod.running_mean.shape, generator=g) * 0.05)
                mod.running_var.copy_(0.5 + torch.rand(mod.running_var.shape, generator=g))
    rng = np.random.default_rng(2)
    image = torch.from_numpy(rng.random((1, 4, 480, 854)).astype(np.float32))
    points = torch.tensor([[[200.0, 300, 0], [-1, -1, -1], [100, 600, 0], [-1, -1, -1]]])
    with torch.no_grad():
        cpu = model(image, points)["instances"].numpy()
        model.cuda()
        card = model(image.cuda(), points.cuda())["instances"].cpu().numpy()
    rel = float(np.abs(card - cpu).max() / np.abs(cpu).max())
    return {"card_vs_cpu_rel_err": rel, "logits_max_abs": float(np.abs(cpu).max()),
            "ok": rel <= RITM_CARD_CPU_REL and bool(np.isfinite(card).all())}


def phase_ritm():
    """RITM click segmentation (cutie_tpu_torch/ritm/) on the card: the
    dist-map library, the golden HRNet forward, the click controller's
    latency and L-BFGS evaluations, DeepLab; neither read kernel is
    launched."""
    t0 = time.perf_counter()
    set_fp32_precision()
    read_kernel.radix_topk_readout.launches = 0
    read_kernel.fused_topk_readout.launches = 0
    res = {"dist_maps": ritm_dist_maps(), "forward": ritm_forward(),
           "clicks": ritm_clicks(), "deeplab": ritm_deeplab()}
    launches = {"radix_topk_readout": read_kernel.radix_topk_readout.launches,
                "fused_topk_readout": read_kernel.fused_topk_readout.launches}
    ok = all(r["ok"] for r in res.values()) and not any(launches.values())
    emit({"phase": "ritm", **res, "launches": launches,
          "nvidia_smi": nvidia_smi_line(), "ok": ok,
          "seconds": time.perf_counter() - t0})
    if not ok:
        raise RuntimeError("ritm phase failed")
    return launches


# ------------------------------------------------------------------- the GUI

GUI_PSNR_MIN = 30.0   # dB, a saved visualization JPEG against its image


def record_saves(ctl):
    """Record, for every save_current_mask, its wall time and whether the
    probabilities were finite, and every visualization queued for a frame
    (the images its JPEG may have been written from: two save threads may
    write one frame's file)."""
    log = {"t": [], "finite": [], "vis": {}}
    save_mask, save_vis = ctl.save_current_mask, ctl.res_man.save_visualization

    def save():
        log["t"].append(time.perf_counter())
        log["finite"].append(bool(np.isfinite(ctl.curr_prob).all()))
        save_mask()

    def vis(ti, mode, image):
        log["vis"].setdefault(ti, []).append(image)
        save_vis(ti, mode, image)

    ctl.save_current_mask, ctl.res_man.save_visualization = save, vis
    return log


def propagation_ms(log, first_save):
    """Wall ms between the saves of consecutive frames of a propagation,
    from its own first frame's save (index first_save). The drain runs
    FETCH_DEPTH frames behind the steps: the first interval spans
    FETCH_DEPTH + 1 steps, the last FETCH_DEPTH none; warm_ms drops them
    and one more frame at the start."""
    t = log["t"][first_save:]
    return [1e3 * (b - a) for a, b in zip(t, t[1:])]


def warm_ms(frame_ms):
    return float(np.median(frame_ms[2:-FETCH_DEPTH]))


def host_ms_median(fn, iters=5):
    """Median host wall ms of fn() (host work only: nothing on the card)."""
    ms = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        ms.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(ms))


def psnr(a, b):
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    return float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


def gui_replay(root):
    """(a) The 480p golden through the GUI: the stream phase's 12 frames as
    a workspace of PNGs (max_overall_size -1: copied), its first mask
    imported as a palette PNG, on_propagate forward with cutie-base on the
    trained weights at the golden's d17 settings in fp32 (TF32 off), then
    close(); the saved masks, read back, held to the golden; kernel #1
    launched once a frame after the first."""
    rec, frames, mask0 = golden_video("stream480_work_trained.npz")
    t = int(rec["t"])
    write_davis_video(root, frames[:t], mask0)
    model_cfg = eval_config("base")
    model_cfg.merge({"mem_every": 5, "top_k": 30, "stagger_updates": 5,
                     "max_mem_frames": 5, "use_long_term": False,
                     "max_internal_size": -1})
    network = build_model(model_cfg, device="cuda", state_dict=trained_weights())
    cfg = Config({"images": str(root / "JPEGImages" / "video1"), "video": None,
                  "workspace": str(root / "ws_replay"), "num_objects": 3,
                  "max_overall_size": -1, "max_internal_size": -1, "mem_every": 5,
                  "use_long_term": False, "buffer_size": 20, "save_queue_size": 20,
                  "num_save_threads": 4})
    ctl = MainController(cfg, bundle=(network, model_cfg), click_ckpt=str(RITM_WEIGHTS))
    ctl.import_mask(str(root / "Annotations" / "video1" / "00000.png"))
    log = record_saves(ctl)
    before = read_kernel.radix_topk_readout.launches
    t0 = time.perf_counter()
    ctl.on_propagate("forward")
    propagate_s = time.perf_counter() - t0
    launches = read_kernel.radix_topk_readout.launches - before
    t0 = time.perf_counter()
    ctl.close()
    drain_s = time.perf_counter() - t0
    saved = [read_png(str(root / "ws_replay" / "masks" / f"{ti:05d}.png"))[0]
             for ti in range(t)]
    ious = stream_ious(saved, rec["masks"])
    frame_ms = propagation_ms(log, 0)
    ok = iou_ok(ious) and launches == t - 1 and all(log["finite"])
    return {"frames": t, "launches": launches, "iou_median": float(np.median(ious)),
            "iou_min": float(ious.min()), "propagate_seconds": propagate_s,
            "ms_per_frame": 1e3 * propagate_s / (t - 1), "frame_ms": frame_ms,
            "warm_frame_ms_median": warm_ms(frame_ms),
            "save_drain_seconds": drain_s, "ok": bool(ok)}


def object_point(mask, obj, k=0):
    """A pixel (x, y) of object obj in a mask: the k-th of 8 spread over its
    pixels in raster order."""
    ys, xs = np.nonzero(mask == obj)
    i = (len(ys) * (2 * k + 1)) // 16
    return int(xs[i]), int(ys[i])


def gui_session(root):
    """(b) The GUI's own session at interactive_demo.py's defaults (amp,
    long-term memory, mem_every 5, max_internal_size 480, max_overall_size
    1080) with two objects, on the committed 480x854 JPEG frames of
    tests/torch_fixtures/vos/JPEGImages/synth_a, the model built by the
    controller from the demo's config (cutie-base, the trained weights),
    RITM f-BRS-B on ritm_state_dict.npz: 3 clicks on object 1, 2 on
    object 2, commit, propagate forward, a click on the last frame,
    propagate backward, mem_every 3, binary-mask and video export, close."""
    from cutie_tpu_torch import interactive_demo

    frames_dir = FIXTURES / "vos" / "JPEGImages" / "synth_a"
    gt = read_png(str(FIXTURES / "vos" / "Annotations" / "synth_a" / "00000.png"))[0]
    args = interactive_demo.parse_args(
        ["--images", str(frames_dir), "--workspace", str(root / "ws_session"),
         "--num_objects", "2", "--weights", str(TRAINED_WEIGHTS),
         "--ritm_weights", str(RITM_WEIGHTS)])
    cfg = interactive_demo.gui_config(args)
    t0 = time.perf_counter()
    ctl = MainController(cfg, click_ckpt=args.ritm_weights, device=args.device)
    build_s = time.perf_counter() - t0
    ws = root / "ws_session"
    names = ctl.res_man.names
    log = record_saves(ctl)
    memorized = {"ring": 0, "perm": 0, "consolidated": 0}
    steps = ctl.processor.steps
    memorize, consolidate = steps.memorize, steps.consolidate

    def count_memorize(state, feats, selector, new_mask, *, mode, **kw):
        memorized["perm" if mode == "all" else "ring"] += 1
        return memorize(state, feats, selector, new_mask, mode=mode, **kw)

    def count_consolidate(state, n, lt_keep=None):
        memorized["consolidated"] += n
        return consolidate(state, n, lt_keep)

    steps.memorize, steps.consolidate = count_memorize, count_consolidate
    gauges, click_ms, click_evals = {}, [], []

    def click(x, y, neg=False):
        t1 = time.perf_counter()
        ctl.click(x, y, is_neg=neg)
        click_ms.append(1e3 * (time.perf_counter() - t1))
        pred = ctl.click_ctrl.controller.predictor
        info = pred.opt_functor.drive_info
        click_evals.append({"driver": "scipy fmin_l_bfgs_b" if pred.host_lbfgs
                            else "lbfgs_drive", "lbfgs_evals": pred.opt_functor.n_evals,
                            "exit": info["exit"] if info else None})

    ctl.curr_object = 1
    click(*object_point(gt, 1, 3))
    click(*object_point(gt, 0, 5), neg=True)
    click(*object_point(gt, 1, 6))
    ctl.curr_object = 2
    click(*object_point(gt, 2, 3))
    click(*object_point(gt, 2, 6))
    gauges["clicks"] = ctl.get_memory_gauges()
    ctl.on_commit()
    gauges["commit"] = ctl.get_memory_gauges()
    first = len(log["t"])
    t1 = time.perf_counter()
    ctl.on_propagate("forward")
    forward_s = time.perf_counter() - t1
    forward_ms = propagation_ms(log, first)
    gauges["forward"] = ctl.get_memory_gauges()
    ctl.load_frame(ctl.T - 1)
    click(*object_point(gt, 2, 4))
    first = len(log["t"])
    t1 = time.perf_counter()
    ctl.on_propagate("backward")
    backward_s = time.perf_counter() - t1
    backward_ms = propagation_ms(log, first)
    gauges["backward"] = ctl.get_memory_gauges()
    counted = dict(memorized)
    # a third propagation under the profiler, and the host's work a frame
    profile = profiled(lambda: ctl.on_propagate("forward"), 1e3 * forward_s)
    vis = ctl.visualize()
    host_ms = {
        "visualize_davis": host_ms_median(ctl.visualize),
        "write_png_mask": host_ms_median(
            lambda: write_png(str(root / "m.png"), ctl.curr_mask, davis_palette)),
        "encode_jpeg_q95": host_ms_median(lambda: encode_jpeg(vis, 95)),
        "read_jpeg_frame": host_ms_median(
            lambda: read_image(str(frames_dir / "00000.jpg")))}
    ctl.update_memory_config(mem_every=3)
    mem_every_ok = ctl.processor.mem_every == 3
    t1 = time.perf_counter()
    ctl.close()
    drain_s = time.perf_counter() - t1
    ctl.export_binary_masks([1, 2])
    binary = sorted(os.listdir(ws / "binary_masks"))
    writer = any(importlib.util.find_spec(m) is not None for m in ("av", "cv2"))
    try:
        export = {"written": bool(ctl.export_video())}
    except ImportError as e:
        export = {"import_error": str(e)}
    export_ok = (export.get("written", False) if writer
                 else "PyAV" in export.get("import_error", "")
                 and "cv2" in export["import_error"])

    masks_ok = all((ws / "masks" / f"{n}.png").exists() for n in names)
    vis_psnr = []
    for ti, n in enumerate(names):
        f = ws / "visualization" / "davis" / f"{n}.jpg"
        decoded = read_jpeg(str(f))[0] if f.exists() else None
        vis_psnr.append(max((psnr(decoded, img) for img in log["vis"].get(ti, [])),
                            default=0.0) if decoded is not None else 0.0)
    h, w = ctl.processor.internal_size(ctl.h, ctl.w)
    tokens = -(-h // 16) * -(-w // 16)   # a frame's keys: stride 16, padded
    g = gauges["backward"]
    gauges_ok = (gauges["clicks"]["permanent"] == 0
                 and gauges["commit"]["permanent"] == tokens
                 and g["permanent"] == tokens
                 and g["working"] == counted["ring"] - counted["consolidated"]
                 and 0 < g["working"] <= g["working_max"] == ctl.processor.max_mem_frames
                 and 0 <= g["long_term"] <= g["long_term_max"]
                 and counted["perm"] == 1)
    ok = (all(log["finite"]) and masks_ok and min(vis_psnr) >= GUI_PSNR_MIN
          and gauges_ok and mem_every_ok and export_ok
          and binary == [f"{n}.png" for n in names] and len(click_ms) == 6)
    return {"frames": ctl.T, "size": [ctl.h, ctl.w], "controller_build_seconds": build_s,
            "click_ms": click_ms, "median_warm_click_ms": float(np.median(click_ms[1:])),
            "clicks": click_evals,
            "forward_seconds": forward_s, "forward_frame_ms": forward_ms,
            "forward_ms_per_frame": 1e3 * forward_s / (ctl.T - 1),
            "forward_warm_frame_ms_median": warm_ms(forward_ms),
            "backward_warm_frame_ms_median": warm_ms(backward_ms),
            "backward_seconds": backward_s, "backward_frame_ms": backward_ms,
            "save_drain_seconds": drain_s, "gauges": gauges, "memorized": counted,
            "profiled_forward": profile, "host_ms": host_ms,
            "video_libraries": {m: importlib.util.find_spec(m) is not None
                                for m in ("av", "cv2", "PIL")},
            "consolidations": ctl.processor.consolidations,
            "vis_psnr_min": min(vis_psnr), "masks_saved": masks_ok,
            "probabilities_finite": all(log["finite"]), "mem_every_updated": mem_every_ok,
            "binary_masks": len(binary), "export_video": export, "ok": bool(ok)}


def gui_encoder():
    """(c) The JPEG encoder built here with g++ against the committed
    Pillow and cv2 references (tests/torch_fixtures/jpeg_enc/), byte for
    byte; ms to encode a 480x854 frame at quality 95."""
    enc = FIXTURES / "jpeg_enc"
    manifest = json.loads((enc / "manifest.json").read_text())
    results = {}
    for fname, meta in sorted(manifest["files"].items()):
        src = manifest["sources"][meta["source"]]
        rgb = read_image(str(FIXTURES / src["file"]))
        if src["crop"]:
            (y0, y1), (x0, x1) = src["crop"]
            rgb = np.ascontiguousarray(rgb[y0:y1, x0:x1])
        results[fname] = encode_jpeg(rgb, meta["quality"]) == (enc / fname).read_bytes()
    frame = read_image(str(FIXTURES / "vos" / "JPEGImages" / "synth_a" / "00000.jpg"))
    ms = []
    for _ in range(10):
        t0 = time.perf_counter()
        encode_jpeg(frame, 95)
        ms.append(1e3 * (time.perf_counter() - t0))
    return {"library": host_build.library_path(JPEG_ENCODE_SOURCE).name,
            "byte_equal": results, "encode_480x854_q95_ms_median": float(np.median(ms)),
            "ok": len(results) == 6 and all(results.values())}


def phase_gui(stream):
    """The interactive GUI (cutie_tpu_torch/gui/) on the card: (a) the
    golden replay through MainController, (b) the GUI's own session at the
    demo's defaults, (c) the JPEG encoder against the committed
    references. Kernel #1 runs in (a) and (b)."""
    t0 = time.perf_counter()
    read_kernel.radix_topk_readout.launches = 0
    read_kernel.fused_topk_readout.launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        replay = gui_replay(root)
        session = gui_session(root)
    launches = {"radix_topk_readout": read_kernel.radix_topk_readout.launches,
                "fused_topk_readout": read_kernel.fused_topk_readout.launches}
    encoder = gui_encoder()
    ok = replay["ok"] and session["ok"] and encoder["ok"] and \
        launches["fused_topk_readout"] == 0
    emit({"phase": "gui", "replay": replay, "session": session, "encoder": encoder,
          "stream_phase_frame_ms": stream["frame_ms"],
          "stream_phase_warm_frame_ms_median": float(np.median(stream["frame_ms"][2:])),
          "launches": launches, "nvidia_smi": nvidia_smi_line(), "ok": bool(ok),
          "seconds": time.perf_counter() - t0})
    if not ok:
        raise RuntimeError("gui phase failed")
    return launches


# ----------------------------------------------------------------- render

def phase_render():
    """The software-rendered GUI session
    (cutie_tpu_torch/tools/render_gui_session.py) on the card and on the
    CPU, each into a temporary directory: the reference tool's session (6
    frames of stream_small_work.npz, mem_every 3, a click, the imported
    mask, forward propagation, commit) through MainController, on
    cutie-base with the trained test weights (the small golden weights are
    not in the card's copy); the refresh and panel counts of the card
    against the CPU's, the storyboard read back through image_io.read_png,
    the saved masks of the two runs, and kernel #1 launched in the card's
    propagation."""
    from cutie_tpu_torch.tools import render_gui_session as tool

    t0 = time.perf_counter()
    read_kernel.radix_topk_readout.launches = 0
    read_kernel.fused_topk_readout.launches = 0
    runs, launches = {}, None
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        for device in ("cuda", "cpu"):
            t1 = time.perf_counter()
            runs[device] = tool.main(
                ["--device", device, "--workspace", str(root / device), "--model", "base",
                 "--weights", str(TRAINED_WEIGHTS), "--out", str(root / f"{device}.png")])
            runs[device]["seconds"] = time.perf_counter() - t1
            if launches is None:
                launches = {"radix_topk_readout": read_kernel.radix_topk_readout.launches,
                            "fused_topk_readout": read_kernel.fused_topk_readout.launches}
        board, mode, _ = read_png(runs["cuda"]["out"])
        rows = -(-runs["cuda"]["panels"] // 2)
        board_ok = (mode == "RGB" and board.shape == (
            (tool.WIN_H + 18) * rows + 6, 2 * tool.WIN_W + 12, 3))
        mask_dir = {d: root / d / "workspace" / "masks" for d in runs}
        names = sorted(os.listdir(mask_dir["cuda"]))
        ious = [mask_iou(*(read_png(str(mask_dir[d] / n))[0] for d in ("cuda", "cpu")))
                for n in names]
        same_files = names == sorted(os.listdir(mask_dir["cpu"]))
    counts = {d: {k: r[k] for k in ("refreshes", "panels", "seconds")} for d, r in runs.items()}
    ok = (board_ok and runs["cuda"]["refreshes"] == runs["cpu"]["refreshes"]
          and runs["cuda"]["panels"] == runs["cpu"]["panels"]
          and runs["cuda"]["labels"] == runs["cpu"]["labels"] and same_files
          and len(names) == 6 and launches["radix_topk_readout"] > 0
          and launches["fused_topk_readout"] == 0)
    emit({"phase": "render", "runs": counts, "storyboard_shape": list(board.shape),
          "storyboard_ok": bool(board_ok), "masks_saved": len(names),
          "saved_mask_iou_card_vs_cpu": ious, "launches": launches, "ok": bool(ok),
          "seconds": time.perf_counter() - t0})
    if not ok:
        raise RuntimeError("render phase failed")
    return launches


# ------------------------------------------------------------------ multi

# the sharded read against kernel #1 on the same inputs: fp32 values, and
# bf16 values (read as bf16 by both, contracted in fp32)
MULTI_READ_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
MULTI_READ_ITERS = 10
MULTI_TRAIN_STEPS = 3


def composite_sections(case):
    """A read case's three segments (perm | lt | work) as
    sharded_composite_readout's sections (batch row 0) and its queries."""
    bounds = np.cumsum([0] + [v.shape[1] for v in case["values"]])
    secs = [(case["mk"][None, a:b], case["ms"][None, a:b], v[None],
             case["valid"][None, a:b])
            for a, b, v in zip(bounds[:-1], bounds[1:], case["values"])]
    return secs, case["qk"][None], case["qe"][None]


def sharded_case_read(case, mesh, k):
    """The sharded read of a read case on this rank, the long-term segment
    sliced across the mesh (its capacity divides by it): readout [O, P, Cv],
    this rank's long-term usage, the whole working-memory usage."""
    secs, qk, qe = composite_sections(case)
    secs[1] = shard_memory(mesh, *secs[1])
    rd, lt_us, work_us = sharded_composite_readout(*secs, qk, qe, k, mesh,
                                                   lt_sharded=True, return_usage=True)
    return rd[0], lt_us[0], work_us[0]


def multi_reads(cases, mesh, k):
    """Each case's sharded read on this rank, and its ms (host clock over
    MULTI_READ_ITERS synchronised reads, after two)."""
    out = {}
    for name, case in cases.items():
        rd, lt_us, work_us = sharded_case_read(case, mesh, k)
        for _ in range(2):
            sharded_case_read(case, mesh, k)
        torch.cuda.synchronize()
        torch.distributed.barrier()
        t1 = time.perf_counter()
        for _ in range(MULTI_READ_ITERS):
            sharded_case_read(case, mesh, k)
        torch.cuda.synchronize()
        out[name] = {"readout": rd.cpu(), "lt_usage": lt_us.cpu(),
                     "work_usage": work_us.cpu(),
                     "ms": 1e3 * (time.perf_counter() - t1) / MULTI_READ_ITERS}
    return out


def multi_stream(d, k):
    """The long-term golden stream with mem_mesh_devices = d on this rank
    (d = 1: no mesh, the read through kernel #1)."""
    core = base_core(top_k=k, mem_mesh_devices=d, **LT_SETTINGS)
    _, frames, mask0 = golden_video("stream480_lt_trained.npz")
    id_maps, frame_ms, launches, _ = run_stream(core, frames, first_mask_step(mask0),
                                                (480, 854))
    return {"id_maps": np.stack(id_maps), "frame_ms": frame_ms, "launches": launches,
            "consolidations": core.consolidations, "lt_count": core.state.lt_count,
            "lt_slots": int(core.state.lt_key.shape[1]), "lt_capacity": core.lt_capacity}


def params_digest(model):
    h = hashlib.sha256()
    for p in model.parameters():
        h.update(p.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def multi_train(mesh, dev):
    """Main training at full width (T=8, 480x480, 3 objects, amp, remat)
    from the trained weights, global batch 2, this rank's rows: each step's
    losses, ms and parameter digest."""
    cfg, stage = main_training_cfg(amp=True)
    model = build_model(cfg, device=dev, state_dict=trained_weights())
    trainer = Trainer(cfg, stage, model, mesh=mesh)
    data = {key: v.to(dev) for key, v in
            shard_batch(train_batch(8, 480, 3, stage.batch_size, "cpu"), mesh).items()}
    losses, ms, digests = [], [], []
    for it in range(MULTI_TRAIN_STEPS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = trainer.do_pass(data, it, train_entry.step_generator(1, it))
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t1))
        losses.append(float(out["total_loss"]))
        digests.append(params_digest(model))
    return {"losses": losses, "ms_per_step": ms, "digests": digests,
            "rows": int(data["frames"].shape[0])}


def multi_grads(mesh, dev):
    """The fp32 gradient of a fixed random linear functional of
    train_forward's outputs (the mean over the global batch's rows; card
    against CPU's shapes: T=3, 192x192, 2 objects, nothing random on the
    path) averaged across the mesh by the Trainer, and on rank 0 the same
    gradient of one process on the global batch: each parameter's relative
    error, as card_against_cpu measures it."""
    cfg, stage = main_training_cfg(amp=False)
    stage.merge({"seq_length": 3, "num_ref_frames": 2, "deep_update_prob": 0.0,
                 "remat": False, "amp": False})
    data = train_batch(3, 192, 2, 2, "cpu")
    rng = np.random.default_rng(0)
    model = build_model(cfg, device=dev, state_dict=trained_weights())
    with torch.no_grad():
        shapes = {k: v.shape for k, v in train_forward(
            model, {k: v.to(dev) for k, v in data.items()}, torch.Generator(),
            stage).items()}
    weights = {k: torch.from_numpy(rng.normal(size=shapes[k]).astype(np.float32)) / 2
               for k in TRAIN_OUT_KEYS}
    trainer = Trainer(cfg, stage, model, mesh=mesh)
    local = {k: v.to(dev) for k, v in shard_batch(data, mesh).items()}
    w_local = {k: v * mesh.size for k, v in shard_batch(weights, mesh).items()}
    b = local["frames"].shape[0]
    model.zero_grad(set_to_none=False)
    out = train_forward(model, local, torch.Generator().manual_seed(0), stage,
                        rows=(mesh.rank * b, mesh.size * b))
    sum((out[k] * w_local[k].to(dev)).sum() for k in TRAIN_OUT_KEYS).backward()
    trainer.average_gradients()
    if mesh.rank != 0:
        return None
    g_mesh = {n: p.grad.detach().cpu() for n, p in model.named_parameters()}
    one = build_model(cfg, device=dev, state_dict=trained_weights())
    _, g_one = grads_of_train_forward(one, {k: v.to(dev) for k, v in data.items()},
                                      stage, weights)
    floor = 1e-6 * max(float(v.norm()) for v in g_one.values())
    err = {n: float((g_mesh[n] - g_one[n]).norm()) / max(float(g_one[n].norm()), floor)
           for n in g_one}
    worst = sorted(err.items(), key=lambda kv: -kv[1])[:3]
    return {"grad_rel_err_max": worst[0][1], "grad_rel_err_worst": worst,
            "grad_rel_err_median": float(np.median(list(err.values())))}


def multi_rank(inputs_path, k):
    """One rank of the multi phase (a spawned process on cuda:0)."""
    mesh = make_mesh()
    dev = torch.device("cuda", torch.cuda.current_device())
    cases = {name: {key: (tuple(v.to(dev) for v in val) if key == "values"
                          else val.to(dev)) for key, val in case.items()}
             for name, case in torch.load(inputs_path, weights_only=True).items()}
    res = {"world": mesh.size, "rank": mesh.rank, "reads": multi_reads(cases, mesh, k)}
    del cases
    res["stream"] = multi_stream(mesh.size, k)
    res["train"] = multi_train(mesh, dev)
    if mesh.size > 1:
        res["grads"] = multi_grads(mesh, dev)
    return res


def within(a, b, tol):
    """|a - b| <= tol + tol |b| elementwise (numpy.allclose's rule)."""
    return bool(np.allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                            rtol=tol, atol=tol))


def multi_read_checks(res_by_world, cases, k):
    """Each world's sharded reads against kernel #1 on the same inputs."""
    out, ok = {}, True
    for name, case in cases.items():
        args = {key: case[key] for key in ARGS}
        rd_k, us_k, _ = read_kernel.radix_topk_readout_cuda(**args, top_k=k)
        rd_k, us_k = rd_k.cpu().numpy(), us_k.cpu().numpy()
        caps = [v.shape[1] for v in case["values"]]
        tol = MULTI_READ_TOL[str(case["values"][0].dtype).split(".")[-1]]
        kernel_ms = cuda_time_ms(lambda: read_kernel.radix_topk_readout(**args, top_k=k))
        entry = {"tokens": int(case["mk"].shape[0]), "segment_tokens": caps,
                 "queries": int(case["qk"].shape[0]), "tol": tol,
                 "kernel1_ms": kernel_ms}
        for world, ranks_res in res_by_world.items():
            reads = [r["reads"][name] for r in ranks_res]
            rd = reads[0]["readout"].numpy()
            lt_us = np.concatenate([r["lt_usage"].numpy() for r in reads])
            work_us = reads[0]["work_usage"].numpy()
            lt_k = us_k[caps[0]:caps[0] + caps[1]]
            work_k = us_k[caps[0] + caps[1]:]
            same = all(np.array_equal(r["readout"].numpy(), rd) for r in reads)
            w_ok = (same and within(rd, rd_k, tol) and within(lt_us, lt_k, tol)
                    and within(work_us, work_k, tol))
            entry[f"world{world}"] = {
                "ms": reads[0]["ms"], "readout_max_abs_err": float(np.abs(rd - rd_k).max()),
                "readout_rel": float(np.abs(rd - rd_k).max() / np.abs(rd_k).max()),
                "lt_usage_max_abs_err": float(np.abs(lt_us - lt_k).max()),
                "work_usage_max_abs_err": float(np.abs(work_us - work_k).max()),
                "ranks_read_the_same": same, "ok": w_ok}
            ok &= w_ok
        out[name] = entry
    return out, ok


def multi_inputs(lt_case, lvos600):
    """The multi phase's read cases, on the card: the lt_stream phase's
    read inputs with fp32 and with bf16 values, and the kernel phase's
    lvos600 case."""
    def values_as(case, dtype):
        return dict(case, values=tuple(v.to(dtype) for v in case["values"]))

    return {"lt_stream": lt_case, "lt_stream_bf16": values_as(lt_case, torch.bfloat16),
            "lvos600": lvos600}


def phase_multi(lres, lvos600, smi, k=30):
    """The multi-device layer (cutie_tpu_torch/parallel/) on the card: ranks
    spawned with a file:// rendezvous, at world 1 on NCCL and at world 2 on
    gloo with both ranks on cuda:0 (NCCL takes one rank a card): (a) the
    sharded read against kernel #1 on the same inputs; (b) the long-term
    golden stream (world 1: through kernel #1, its launches counted; world 2:
    mem_mesh_devices = 2) against the golden and the lt_stream phase;
    (c) main training at full width, the parameters bit-equal across the
    ranks after every step, and at world 2 the fp32 gradient against one
    process on the global batch."""
    t0 = time.perf_counter()
    cases = {name: {key: case[key] for key in ARGS}
             for name, case in multi_inputs(lres["case"], lvos600).items()}
    res_by_world = {}
    with tempfile.TemporaryDirectory() as tmp:
        inputs = os.path.join(tmp, "inputs.pt")
        torch.save({name: {key: (tuple(v.cpu() for v in val) if key == "values"
                                 else val.cpu()) for key, val in case.items()}
                    for name, case in cases.items()}, inputs)
        for world, backend in ((1, "nccl"), (2, "gloo")):
            res_by_world[world] = spawn_ranks(multi_rank, world, device="cuda:0",
                                              backend=backend, args=(inputs, k),
                                              timeout=600)
    reads, reads_ok = multi_read_checks(res_by_world, cases, k)

    rec = np.load(GOLDEN / "stream480_lt_trained.npz")
    streams, streams_ok = {}, True
    for world, ranks_res in res_by_world.items():
        runs = [r["stream"] for r in ranks_res]
        maps = runs[0]["id_maps"]
        ious = stream_ious(maps, rec["masks"])
        vs_lt = stream_ious(maps, lres["id_maps"])
        entry = {"consolidations": runs[0]["consolidations"],
                 "lt_count": runs[0]["lt_count"], "lt_capacity": runs[0]["lt_capacity"],
                 "lt_slots_by_rank": [r["lt_slots"] for r in runs],
                 "kernel1_launches": [r["launches"]["radix_topk_readout"] for r in runs],
                 "iou_median": float(np.median(ious)), "iou_min": float(ious.min()),
                 "iou_vs_lt_stream_median": float(np.median(vs_lt)),
                 "iou_vs_lt_stream_min": float(vs_lt.min()),
                 "pixel_agreement_vs_lt_stream": float((maps == np.stack(lres["id_maps"])).mean()),
                 "ranks_agree": all(np.array_equal(r["id_maps"], maps) for r in runs),
                 "fps_frames_3_to_26": fps_steady(runs[0]["frame_ms"])}
        entry["ok"] = (iou_ok(ious) and iou_ok(vs_lt) and entry["ranks_agree"]
                       and entry["consolidations"] == lres["consolidations"] >= 1
                       and all(n == entry["lt_capacity"] // world
                               for n in entry["lt_slots_by_rank"])
                       and (world > 1 or entry["kernel1_launches"][0] > 0))
        streams[f"world{world}"] = entry
        streams_ok &= entry["ok"]

    train, train_ok = {}, True
    for world, ranks_res in res_by_world.items():
        runs = [r["train"] for r in ranks_res]
        entry = {"rows_per_rank": runs[0]["rows"], "total_loss": runs[0]["losses"],
                 "ms_per_step": runs[0]["ms_per_step"],
                 "step_ms_after_first": float(np.mean(runs[0]["ms_per_step"][1:])),
                 "params_bit_equal_every_step": all(r["digests"] == runs[0]["digests"]
                                                    for r in runs),
                 "params_moved": len(set(runs[0]["digests"])) == MULTI_TRAIN_STEPS,
                 "finite": all(np.isfinite(r["losses"]).all() for r in runs)}
        ok = entry["params_bit_equal_every_step"] and entry["params_moved"] and entry["finite"]
        if world > 1:
            entry["fp32_grads_vs_one_process"] = ranks_res[0]["grads"]
            ok = ok and ranks_res[0]["grads"]["grad_rel_err_max"] <= TRAIN_GRAD_RTOL
        entry["ok"] = ok
        train[f"world{world}"] = entry
        train_ok &= ok

    launches = res_by_world[1][0]["stream"]["launches"]
    ok = reads_ok and streams_ok and train_ok
    emit({"phase": "multi", "card": smi,
          "worlds": {"1": "NCCL, one rank on cuda:0",
                     "2": "gloo, two ranks on cuda:0 (one card, gloo)"},
          "reads": reads, "streams": streams, "train": train,
          "launches": launches, "ok": ok, "seconds": time.perf_counter() - t0})
    if not ok:
        raise RuntimeError("multi phase failed")
    return launches


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
    by_path["formats"] = phase_formats()
    phase_scripting()
    by_path["train"], in_memory_step_ms = phase_train()
    by_path["train_entry"] = phase_train_entry(in_memory_step_ms)
    by_path["ritm"] = phase_ritm()
    by_path["gui"] = phase_gui(sres)
    by_path["render"] = phase_render()
    kres = phase_kernel(lres["case"])
    fres = phase_fused(sres["case"], kres["cases"]["lvos600"])
    by_path["multi"] = phase_multi(lres, kres["cases"]["lvos600"], smi)
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
