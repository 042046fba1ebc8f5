"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line with its wall seconds:
  env      the card, the CUDA version and nvidia-smi's name and power limit;
  build    nvcc builds every kernel of the main path into cutie_tpu_torch/_build/;
  kernel   each kernel against its plain PyTorch version on the card, at the
           main path's shapes and on edge cases, and their times;
  stream   the main path: InferenceCore.step of cutie-base on the trained
           test weights, 12 frames of the synthetic 480x854 three-object
           video, held to the recorded reference masks; the kernel must have
           been launched there, and it is held to its plain version again on
           the stream's own read inputs;
  kernels  one line listing every ported kernel.
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
    """Random read inputs in the port's unpadded [perm | work] layout, on
    the card. Keys ~ N(0,1), shrinkage >= 1 (d^2 + 1), selection in (0,1)
    as the model produces them."""
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


def plain_similarity(case):
    return get_similarity(case["mk"][None], case["ms"][None], case["qk"][None],
                          case["qe"][None], valid=case["valid"][None])[0]


def ulps(a, b):
    """Elementwise distance in fp32 ulps (order keys count the floats)."""
    return (_float_order_key(a) - _float_order_key(b)).abs()


def compare(case, k):
    """The kernel against its plain version on every query of the case."""
    args = {key: case[key] for key in ("mk", "ms", "valid", "qk", "qe", "values")}
    rd, us, tau = read_kernel.radix_topk_readout_cuda(**args, top_k=k)
    rd_p, us_p = read_kernel.radix_topk_readout_plain(**args, top_k=k)
    tau_p = topk_threshold(plain_similarity(case), k)[:, 0]
    torch.cuda.synchronize()
    rd_err = float((rd - rd_p).abs().max())
    us_err = float((us - us_p).abs().max())
    rd_scale = max(float(rd_p.abs().max()), 1e-30)
    us_scale = max(float(us_p.abs().max()), 1e-30)
    tau_ulps = int(ulps(tau, tau_p).max())
    res = dict(queries=int(tau.shape[0]), readout_max_abs=rd_err,
               readout_rel=rd_err / rd_scale, usage_max_abs=us_err,
               usage_rel=us_err / us_scale, tau_max_ulps=tau_ulps)
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
    return ok, res, (rd, us)


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
    cuda_build.load_library(read_kernel.SOURCE)
    emit({"phase": "build", "kernels": cuda_build.BUILD_LOG,
          "seconds": time.perf_counter() - t0})


def phase_kernel(k=30):
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
    }
    results, all_ok, max_abs = {}, True, 0.0
    for name, case in cases.items():
        ok, res, _ = compare(case, k)
        res["ok"] = ok
        results[name] = res
        all_ok &= ok
        max_abs = max(max_abs, res["readout_max_abs"])

    case = cases["d17"]
    args = {key: case[key] for key in ("mk", "ms", "valid", "qk", "qe", "values")}
    ms_kernel = cuda_time_ms(lambda: read_kernel.radix_topk_readout(**args, top_k=k))
    ms_plain = cuda_time_ms(lambda: read_kernel.radix_topk_readout_plain(**args, top_k=k))
    emit({"phase": "kernel", "cases": results, "kernel_ms_d17": ms_kernel,
          "plain_ms_d17": ms_plain, "ok": all_ok,
          "seconds": time.perf_counter() - t0})
    if not all_ok:
        raise RuntimeError("kernel disagrees with its plain version")
    return dict(max_abs=max_abs, ms=ms_kernel, plain_ms=ms_plain)


def read_bound_ms(args, usage, k):
    """Least time for one read on these inputs: each input byte read once
    (value rows only where some query kept the token), each output written
    once, against the operations of the similarity over the valid tokens
    (4 fp32 operations per query, token and key channel: a difference, two
    products and a sum; invalid tokens need none) and of the readout, at the
    fp32 peak."""
    mk, ms, valid, qk, qe, values = args
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

    read_kernel.radix_topk_readout.launches = 0
    probs, frame_ms = [], []
    for ti in range(t):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        probs.append(core.step(frames[ti], mask0, objects=[1, 2, 3]) if ti == 0
                     else core.step(frames[ti]))
        torch.cuda.synchronize()
        frame_ms.append(1e3 * (time.perf_counter() - t1))
    fps = (t - 1) / (1e-3 * sum(frame_ms[1:]))
    # frame 2 is the first plain frame: it carries the one-time lazy loading
    # of the CUDA/cuDNN kernels its shapes need
    fps_steady = (t - 2) / (1e-3 * sum(frame_ms[2:]))
    launches = read_kernel.radix_topk_readout.launches

    ious = []
    for ti, prob in enumerate(probs):
        if not (bool(torch.isfinite(prob).all()) and prob.shape == (4, 480, 854)):
            raise RuntimeError(f"frame {ti}: bad output {tuple(prob.shape)}")
        m = core.output_prob_to_mask(prob)
        for obj in (1, 2, 3):
            a, b = m == obj, rec["masks"][ti] == obj
            union = np.logical_or(a, b).sum()
            ious.append(float(np.logical_and(a, b).sum() / union) if union else 1.0)
    ious = np.asarray(ious)

    # the kernel against its plain version on the stream's own read inputs
    # (the next frame's read over the memory the stream built)
    feats = core.steps.encode(torch.from_numpy(frames[-1]).cuda(), pad=core.pad)
    args = core.steps.read_inputs(core.state, feats, rep=0, row=0)
    case = dict(zip(("mk", "ms", "valid", "qk", "qe", "values"), args))
    ok_read, res, (_, usage) = compare(case, k)
    ms_kernel = cuda_time_ms(lambda: read_kernel.radix_topk_readout(*args, top_k=k))
    ms_plain = cuda_time_ms(lambda: read_kernel.radix_topk_readout_plain(*args, top_k=k))
    bound_ms, bound_by = read_bound_ms(args, usage, k)
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

    ok = (launches > 0 and float(np.median(ious)) > IOU_MEDIAN
          and float(ious.min()) > IOU_MIN and ok_read and sim_ok)
    emit({"phase": "stream", "frames": t, "objects": 3, "size": [480, 854],
          "tokens": int(args[0].shape[0]), "queries": int(args[3].shape[0]),
          "read_launches": launches, "fps_frames_2_to_12": fps,
          "fps_frames_3_to_12": fps_steady,
          "frame_ms": frame_ms, "kernel_ms": ms_kernel, "plain_ms": ms_plain,
          "sim_fp32_ulps_vs_fp64_at_kept_tokens": sim_ulps,
          "iou_median": float(np.median(ious)), "iou_min": float(ious.min()),
          "read_on_stream_inputs": dict(res, ok=ok_read),
          "ok": ok, "seconds": time.perf_counter() - t0})
    if not ok:
        raise RuntimeError("stream phase failed")
    return dict(launches=launches, max_abs=res["readout_max_abs"], ms=ms_kernel,
                plain_ms=ms_plain, bound_ms=bound_ms, bound_by=bound_by)


def main():
    smi = phase_env()
    phase_build()
    kres = phase_kernel()
    sres = phase_stream()
    t0 = time.perf_counter()
    emit({"kernels": [{
        "name": "radix_topk_readout", "route": "cuda",
        "source": "cutie_tpu_torch/csrc/radix_topk_readout.cu",
        "replaces": "cutie_tpu/ops/pallas_kernels.py:380",
        "launches": sres["launches"],
        "max_abs_err": max(kres["max_abs"], sres["max_abs"]),
        "ms": sres["ms"], "plain_ms": sres["plain_ms"],
        "bound_ms": sres["bound_ms"], "bound_by": sres["bound_by"],
        "library_ms": None}]})
    emit({"phase": "kernels", "seconds": time.perf_counter() - t0})
    print(smi, flush=True)
    emit({"total_seconds": time.perf_counter() - T_START})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
