"""The memory read: exact top-k softmax readout, as a hand-written CUDA
kernel for Hopper and as its plain PyTorch version.

Replaces the TPU kernel cutie_tpu/ops/pallas_kernels.py:radix_topk_readout
with the same function and the same exactness: for ONE batch row,
similarity -> exact k-th largest value tau per query (every tie kept) ->
w = exp(sim) * [sim >= tau] -> readout sum(w v) / sum(w) and per-token
usage sum_p w / Z_p. The kernel is csrc/radix_topk_readout.cu, built with
nvcc at first use (ops/cuda_build.py) and called through ctypes.

`radix_topk_readout` launches the kernel for CUDA tensors and uses the plain
version only for CPU tensors; it never falls back from one to the other.

Layout: values come as one [O, N, Cv] store or a tuple of per-segment
stores [O, cap_s, Cv] (perm | work) whose caps add up to N; segment s holds
the values of keys [cap_0 + ... + cap_{s-1}, ... + cap_s).
"""
from __future__ import annotations

import ctypes
from typing import Sequence, Tuple, Union

import torch

from cutie_tpu_torch.ops.cuda_build import load_library
from cutie_tpu_torch.ops.memory import get_similarity, readout, topk_softmax_radix

SOURCE = "radix_topk_readout.cu"
MAX_SEGMENTS = 3

Values = Union[torch.Tensor, Sequence[torch.Tensor]]


def _as_segments(values: Values) -> Tuple[torch.Tensor, ...]:
    return tuple(values) if isinstance(values, (tuple, list)) else (values,)


def radix_topk_readout_plain(mk: torch.Tensor, ms: torch.Tensor,
                             valid: torch.Tensor, qk: torch.Tensor,
                             qe: torch.Tensor, values: Values, top_k: int):
    """Plain PyTorch version of the kernel (same arguments and results):
    memory.get_similarity -> memory.topk_softmax_radix (tau as torch.topk's
    k-th value, every tie kept) -> memory.readout, all in fp32."""
    v = torch.cat([s.float() for s in _as_segments(values)], dim=1)
    sim = get_similarity(mk[None], ms[None], qk[None], qe[None],
                         valid=valid[None])
    affinity, usage = topk_softmax_radix(sim, top_k, return_usage=True)
    return readout(affinity, v[None])[0], usage[0]


_MAX_TOKENS = {}


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.radix_topk_readout_launch
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn.argtypes = [vp] * 8 + [ll] * 6 + [i] * 8 + [vp] * 4
    fn.restype = ctypes.c_int
    lib.radix_topk_readout_max_tokens.argtypes = []
    lib.radix_topk_readout_max_tokens.restype = ctypes.c_int


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"radix_topk_readout: {msg}")


def radix_topk_readout(mk: torch.Tensor, ms: torch.Tensor, valid: torch.Tensor,
                       qk: torch.Tensor, qe: torch.Tensor, values: Values,
                       top_k: int):
    """Exact top-k memory read for ONE batch row.

    mk [N, Ck] fp32, ms [N] fp32, valid [N] bool, qk / qe [P, Ck] fp32.
    values: [O, N, Cv] or a tuple of up to three per-segment [O, cap_s, Cv]
    stores, fp32 or bf16 (the amp mode: read as bf16, accumulated in fp32).
    Pad queries with qk=1e6, qe=1: they read out 0 and add nothing to usage.
    Returns (readout [O, P, Cv] fp32, usage [N] fp32).

    CUDA tensors launch the kernel (radix_topk_readout_cuda); CPU tensors
    use the plain version."""
    if mk.device.type == "cpu":
        return radix_topk_readout_plain(mk, ms, valid, qk, qe, values, top_k)
    return radix_topk_readout_cuda(mk, ms, valid, qk, qe, values, top_k)[:2]


def radix_topk_readout_cuda(mk: torch.Tensor, ms: torch.Tensor,
                            valid: torch.Tensor, qk: torch.Tensor,
                            qe: torch.Tensor, values: Values, top_k: int):
    """Launch the kernel on CUDA tensors (arguments as radix_topk_readout)
    and count one launch in `radix_topk_readout.launches`. Returns
    (readout, usage, tau [P] fp32), tau being each query's k-th largest
    similarity. Raises on anything the kernel does not take."""
    _check(mk.device.type == "cuda", f"unsupported device {mk.device}")
    segs = _as_segments(values)
    n, ck = mk.shape
    p = qk.shape[0]
    o, _, cv = segs[0].shape
    caps = [int(s.shape[1]) for s in segs]
    dev = mk.device
    for name, t, dt in (("mk", mk, torch.float32), ("ms", ms, torch.float32),
                        ("valid", valid, torch.bool), ("qk", qk, torch.float32),
                        ("qe", qe, torch.float32)):
        _check(t.device == dev, f"{name} is on {t.device}, mk on {dev}")
        _check(t.dtype == dt, f"{name} must be {dt}, got {t.dtype}")
        _check(t.is_contiguous(), f"{name} must be contiguous")
    _check(ms.shape == (n,) and valid.shape == (n,), "ms / valid must be [N]")
    _check(qk.shape == (p, ck) and qe.shape == (p, ck), "qk / qe must be [P, Ck]")
    _check(ck % 4 == 0 and ck <= 256, f"Ck={ck} must be a multiple of 4, <= 256")
    _check(mk.data_ptr() % 16 == 0, "mk must be 16-byte aligned")
    _check(1 <= len(segs) <= MAX_SEGMENTS, f"1..{MAX_SEGMENTS} value segments")
    _check(top_k >= 1 and p >= 1 and n >= 1,
           "need top_k >= 1, at least one query and at least one key")
    vdt = segs[0].dtype
    _check(vdt in (torch.float32, torch.bfloat16), f"values dtype {vdt}")
    for s in segs:
        _check(s.device == dev and s.dtype == vdt and s.is_contiguous()
               and s.dim() == 3 and s.shape[0] == o and s.shape[2] == cv,
               "value segments must be contiguous [O, cap, Cv] tensors of one "
               "dtype on mk's device")
    _check(sum(caps) == n, f"segment caps {caps} must add up to N={n}")

    lib = load_library(SOURCE)
    if SOURCE not in _MAX_TOKENS:
        _bind(lib)
        with torch.cuda.device(dev):
            _MAX_TOKENS[SOURCE] = lib.radix_topk_readout_max_tokens()
    _check(n <= _MAX_TOKENS[SOURCE],
           f"N={n} exceeds the {_MAX_TOKENS[SOURCE]} keys one block's shared "
           f"memory holds")

    out = torch.empty((o, p, cv), dtype=torch.float32, device=dev)
    usage = torch.zeros((n,), dtype=torch.float32, device=dev)
    tau = torch.empty((p,), dtype=torch.float32, device=dev)
    offs = [sum(caps[:i]) for i in range(len(caps))]
    ptrs = [s.data_ptr() for s in segs] + [None] * (MAX_SEGMENTS - len(segs))
    offs3 = offs + [n] * (MAX_SEGMENTS - len(segs))
    caps3 = caps + [0] * (MAX_SEGMENTS - len(segs))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.radix_topk_readout_launch(
            mk.data_ptr(), ms.data_ptr(), valid.data_ptr(), qk.data_ptr(),
            qe.data_ptr(), *ptrs, *offs3, *caps3, len(segs), n, p, ck, o, cv,
            int(top_k), int(vdt == torch.bfloat16), out.data_ptr(),
            usage.data_ptr(), tau.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"radix_topk_readout kernel launch failed: "
                           f"cudaError {err}")
    radix_topk_readout.launches += 1
    return out, usage, tau


radix_topk_readout.launches = 0
