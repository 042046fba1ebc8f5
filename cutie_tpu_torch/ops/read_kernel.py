"""The memory read: exact top-k softmax readout, as two hand-written CUDA
kernels for Hopper and as their one plain PyTorch version.

For ONE batch row: similarity -> exact k-th largest value tau per query
(every tie kept) -> w = exp(sim) * [sim >= tau] -> readout sum(w v) / sum(w)
and per-token usage sum_p w / Z_p.

- `radix_topk_readout` replaces the TPU kernel
  cutie_tpu/ops/pallas_kernels.py:radix_topk_readout; it is the read of
  every frame (inference/steps.py). Kernel: csrc/radix_topk_readout.cu.
- `fused_topk_readout` replaces cutie_tpu/ops/pallas_kernels.py:
  fused_topk_readout, the streaming design whose per-query state is O(k).
  As in cutie_tpu it is on no streaming path. Kernel:
  csrc/fused_topk_readout.cu.

Both compute the same function, so both have the same plain version,
`radix_topk_readout_plain`. The kernels are built with nvcc at first use
(ops/cuda_build.py) and called through ctypes. A wrapper launches its
kernel for CUDA tensors and uses the plain version only for CPU tensors; it
never falls back from one to the other.

Layout: radix_topk_readout takes values as one [O, N, Cv] store or a tuple
of per-segment stores [O, cap_s, Cv] (perm | lt | work) whose caps add up
to N; segment s holds the values of keys [cap_0 + ... + cap_{s-1}, ...
+ cap_s). fused_topk_readout takes one [O, N, Cv] store.
"""
from __future__ import annotations

import ctypes
from typing import Sequence, Tuple, Union

import torch

from cutie_tpu_torch.ops.cuda_build import load_library
from cutie_tpu_torch.ops.memory import get_similarity, readout, topk_softmax_radix

SOURCE = "radix_topk_readout.cu"
FUSED_SOURCE = "fused_topk_readout.cu"
MAX_SEGMENTS = 3
# radix_topk_readout takes N up to this many keys (token indices and the
# per-query scratch offsets stay far inside their integer types)
MAX_TOKENS = 1 << 24
# the global-scratch path's workspace: at most this many bytes, 8 per key
# and query of a wave
WORKSPACE_BYTES = 1 << 28
# fused_topk_readout keeps O(top_k) keys a query in shared memory
FUSED_MAX_TOP_K = 4096

Values = Union[torch.Tensor, Sequence[torch.Tensor]]


def _as_segments(values: Values) -> Tuple[torch.Tensor, ...]:
    return tuple(values) if isinstance(values, (tuple, list)) else (values,)


def radix_topk_readout_plain(mk: torch.Tensor, ms: torch.Tensor,
                             valid: torch.Tensor, qk: torch.Tensor,
                             qe: torch.Tensor, values: Values, top_k: int):
    """Plain PyTorch version of both kernels (same arguments and results):
    memory.get_similarity -> memory.topk_softmax_radix (tau as torch.topk's
    k-th value, every tie kept) -> memory.readout, all in fp32."""
    v = torch.cat([s.float() for s in _as_segments(values)], dim=1)
    sim = get_similarity(mk[None], ms[None], qk[None], qe[None],
                         valid=valid[None])
    affinity, usage = topk_softmax_radix(sim, top_k, return_usage=True)
    return readout(affinity, v[None])[0], usage[0]


_BOUND = set()
_MAX_TOKENS = {}  # device index -> radix_topk_readout_max_tokens


def _library(source: str) -> ctypes.CDLL:
    lib = load_library(source)
    if source not in _BOUND:
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        ip = ctypes.POINTER(ctypes.c_int)
        if source == SOURCE:
            sigs = {"radix_topk_readout_launch":
                    [vp] * 8 + [ll] * 6 + [i] * 8 + [vp, i] + [vp] * 4,
                    "radix_topk_readout_max_tokens": [],
                    "radix_topk_readout_occupancy": [i, i, i, ip]}
        else:
            sigs = {"fused_topk_readout_launch": [vp] * 6 + [i] * 6 + [vp] * 4,
                    "fused_topk_readout_occupancy": [i, ip]}
        for name, argtypes in sigs.items():  # every function returns an int
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = ctypes.c_int
        _BOUND.add(source)
    return lib


def _check(cond: bool, msg: str, name: str = "radix_topk_readout") -> None:
    if not cond:
        raise ValueError(f"{name}: {msg}")


def _check_keys(name, mk, ms, valid, qk, qe, top_k):
    """Checks shared by both kernels' wrappers; returns (n, ck, p)."""
    _check(mk.device.type == "cuda", f"unsupported device {mk.device}", name)
    n, ck = mk.shape
    p = qk.shape[0]
    for arg, t, dt in (("mk", mk, torch.float32), ("ms", ms, torch.float32),
                       ("valid", valid, torch.bool), ("qk", qk, torch.float32),
                       ("qe", qe, torch.float32)):
        _check(t.device == mk.device, f"{arg} is on {t.device}, mk on {mk.device}",
               name)
        _check(t.dtype == dt, f"{arg} must be {dt}, got {t.dtype}", name)
        _check(t.is_contiguous(), f"{arg} must be contiguous", name)
    _check(ms.shape == (n,) and valid.shape == (n,), "ms / valid must be [N]", name)
    _check(qk.shape == (p, ck) and qe.shape == (p, ck), "qk / qe must be [P, Ck]",
           name)
    _check(ck % 4 == 0 and ck <= 256, f"Ck={ck} must be a multiple of 4, <= 256",
           name)
    _check(mk.data_ptr() % 16 == 0, "mk must be 16-byte aligned", name)
    _check(top_k >= 1 and p >= 1 and n >= 1,
           "need top_k >= 1, at least one query and at least one key", name)
    _check(n <= MAX_TOKENS, f"N={n} exceeds MAX_TOKENS={MAX_TOKENS}", name)
    return n, ck, p


# ------------------------------------------------------------ kernel #1

def radix_topk_readout(mk: torch.Tensor, ms: torch.Tensor, valid: torch.Tensor,
                       qk: torch.Tensor, qe: torch.Tensor, values: Values,
                       top_k: int):
    """Exact top-k memory read for ONE batch row.

    mk [N, Ck] fp32, ms [N] fp32, valid [N] bool, qk / qe [P, Ck] fp32.
    values: [O, N, Cv] or a tuple of up to three per-segment [O, cap_s, Cv]
    stores, fp32 or bf16 (the amp mode: read as bf16, accumulated in fp32).
    Pad queries with qk=1e6, qe=1: they read out 0 and add nothing to usage.
    Returns (readout [O, P, Cv] fp32, usage [N] fp32).

    CUDA tensors launch the kernel (radix_topk_readout_cuda) for any N up
    to MAX_TOKENS = 2**24 keys; CPU tensors use the plain version."""
    if mk.device.type == "cpu":
        return radix_topk_readout_plain(mk, ms, valid, qk, qe, values, top_k)
    return radix_topk_readout_cuda(mk, ms, valid, qk, qe, values, top_k)[:2]


def radix_topk_readout_max_tokens(device=None) -> int:
    """The largest N whose scratch (8 bytes a key) fits one block's shared
    memory on this card (28,666 on an H100). radix_topk_readout keeps the
    scratch in shared memory up to this N and in a global-memory workspace
    above it: the same kernel body, so the same results."""
    index = None if device is None else torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    if index not in _MAX_TOKENS:
        with torch.cuda.device(index):
            _MAX_TOKENS[index] = int(_library(SOURCE).radix_topk_readout_max_tokens())
    if _MAX_TOKENS[index] < 0:
        raise RuntimeError("radix_topk_readout_max_tokens: CUDA query failed")
    return _MAX_TOKENS[index]


def radix_topk_readout_path(n: int, device=None) -> str:
    """Where the kernel keeps its scratch at N=n: "shared" or "global"."""
    return "shared" if n <= radix_topk_readout_max_tokens(device) else "global"


def radix_topk_readout_wave(n: int, p: int) -> int:
    """Queries per launch of the global-scratch path: the workspace holds
    8n bytes a query and at most WORKSPACE_BYTES."""
    return max(1, min(p, WORKSPACE_BYTES // (8 * n)))


def radix_topk_readout_occupancy(n: int, bf16: bool = False, device=None) -> int:
    """Resident blocks per SM of the path N=n takes, from
    cudaOccupancyMaxActiveBlocksPerMultiprocessor."""
    blocks = ctypes.c_int(0)
    glob = radix_topk_readout_path(n, device) == "global"
    with torch.cuda.device(device):
        err = _library(SOURCE).radix_topk_readout_occupancy(
            n, int(glob), int(bf16), ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"radix_topk_readout occupancy query: cudaError {err}")
    return blocks.value


def radix_topk_readout_cuda(mk: torch.Tensor, ms: torch.Tensor,
                            valid: torch.Tensor, qk: torch.Tensor,
                            qe: torch.Tensor, values: Values, top_k: int):
    """Launch the kernel on CUDA tensors (arguments as radix_topk_readout)
    and count one launch in `radix_topk_readout.launches`. Returns
    (readout, usage, tau [P] fp32), tau being each query's k-th largest
    similarity. Raises on anything the kernel does not take."""
    n, ck, p = _check_keys("radix_topk_readout", mk, ms, valid, qk, qe, top_k)
    segs = _as_segments(values)
    o, _, cv = segs[0].shape
    caps = [int(s.shape[1]) for s in segs]
    dev = mk.device
    _check(1 <= len(segs) <= MAX_SEGMENTS, f"1..{MAX_SEGMENTS} value segments")
    vdt = segs[0].dtype
    _check(vdt in (torch.float32, torch.bfloat16), f"values dtype {vdt}")
    for s in segs:
        _check(s.device == dev and s.dtype == vdt and s.is_contiguous()
               and s.dim() == 3 and s.shape[0] == o and s.shape[2] == cv,
               "value segments must be contiguous [O, cap, Cv] tensors of one "
               "dtype on mk's device")
    _check(sum(caps) == n, f"segment caps {caps} must add up to N={n}")

    # an empty segment (the long-term store outside long-term mode) holds
    # no key; leaving it out spares the kernel a segment test per value read
    segs = tuple(s for s in segs if s.shape[1])
    out, usage, tau = _radix_launch(mk, ms, valid, qk, qe, segs, top_k,
                                    radix_topk_readout_path(n, dev) == "global")
    radix_topk_readout.launches += 1
    return out, usage, tau


def _radix_launch(mk, ms, valid, qk, qe, segs, top_k, global_scratch: bool):
    """Launch csrc/radix_topk_readout.cu on checked arguments, with its
    scratch in shared memory or in a global workspace of waves of
    radix_topk_readout_wave queries. radix_topk_readout_cuda takes the path
    by N; chip_smoke.py also runs the global path below the ceiling, to hold
    the two paths to the same bits."""
    n, ck = mk.shape
    p = qk.shape[0]
    o, _, cv = segs[0].shape
    caps = [int(s.shape[1]) for s in segs]
    dev = mk.device
    lib = _library(SOURCE)
    out = torch.empty((o, p, cv), dtype=torch.float32, device=dev)
    usage = torch.zeros((n,), dtype=torch.float32, device=dev)
    tau = torch.empty((p,), dtype=torch.float32, device=dev)
    scratch, wave = None, 0
    if global_scratch:
        wave = radix_topk_readout_wave(n, p)
        scratch = torch.empty((wave * 2 * n,), dtype=torch.int32, device=dev)
    offs = [sum(caps[:i]) for i in range(len(caps))]
    ptrs = [s.data_ptr() for s in segs] + [None] * (MAX_SEGMENTS - len(segs))
    offs3 = offs + [n] * (MAX_SEGMENTS - len(segs))
    caps3 = caps + [0] * (MAX_SEGMENTS - len(segs))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.radix_topk_readout_launch(
            mk.data_ptr(), ms.data_ptr(), valid.data_ptr(), qk.data_ptr(),
            qe.data_ptr(), *ptrs, *offs3, *caps3, len(segs), n, p, ck, o, cv,
            int(top_k), int(segs[0].dtype == torch.bfloat16),
            None if scratch is None else scratch.data_ptr(), wave,
            out.data_ptr(), usage.data_ptr(), tau.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"radix_topk_readout kernel launch failed: "
                           f"cudaError {err}")
    return out, usage, tau


radix_topk_readout.launches = 0


# ------------------------------------------------------------ kernel #2

def fused_topk_readout(mk: torch.Tensor, ms: torch.Tensor, valid: torch.Tensor,
                       qk: torch.Tensor, qe: torch.Tensor, values: torch.Tensor,
                       top_k: int):
    """The same read as radix_topk_readout by the streaming kernel, whose
    per-query state is O(top_k) whatever N is.

    mk [N, Ck] fp32, ms [N] fp32, valid [N] bool, qk / qe [P, Ck] fp32,
    values [O, N, Cv] (cast to fp32, as the TPU kernel's wrapper does).
    Returns (readout [O, P, Cv] fp32, usage [N] fp32). Any N and P; no
    padding contract.

    CUDA tensors launch the kernel (fused_topk_readout_cuda); CPU tensors
    use the plain version, radix_topk_readout_plain."""
    if mk.device.type == "cpu":
        return radix_topk_readout_plain(mk, ms, valid, qk, qe, values, top_k)
    return fused_topk_readout_cuda(mk, ms, valid, qk, qe, values, top_k)[:2]


def fused_topk_readout_occupancy(top_k: int, device=None) -> int:
    """Resident blocks per SM at this top_k."""
    blocks = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = _library(FUSED_SOURCE).fused_topk_readout_occupancy(
            int(top_k), ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"fused_topk_readout occupancy query: cudaError {err}")
    return blocks.value


def fused_topk_readout_cuda(mk: torch.Tensor, ms: torch.Tensor,
                            valid: torch.Tensor, qk: torch.Tensor,
                            qe: torch.Tensor, values: torch.Tensor, top_k: int):
    """Launch the streaming kernel on CUDA tensors (arguments as
    fused_topk_readout) and count one launch in
    `fused_topk_readout.launches`. Returns (readout, usage, tau [P] fp32).
    Raises on anything the kernel does not take."""
    name = "fused_topk_readout"
    n, ck, p = _check_keys(name, mk, ms, valid, qk, qe, top_k)
    _check(torch.is_tensor(values) and values.dim() == 3
           and values.shape[1] == n and values.device == mk.device,
           "values must be one [O, N, Cv] tensor on mk's device", name)
    _check(top_k <= FUSED_MAX_TOP_K, f"top_k={top_k} > {FUSED_MAX_TOP_K}", name)
    v = values.float().contiguous()
    o, _, cv = v.shape
    dev = mk.device
    lib = _library(FUSED_SOURCE)
    out = torch.empty((o, p, cv), dtype=torch.float32, device=dev)
    usage = torch.zeros((n,), dtype=torch.float32, device=dev)
    tau = torch.empty((p,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fused_topk_readout_launch(
            mk.data_ptr(), ms.data_ptr(), valid.data_ptr(), qk.data_ptr(),
            qe.data_ptr(), v.data_ptr(), n, p, ck, o, cv, int(top_k),
            out.data_ptr(), usage.data_ptr(), tau.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"fused_topk_readout kernel launch failed: "
                           f"cudaError {err}")
    fused_topk_readout.launches += 1
    return out, usage, tau


fused_topk_readout.launches = 0
