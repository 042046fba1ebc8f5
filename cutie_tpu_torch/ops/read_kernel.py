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

import contextlib
import ctypes
from typing import Optional, Sequence, Tuple, Union

import torch

from cutie_tpu_torch.ops.cuda_build import load_library
from cutie_tpu_torch.ops.memory import get_similarity, readout, topk_softmax_radix
from cutie_tpu_torch.utils.tracing import span

SOURCE = "radix_topk_readout.cu"
FUSED_SOURCE = "fused_topk_readout.cu"
MAX_SEGMENTS = 3
# radix_topk_readout takes N up to this many keys (token indices and
# workspace offsets stay far inside their integer types)
MAX_TOKENS = 1 << 24
# radix_topk_readout's workspace of order keys: at most this many bytes,
# 4 per key (N rounded up to 4) and query of a wave
WORKSPACE_BYTES = 1 << 28
# queries a block of the similarity stage takes; waves are multiples of it
QUERY_TILE = 64
# the device type the kernels launch on
KERNEL_DEVICE = "cuda"
# fused_topk_readout takes top_k up to this; its state is O(top_k) pairs a
# query and split of the keys, whatever N is
FUSED_MAX_TOP_K = 4096
# a (query, split) row of its state is the partial stage's buffer of
# (order key, token) pairs: top_k and one step's appends (32 keys), and at
# least FUSED_MIN_LD, so that merges stay rare
FUSED_STEP = 32
FUSED_MIN_LD = 176
# the partial stage's resident blocks an SM, which set its split count
# (fused_topk_readout_geometry); its state stays within FUSED_STATE_BYTES
FUSED_BLOCKS_PER_SM = 2
FUSED_STATE_BYTES = 1 << 26
KEY_TILE = 128
H100_SMS = 132

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


def _library(source: str) -> ctypes.CDLL:
    lib = load_library(source)
    if source not in _BOUND:
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        ip = ctypes.POINTER(ctypes.c_int)
        if source == SOURCE:
            sigs = {"radix_topk_readout_similarity_launch":
                    [vp] * 5 + [i] * 5 + [vp] * 2,
                    "radix_topk_readout_select_launch":
                    [vp, i] + [vp] * 3 + [ll] * 6 + [i] * 9 + [vp] * 4,
                    "radix_topk_readout_occupancy": [i, ip, ip]}
        else:
            sigs = {"fused_topk_readout_partial_launch":
                    [vp] * 5 + [i] * 6 + [vp] * 4,
                    "fused_topk_readout_merge_launch":
                    [vp] * 6 + [i] * 8 + [vp] * 7,
                    "fused_topk_readout_occupancy": [ip, ip]}
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
    _check(mk.device.type == KERNEL_DEVICE, f"unsupported device {mk.device}",
           name)
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


def workspace_ld(n: int) -> int:
    """Keys a workspace row holds: N rounded up to 4 (16-byte rows)."""
    return (n + 3) // 4 * 4


def radix_topk_readout_waves(n: int, p: int,
                             workspace_bytes: int = WORKSPACE_BYTES):
    """The waves of one read, [(first query, queries), ...] in order: the
    workspace holds 4 * workspace_ld(n) bytes a query of a wave and at most
    workspace_bytes, every wave but the last is a multiple of QUERY_TILE,
    and a wave has at least one tile whatever the budget."""
    fit = workspace_bytes // (4 * workspace_ld(n))
    wave = max(QUERY_TILE, fit // QUERY_TILE * QUERY_TILE)
    return [(p0, min(wave, p - p0)) for p0 in range(0, p, wave)]


@contextlib.contextmanager
def _on_device(dev: torch.device):
    """Make dev the CUDA runtime's current device; yields the handle of
    PyTorch's current stream there, on which the kernels launch."""
    with torch.cuda.device(dev):
        yield torch.cuda.current_stream(dev).cuda_stream


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed: cudaError {err}")


def radix_topk_readout_occupancy(bf16: bool = False, device=None) -> dict:
    """Resident blocks per SM of each stage, from
    cudaOccupancyMaxActiveBlocksPerMultiprocessor."""
    sim, sel = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device):
        err = _library(SOURCE).radix_topk_readout_occupancy(
            int(bf16), ctypes.byref(sim), ctypes.byref(sel))
    _raise_on(err, "radix_topk_readout occupancy query")
    return {"similarity": sim.value, "select_readout": sel.value}


def radix_topk_readout_cuda(mk: torch.Tensor, ms: torch.Tensor,
                            valid: torch.Tensor, qk: torch.Tensor,
                            qe: torch.Tensor, values: Values, top_k: int):
    """Launch the kernel on CUDA tensors (arguments as radix_topk_readout)
    and count one launch per read in `radix_topk_readout.launches`, however
    many waves the read takes. Returns (readout, usage, tau [P] fp32), tau
    being each query's k-th largest similarity. Raises on anything the
    kernel does not take. Runs in the span read_kernel.radix_topk_readout
    (utils/tracing.py)."""
    with span("read_kernel.radix_topk_readout"):
        _check_keys("radix_topk_readout", mk, ms, valid, qk, qe, top_k)
        segs = _check_segments(mk, values)
        out, usage, tau = _radix_launch(mk, ms, valid, qk, qe, segs, top_k)
    radix_topk_readout.launches += 1
    return out, usage, tau


def _check_segments(mk, values) -> Tuple[torch.Tensor, ...]:
    """The value segments, checked; an empty segment (the long-term store
    outside long-term mode) holds no key and is left out, which spares the
    kernel a segment."""
    segs = _as_segments(values)
    _check(1 <= len(segs) <= MAX_SEGMENTS, f"1..{MAX_SEGMENTS} value segments")
    o, _, cv = segs[0].shape
    vdt = segs[0].dtype
    _check(vdt in (torch.float32, torch.bfloat16), f"values dtype {vdt}")
    for s in segs:
        _check(s.device == mk.device and s.dtype == vdt and s.is_contiguous()
               and s.dim() == 3 and s.shape[0] == o and s.shape[2] == cv,
               "value segments must be contiguous [O, cap, Cv] tensors of one "
               "dtype on mk's device")
    caps = [int(s.shape[1]) for s in segs]
    _check(sum(caps) == mk.shape[0],
           f"segment caps {caps} must add up to N={mk.shape[0]}")
    return tuple(s for s in segs if s.shape[1])


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t itself if its data is 16-byte aligned (the similarity stage copies
    16 bytes at a time), else an aligned copy."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _radix_launch(mk, ms, valid, qk, qe, segs, top_k,
                  workspace_bytes: Optional[int] = None):
    """Launch csrc/radix_topk_readout.cu on checked arguments: per wave of
    radix_topk_readout_waves, the similarity stage then the select and
    readout stage, on one workspace the waves share. chip_smoke.py also
    runs it with a small workspace_bytes, to hold a read over several waves
    to the same bits as over one. workspace_bytes defaults to
    WORKSPACE_BYTES."""
    run = _RadixRun(mk, ms, valid, qk, qe, segs, top_k,
                    workspace_bytes or WORKSPACE_BYTES)
    with _on_device(mk.device) as stream:
        for wave in run.waves:
            run.similarity(wave, stream)
            run.select_readout(wave, stream)
    return run.out, run.usage, run.tau


class _RadixRun:
    """One read's outputs, workspace and launch arguments."""

    def __init__(self, mk, ms, valid, qk, qe, segs, top_k, workspace_bytes):
        n, self.ck = mk.shape
        p = qk.shape[0]
        o, _, cv = segs[0].shape
        dev = mk.device
        self.keys = (mk, ms, valid, _aligned(qk), _aligned(qe))
        self.waves = radix_topk_readout_waves(n, p, workspace_bytes)
        self.lib = _library(SOURCE)
        self.out = torch.empty((o, p, cv), dtype=torch.float32, device=dev)
        self.usage = torch.zeros((n,), dtype=torch.float32, device=dev)
        self.tau = torch.empty((p,), dtype=torch.float32, device=dev)
        self.workspace = torch.empty((self.waves[0][1] * workspace_ld(n),),
                                     dtype=torch.int32, device=dev)
        caps = [int(s.shape[1]) for s in segs]
        pad = MAX_SEGMENTS - len(segs)
        self.segs = ([s.data_ptr() for s in segs] + [None] * pad
                     + [sum(caps[:i]) for i in range(len(caps))] + [n] * pad
                     + caps + [0] * pad + [len(segs)])
        self.shape = (n, p, o, cv, int(top_k),
                      int(segs[0].dtype == torch.bfloat16))

    def similarity(self, wave, stream):
        n, ck = self.keys[0].shape
        _raise_on(self.lib.radix_topk_readout_similarity_launch(
            *(t.data_ptr() for t in self.keys), n, ck, *wave, workspace_ld(n),
            self.workspace.data_ptr(), stream),
            "radix_topk_readout similarity launch")

    def select_readout(self, wave, stream):
        n, p, o, cv, top_k, bf16 = self.shape
        _raise_on(self.lib.radix_topk_readout_select_launch(
            self.workspace.data_ptr(), workspace_ld(n), *self.segs, n, p,
            *wave, o, cv, top_k,
            bf16, self.out.data_ptr(), self.usage.data_ptr(),
            self.tau.data_ptr(), stream),
            "radix_topk_readout select launch")


def radix_topk_readout_stages(mk, ms, valid, qk, qe, values, top_k):
    """The kernel's two stages as separate callables over one wave of every
    query, for timing each alone: (similarity, select_readout). Run
    similarity first; select_readout reads the workspace it filled (usage
    accumulates over repeated calls). Launches made through them are not
    counted."""
    _check_keys("radix_topk_readout", mk, ms, valid, qk, qe, top_k)
    segs = _check_segments(mk, values)
    p = qk.shape[0]
    budget = 4 * workspace_ld(mk.shape[0]) * -(-p // QUERY_TILE) * QUERY_TILE
    run = _RadixRun(mk, ms, valid, qk, qe, segs, top_k, budget)
    (wave,) = run.waves

    def stage(fn):
        def launch():
            with _on_device(mk.device) as stream:
                fn(wave, stream)
        return launch

    return stage(run.similarity), stage(run.select_readout)


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


def fused_topk_readout_geometry(n: int, p: int, top_k: int,
                                sms: int = H100_SMS):
    """(query_tile, splits, state_bytes) of one streaming read. The partial
    stage runs (query tiles x splits) blocks of QUERY_TILE queries, split s
    taking key tiles s, s + splits, ... of the ceil(n / 128). As many
    splits as one round of resident blocks holds (FUSED_BLOCKS_PER_SM an
    SM): a block more would start a second round as long as the first.
    Every split holds a key tile, and the state holds, for each query and
    split, `fused_state_ld` (order key, token) pairs of 8 bytes and one
    4-byte drop key, at most FUSED_STATE_BYTES: it is sized from p, top_k
    and the split count, which depends on n only while n holds fewer key
    tiles than one round has blocks a query tile."""
    _check(1 <= top_k <= FUSED_MAX_TOP_K,
           f"top_k={top_k} must be in 1..{FUSED_MAX_TOP_K}", "fused_topk_readout")
    _check(n >= 1 and p >= 1, "need at least one key and one query",
           "fused_topk_readout")
    q_tiles = -(-p // QUERY_TILE)
    k_tiles = -(-n // KEY_TILE)
    row = p * (8 * fused_state_ld(top_k) + 4)  # bytes of one split
    round_ = FUSED_BLOCKS_PER_SM * sms // q_tiles
    splits = max(1, min(k_tiles, round_, FUSED_STATE_BYTES // row))
    return QUERY_TILE, splits, splits * row


def _sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def fused_state_ld(top_k: int) -> int:
    """Pairs a (query, split) row of the streaming read's state holds."""
    return max(top_k + FUSED_STEP, FUSED_MIN_LD)


def fused_topk_readout_occupancy(device=None) -> dict:
    """Resident blocks per SM of each stage (the same at every top_k)."""
    part, merge = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device):
        err = _library(FUSED_SOURCE).fused_topk_readout_occupancy(
            ctypes.byref(part), ctypes.byref(merge))
    _raise_on(err, "fused_topk_readout occupancy query")
    return {"partial_topk": part.value, "merge_readout": merge.value}


def fused_topk_readout_cuda(mk: torch.Tensor, ms: torch.Tensor,
                            valid: torch.Tensor, qk: torch.Tensor,
                            qe: torch.Tensor, values: torch.Tensor, top_k: int):
    """Launch the streaming kernel on CUDA tensors (arguments as
    fused_topk_readout): the partial top-k stage, then the merge and
    readout stage, through a state of fused_topk_readout_geometry's size.
    Counts one launch per read in `fused_topk_readout.launches`. Returns
    (readout, usage, tau [P] fp32). Raises on anything the kernel does not
    take."""
    run = _FusedRun(mk, ms, valid, qk, qe, values, top_k)
    with _on_device(mk.device) as stream:
        run.partial(stream)
        run.merge(stream)
    fused_topk_readout.launches += 1
    return run.out, run.usage, run.tau


class _FusedRun:
    """One streaming read's outputs, state and launch arguments."""

    def __init__(self, mk, ms, valid, qk, qe, values, top_k, splits=None):
        name = "fused_topk_readout"
        n, ck, p = _check_keys(name, mk, ms, valid, qk, qe, top_k)
        _check(torch.is_tensor(values) and values.dim() == 3
               and values.shape[1] == n and values.device == mk.device,
               "values must be one [O, N, Cv] tensor on mk's device", name)
        dev = mk.device
        self.splits = splits or fused_topk_readout_geometry(
            n, p, top_k, _sm_count(dev))[1]
        self.ld = fused_state_ld(top_k)
        self.v = values.float().contiguous()
        o, _, cv = self.v.shape
        self.keys = (mk, ms, valid, _aligned(qk), _aligned(qe))
        self.shape = (n, ck, p, o, cv, int(top_k))
        self.lib = _library(FUSED_SOURCE)
        pairs = (p, self.splits, self.ld)
        self.st_keys = torch.empty(pairs, dtype=torch.int32, device=dev)
        self.st_idx = torch.empty(pairs, dtype=torch.int32, device=dev)
        self.st_drop = torch.empty((p, self.splits), dtype=torch.int32, device=dev)
        self.out = torch.empty((o, p, cv), dtype=torch.float32, device=dev)
        self.usage = torch.zeros((n,), dtype=torch.float32, device=dev)
        self.tau = torch.empty((p,), dtype=torch.float32, device=dev)
        self.state = [t.data_ptr() for t in (self.st_keys, self.st_idx, self.st_drop)]

    def partial(self, stream):
        n, ck, p, _, _, top_k = self.shape
        _raise_on(self.lib.fused_topk_readout_partial_launch(
            *(t.data_ptr() for t in self.keys), n, ck, p, top_k, self.splits,
            self.ld, *self.state, stream), "fused_topk_readout partial launch")

    def merge(self, stream):
        _raise_on(self.lib.fused_topk_readout_merge_launch(
            *(t.data_ptr() for t in self.keys), self.v.data_ptr(), *self.shape,
            self.splits, self.ld, *self.state, self.out.data_ptr(),
            self.usage.data_ptr(), self.tau.data_ptr(), stream),
            "fused_topk_readout merge launch")


def fused_topk_readout_stages(mk, ms, valid, qk, qe, values, top_k,
                              splits: Optional[int] = None):
    """The streaming kernel's two stages as separate callables, for timing
    each alone: (partial_topk, merge_readout), with the geometry's split
    count or `splits`. Run partial_topk first; merge_readout reads the state
    it filled (usage accumulates over repeated calls). Launches made through
    them are not counted."""
    run = _FusedRun(mk, ms, valid, qk, qe, values, top_k, splits)

    def stage(fn):
        def launch():
            with _on_device(mk.device) as stream:
                fn(stream)
        return launch

    return stage(run.partial), stage(run.merge)


fused_topk_readout.launches = 0
