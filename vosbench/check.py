"""How `correct` is decided: frames of the window checked one step at a
time against the plain reference.

Cutie is discontinuous: the object transformer's fg/bg attention mask is an
argmax over objects, so a last-bit difference in a memory readout can flip
one pixel's mask and the two streams part for good (on the card, a sound
run of the program and the reference part within about 20 frames at 480p
with random weights). So the reference cannot replay a whole video beside
the program. It follows the program step by step instead: for each frame
of the sample (SamplePlan, drawn from the seed), the harness keeps the
program's state before and after the frame (port_state) and the frame's
output; after the window the reference takes the state before, steps the
frame, and its output and state after are compared with the program's. A
first frame is stepped from nothing, which checks the start; comparing
the state after each step checks the memory update (memorize, the
working-memory FIFO, consolidation, eviction) that a one-step comparison
of outputs would skip.

A frame with events (vosbench/events) is stepped with them: the state
before it is the program's before its events acted, and the reference
applies the same events to it (a deletion, a mask merged with its own
prediction into a new bucket) before its step. The program's state after
its events and before its step is kept too, outside the frame's time, and
compared with the reference's exactly: a deletion only moves values.

The numbers (compare), each the largest over the kinds of frame (first,
plain, memory, consolidate, and each kind of event) of that kind's median
over its sampled frames, where the kinds with fewer than MIN_GROUP sampled
frames (a video's first frame, an event that comes once or twice a clip)
are pooled into one:
  prob_gap        the mean absolute difference between the two probability
                  maps
  memory_gap      the largest relative difference (max |a - b| / max |b|)
                  over the state after the step: sensory and object
                  memory, the last mask, and every key, shrinkage,
                  selection, value and usage of each bucket's three
                  memories
  state_mismatch  sampled frames after which the counters, the objects,
                  the buckets or the memories' sizes differ (exact: limit 0)
  event_state_mismatch
                  sampled frames with events (after the first) whose
                  state after the events differs in any way (exact: limit
                  0; a number that only cells with events name)
A median leaves out the frames where a last-bit difference flips a pixel's
fg/bg mask (about one frame in ten at 720p, fewer at 480p; one in 168 at
720p with objects added and deleted); taken kind by kind, a fault of one
kind of frame alone (a consolidation's prototypes, a memory frame's
values) moves its kind's median however few such frames the sample holds
beside the others. A median of one or two frames leaves no flip out, so
the rarer kinds are pooled: a fault of every frame of such a kind still
moves the pool's median where those frames are half of it or more. Each limit is in
vosbench/limits/<workload>.json, set from the program's readings and the
control's (see PERF.md).

The control: the same reference with TF32 on for matmuls and convolutions
(precision "tf32"); on a CPU, which has no TF32, the convolution and linear
inputs and every weight are rounded to TF32's 10-bit mantissa instead.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

import numpy as np
import torch

from vosbench.events import Frame, Script
from vosbench.reference.network import CUTIE as RefCUTIE
from vosbench.reference.stream import ReferenceStream
from vosbench.video import Stream, rng_for
from vosbench.weights import load_weights, make_weights


class AttrDict(dict):
    """A config tree with attribute access, as the network reads it."""

    def __getattr__(self, k):
        try:
            v = self[k]
        except KeyError:
            raise AttributeError(k)
        return AttrDict(v) if isinstance(v, dict) else v


# kinds with fewer sampled frames than this are judged as one pool
MIN_GROUP = 3


def build_reference(model_cfg: dict, seed: int, device) -> RefCUTIE:
    """The reference network at model_cfg's widths with the seed's
    weights, in float32 on `device`."""
    with torch.device(device):
        net = RefCUTIE(AttrDict(model=model_cfg, amp=False))
    net = net.to(device).eval()
    load_weights(net, make_weights(net, seed, device))
    return net


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to nearest even at TF32's 10 mantissa bits."""
    u = x.float().contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    u = (u + 0xFFF + ((u >> 13) & 1)) & 0xFFFFE000
    u = torch.where(u >= 1 << 31, u - (1 << 32), u)
    return u.to(torch.int32).view(torch.float32).view(x.shape)


@contextlib.contextmanager
def precision(net: torch.nn.Module, mode: str):
    """Run the reference at `mode`: "fp32" (TF32 off) or "tf32", the
    control. On the card TF32 is cuBLAS's and cuDNN's own; on a CPU it is
    emulated (rounded weights in place, rounded conv and linear inputs)."""
    if mode not in ("fp32", "tf32"):
        raise ValueError(f"unknown precision {mode}")
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    hooks = []
    tf32 = mode == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    if tf32 and next(net.parameters()).device.type == "cpu":
        with torch.no_grad():
            for p in net.parameters():
                p.copy_(_round_tf32(p))
        for m in net.modules():
            if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)):
                hooks.append(m.register_forward_pre_hook(
                    lambda _m, args: (_round_tf32(args[0]),) + tuple(args[1:])))
    try:
        yield
    finally:
        for h in hooks:
            h.remove()
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


class SamplePlan:
    """The frames checked, drawn from the seed before the window: for each
    kind of frame in the traffic's `check.per_kind` ({kind: count}; kinds
    first, plain, memory, consolidate), that many positions of that kind,
    all within the first `check.min_fps` x seconds frames of the window,
    which a run at min_fps or faster reaches; a frame with events is of
    its events' kind (kind_of). Videos cut into clips:
    positions within a clip, applied to the first window clip and to each
    later one inside that reach with probability 1/3, at most
    `check.clips` clips. One continuous video: window frames, and its
    first frame, which is in the warm-up. No position is drawn from the
    traced sub-window (`trace`), so that a traced run checks the frames an
    untraced one does."""

    def __init__(self, traffic: dict, stream: Stream, seed: int,
                 seconds: float, plan: List[dict]):
        chk = traffic["check"]
        self.stream = stream
        self.warmup = int(traffic["warmup_frames"])
        self.clips = int(chk.get("clips", 1))
        self.reach = int(chk["min_fps"] * seconds)
        self.seed = seed
        rng = rng_for(seed, 3)
        if stream.clip_frames is not None:
            lo, hi = 0, min(stream.clip_frames, self.reach)
            plan = plan[stream.warmup:]     # positions of a window video
        else:
            lo, hi = self.warmup, self.warmup + self.reach
        # the traced sub-window, in the plan's own indices
        t0 = lo + int(traffic["trace"]["start_frame"])
        t1 = t0 + int(traffic["trace"]["frames"])
        kinds: Dict[str, List[int]] = {"first": [0]}
        for i in range(max(lo, 1), min(hi, len(plan))):
            if not t0 <= i < t1:
                kinds.setdefault(kind_of(plan[i]), []).append(i)
        self.kinds: Dict[int, str] = {}
        for kind, count in chk["per_kind"].items():
            pool = kinds.get(kind, [])
            n = min(int(count), len(pool))
            self.kinds.update((int(x), kind)
                              for x in rng.choice(pool, n, replace=False))
        self.positions = set(self.kinds)
        self._clip_pick: Dict[int, bool] = {}

    def _clip_checked(self, video: int) -> bool:
        if video not in self._clip_pick:
            picked = sum(self._clip_pick.values())
            inside = (video + 1) * self.stream.clip_frames <= self.reach
            draw = rng_for(self.seed, 4, video).random() < 1 / 3
            self._clip_pick[video] = picked < self.clips and (
                video == 0 or (inside and draw))
        return self._clip_pick[video]

    def wants(self, i: int) -> bool:
        """Check stream frame i?"""
        st = self.stream
        if st.clip_frames is None:
            return i in self.positions
        if i < self.warmup:
            return False
        if st.position(i) not in self.positions:
            return False
        return self._clip_checked(st.video(i))

    def kind(self, i: int) -> str:
        """The kind of a frame that wants(i)."""
        st = self.stream
        return self.kinds[i if st.clip_frames is None else st.position(i)]


def kind_of(entry: dict) -> str:
    """A schedule entry's kind of frame for the check: a memory frame that
    consolidates is of its own kind, and so is a frame with events after
    the first (the name of its events)."""
    if entry["consolidate"]:
        return "consolidate"
    if entry["event"] and entry["kind"] != "first":
        return entry["event"]
    return entry["kind"]


def _keep(x: torch.Tensor) -> torch.Tensor:
    return x.detach().clone()


def port_state(core) -> Optional[dict]:
    """The port's InferenceCore state in ReferenceStream.export's layout
    (copies on the device): counters from curr_ti and last_mem_ti, the
    live objects' ids and per-object tensors, and each bucket's memories
    from cutie_tpu_torch.inference.state.MemoryState's buffers: the live
    objects grouped by the permanent tokens they read (objects first given
    in one frame share them), each bucket's tokens those valid for it, the
    working memory's ring slots oldest first. None before the first frame."""
    st = core.state
    if st is None:
        return None
    ids = core.object_manager.all_obj_ids
    n_obj = len(ids)
    f = st.work_key.shape[1]
    n, lc = st.perm_n, st.lt_count
    perm_valid = st.perm_obj_valid[:n_obj, :n].cpu()
    work_valid = st.work_obj_valid[:n_obj].cpu()
    lt_valid = st.lt_obj_valid[:n_obj, :lc].cpu()
    groups: Dict[bytes, List[int]] = {}
    for s in range(n_obj):
        groups.setdefault(perm_valid[s].numpy().tobytes(), []).append(s)
    dev = st.perm_key.device
    buckets = []
    for slots in groups.values():
        rep = slots[0]
        sl = torch.tensor(slots, device=dev)
        pi = perm_valid[rep].nonzero()[:, 0].to(dev)
        li = lt_valid[rep].nonzero()[:, 0].to(dev)
        ring = [dict(key=_keep(st.work_key[:, s]), shrink=_keep(st.work_shrink[:, s]),
                     value=st.work_value[:, sl, s].float(),
                     sel=_keep(st.work_sel[:, s]), use=st.work_use[:, s].double(),
                     life=st.work_life[:, s].double())
                for s in ((st.work_start + j) % f for j in range(st.work_count))
                if work_valid[rep, s]]
        lt = None
        if len(li):
            lt = dict(key=st.lt_key[:, li], shrink=st.lt_shrink[:, li],
                      value=st.lt_value[:, sl][:, :, li].float(),
                      use=st.lt_use[:, li].double(), life=st.lt_life[:, li].double())
        buckets.append(dict(
            objects=[ids[s] for s in slots],
            perm=dict(key=st.perm_key[:, pi], shrink=st.perm_shrink[:, pi],
                      value=st.perm_value[:, sl][:, :, pi].float()),
            ring=ring, lt=lt))
    return dict(ti=core.curr_ti, last_mem_ti=core.last_mem_ti, objects=list(ids),
                sensory=_keep(st.sensory[:, :n_obj]), obj_v=_keep(st.obj_v[:, :n_obj]),
                last_mask=_keep(st.last_mask[:, :n_obj]), buckets=buckets)


def state_bytes(state) -> int:
    """Device bytes a kept state holds."""
    if torch.is_tensor(state):
        return state.numel() * state.element_size()
    if isinstance(state, dict):
        return sum(state_bytes(v) for v in state.values())
    if isinstance(state, list):
        return sum(state_bytes(v) for v in state)
    return 0


def _shape(state: dict) -> tuple:
    return (state["ti"], state["last_mem_ti"], tuple(state["objects"]),
            tuple((tuple(b["objects"]), b["perm"]["key"].shape[1], len(b["ring"]),
                   0 if b["lt"] is None else b["lt"]["key"].shape[1])
                  for b in state["buckets"]))


def _tensors(state: dict):
    yield "sensory", state["sensory"]
    yield "obj_v", state["obj_v"]
    yield "last_mask", state["last_mask"]
    for j, b in enumerate(state["buckets"]):
        for k, v in b["perm"].items():
            yield f"bucket{j}.perm.{k}", v
        for r, fr in enumerate(b["ring"]):
            for k, v in fr.items():
                yield f"bucket{j}.ring{r}.{k}", v
        if b["lt"] is not None:
            for k, v in b["lt"].items():
                yield f"bucket{j}.lt.{k}", v


def state_gap(prog: dict, ref: dict) -> Optional[float]:
    """The largest relative difference over the tensors of two states of
    one shape; None when their counters or sizes differ."""
    if _shape(prog) != _shape(ref):
        return None
    worst = 0.0
    for (name, a), (_, b) in zip(_tensors(prog), _tensors(ref)):
        if a.shape != b.shape:
            return None
        scale = float(b.double().abs().max()) if b.numel() else 0.0
        diff = float((a.double() - b.double()).abs().max()) if b.numel() else 0.0
        worst = max(worst, diff / scale if scale > 0 else diff)
    return worst


def _clone(x):
    if torch.is_tensor(x):
        return x.clone()
    if isinstance(x, dict):
        return {k: _clone(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_clone(v) for v in x]
    return x


def step_reference(net, core: dict, script: Script, frame: Frame,
                   before: Optional[dict]):
    """The reference's step of one frame, with its events, from the
    program's state before it: (probabilities, state after, state after
    the events and before the step; None for a first frame or a frame
    without events)."""
    ref = ReferenceStream(net, core)
    ref.load(before)
    # cuDNN's own choice of algorithm at some 720p shapes is an FFT
    # convolution that takes seconds a frame; the reference may take any
    # float32 algorithm, so it lets cuDNN time them
    bench = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    try:
        script.reference(ref, frame)
        events = (_clone(ref.export()) if before is not None
                  and script.at(frame.position) else None)
        prob = frame.step(ref)
    finally:
        torch.backends.cudnn.benchmark = bench
    return prob, ref.export(), events


def compare(samples: List[dict], ref_out: Dict[int, tuple]
            ) -> Dict[str, Optional[float]]:
    """The numbers compared (see the module docstring) over the samples
    [{i, kind, prob, after, events}] and the reference's {i: (prob, state
    after, state after the events)}; "kinds" holds each kind's medians and
    count, "samples" each frame's [i, kind, prob gap, memory gap]."""
    gaps: Dict[str, List[float]] = {}
    mems: Dict[str, List[float]] = {}
    mismatch = 0
    events = []
    detail = []
    for s in samples:
        r_prob, r_after, r_events = ref_out[s["i"]]
        if s.get("events") is not None:
            events.append(r_events is None or state_gap(s["events"], r_events) != 0)
        if s["prob"].shape != r_prob.shape:
            gap = float("inf")
        else:
            gap = float((s["prob"].float() - r_prob.float()).abs().mean())
        gaps.setdefault(s["kind"], []).append(gap)
        g = state_gap(s["after"], r_after)
        if g is None:
            mismatch += 1
        else:
            mems.setdefault(s["kind"], []).append(g)
        detail.append([s["i"], s["kind"], gap, g])
    med = {k: float(np.median(v)) for k, v in gaps.items()}
    mem_med = {k: float(np.median(v)) for k, v in mems.items()}

    def pooled(by_kind):
        pools: Dict[str, List[float]] = {}
        for k, v in by_kind.items():
            pools.setdefault(k if len(gaps[k]) >= MIN_GROUP else "", []).extend(v)
        return [float(np.median(v)) for v in pools.values()]
    return {"prob_gap": max(pooled(gaps)) if gaps else None,
            "memory_gap": max(pooled(mems)) if mems else None,
            "state_mismatch": float(mismatch) if samples else None,
            "event_state_mismatch": float(sum(events)) if events else None,
            "kinds": {k: [med[k], mem_med.get(k), len(gaps[k])] for k in med},
            "samples": detail}


def verdict(readings: Dict[str, Optional[float]], limits: dict):
    """(correct, {name: {value, limit}}) for every number limits.json
    holds; a number with no reading fails."""
    out = {}
    ok = True
    for name, lim in limits["numbers"].items():
        v = readings.get(name)
        out[name] = {"value": v, "limit": lim["limit"]}
        if v is None or not np.isfinite(v) or v > lim["limit"]:
            ok = False
    return ok, out
