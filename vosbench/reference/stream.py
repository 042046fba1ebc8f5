"""Cutie's streaming inference in plain PyTorch: the benchmark's reference.

One ReferenceStream segments one video the way Cutie's InferenceCore does
(reference cutie/inference/inference_core.py, memory_manager.py and
kv_memory_store.py), for the traffic the benchmark sends: a frame may carry
an index mask of some objects, and objects may be deleted before a frame.
Objects first given in one frame form a bucket, and each bucket keeps its
own three memories, as plain tensors with a leading batch axis (2 under
flip_aug):

  - permanent memory: the tokens of the frame that gave its objects;
  - working memory: a FIFO list of the frames memorized since, with each
    frame's selection and usage counters in long-term mode;
  - long-term memory (use_long_term): prototype tokens appended by
    consolidation, with usage counters, evicted by usage when full.

A memorized frame joins every bucket but the one it creates. A frame reads
each bucket's memory for that bucket's objects, and fuses them with the
pixel features and the object memory bucket by bucket, before one decoder
over every object. A mask that brings new objects is merged with the
prediction over the objects there already (the mask's pixels taken from
them), and the frame is memorized; a mask of known objects only replaces
their prediction and is memorized, unsegmented. A deletion drops the
objects' values and per-object tensors, and a bucket left empty with all
its tokens.

The memory read keeps every token whose similarity (Cutie's direct form
in float32, the value the formula has at that precision) is at or above
the k-th largest, takes exp in float32 as Cutie does (so weights underflow
where Cutie's do) and the normalisation and readout in float64; consolidation's full softmax takes the similarity
in float64. The network is the frozen copy in vosbench/reference/network, in
float32 with TF32 off (allow_tf32 on is the benchmark's control).

Departures from Cutie: the merge of a mask with the prediction and its
soft aggregation run on the host in float32, as the first frame's does (Cutie
runs them on the device; both are float32); masks are index masks only.

Nothing here imports the port (cutie_tpu_torch) or JAX.
"""
from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from vosbench.reference.network.resize import (bilinear_resize,
                                               nearest_exact_resize_np)
from vosbench.reference.network.tensor_utils import (aggregate_wbg_np,
                                                     compute_pad)

# queries a block of the read takes: bounds its [P, N] float64 temporaries
READ_QUERY_BLOCK = 512


def similarity64(mk: torch.Tensor, ms: torch.Tensor, qk: torch.Tensor,
                 qe: torch.Tensor) -> torch.Tensor:
    """-sum_c qe_c (mk_c - qk_c)^2 * ms / sqrt(Ck) in float64.

    mk [N, Ck], ms [N], qk / qe [P, Ck] -> [P, N]. The expanded form is
    exact here to float64 rounding (about 1e-13 relative on keys of norm
    ~20), far inside float32's rounding."""
    mk, ms, qk, qe = (t.double() for t in (mk, ms, qk, qe))
    s = (qe @ (mk * mk).T - 2.0 * (qe * qk) @ mk.T
         + (qe * qk * qk).sum(-1, keepdim=True))
    return s * ms[None, :] * (-1.0 / math.sqrt(mk.shape[-1]))


def similarity32(mk: torch.Tensor, ms: torch.Tensor, qk: torch.Tensor,
                 qe: torch.Tensor) -> torch.Tensor:
    """The same similarity in float32 by the direct form, summed over the
    channels in order with every operation rounded on its own: the value
    Cutie's formula has in float32. Elementwise, so a key's value does not
    depend on where it sits. mk [..., M, Ck] and ms [..., M] against
    qk / qe [..., Ck] (one query a leading index) -> [..., M]."""
    s = torch.zeros(mk.shape[:-1], dtype=torch.float32, device=mk.device)
    for c in range(mk.shape[-1]):
        d = mk[..., c] - qk[..., None, c]
        s = s + (qe[..., None, c] * d) * d
    return (s * ms) * (-1.0 / math.sqrt(mk.shape[-1]))


def topk_read(mk: torch.Tensor, ms: torch.Tensor, qk: torch.Tensor,
              qe: torch.Tensor, values: torch.Tensor, top_k: int):
    """Cutie's top-k read of one batch row over its valid tokens.

    mk [N, Ck], ms [N], qk / qe [P, Ck], values [O, N, Cv]. Every token
    whose float32 similarity is at or above the k-th largest is kept (ties
    included); weights exp(sim) in float32 (the similarity is <= 0; Cutie
    subtracts no maximum, so weights underflow as in float32) over their
    sum, in float64. The float64 similarity picks each query's CANDIDATES
    nearest the top; their float32 values decide the threshold, and where
    the candidates are not clear of it by far more than float32's rounding
    the query takes every key. Returns (readout [O, P, Cv] float32, usage
    [N] float64: the sum over queries of each token's affinity)."""
    n = mk.shape[0]
    k = min(top_k, n)
    m = min(n, 2 * k + 32)
    mk32, ms32 = mk.float(), ms.float()
    qk32, qe32 = qk.float(), qe.float()
    v64 = values.double()
    outs = []
    usage = torch.zeros(n, dtype=torch.float64, device=mk.device)
    for p0 in range(0, qk.shape[0], READ_QUERY_BLOCK):
        qb, eb = qk32[p0:p0 + READ_QUERY_BLOCK], qe32[p0:p0 + READ_QUERY_BLOCK]
        s64 = similarity64(mk32, ms32, qb, eb)
        near, idx = torch.topk(s64, m, dim=-1)                   # [p, m]
        s32 = similarity32(mk32[idx], ms32[idx], qb, eb)         # [p, m]
        tau = torch.topk(s32, k, dim=-1).values[:, -1:]
        # candidates outside the first m lie below near[:, -1]; they are
        # clear of tau when that is far below it
        clear = near[:, -1:] < tau.double() - 1e-4 * tau.double().abs() - 1e-30
        if m < n and not bool(clear.all()):
            rows = (~clear[:, 0]).nonzero()[:, 0]
            # those rows take every key (below)
            dense = (rows, similarity32(mk32[None], ms32[None], qb[rows], eb[rows]))
        else:
            dense = None
        keep = s32 >= tau
        # exp in float32, as Cutie takes it (no max subtraction): a query
        # whose kept similarities all lie below about -103 reads out 0
        w = torch.where(keep, torch.exp(s32), torch.zeros_like(s32)).double()
        aff = w / w.sum(-1, keepdim=True).clamp_min(1e-30)        # [p, m]
        out = torch.einsum("pm,opmc->opc", aff, v64[:, idx])      # [O, p, Cv]
        if dense is not None:
            rows, full = dense
            tau_f = torch.topk(full, k, dim=-1).values[:, -1:]
            wf = torch.where(full >= tau_f, torch.exp(full),
                             torch.zeros_like(full)).double()
            aff_f = wf / wf.sum(-1, keepdim=True).clamp_min(1e-30)   # [r, N]
            out[:, rows] = torch.einsum("rn,onc->orc", aff_f, v64)
            aff[rows] = 0.0
            usage += aff_f.sum(0)
        usage.scatter_add_(0, idx.reshape(-1), aff.reshape(-1))
        outs.append(out)
    return torch.cat(outs, dim=1).float(), usage


def _stable_top(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries of each row of x [B, M], equal
    values in index order."""
    return torch.sort(x, dim=1, descending=True, stable=True).indices[:, :k]


def _tokens(x: torch.Tensor) -> torch.Tensor:
    """[B, C, h, w] -> [B, hw, C]."""
    return x.flatten(2).transpose(1, 2)


class ReferenceStream:
    """One video through Cutie's inference, in plain PyTorch.

    network: vosbench.reference.network.CUTIE in eval mode, float32.
    core: the traffic's InferenceCore settings (mem_every, stagger_updates,
    top_k, max_mem_frames, use_long_term, long_term, flip_aug,
    max_internal_size)."""

    def __init__(self, network, core: dict):
        self.net = network
        self.device = next(network.parameters()).device
        self.mem_every = int(core["mem_every"])
        self.top_k = int(core["top_k"])
        self.flip = bool(core.get("flip_aug", False))
        self.max_internal_size = int(core.get("max_internal_size", -1))
        stagger = int(core["stagger_updates"])
        if stagger >= self.mem_every:
            self.stagger_ti = set(range(1, self.mem_every + 1))
        else:
            self.stagger_ti = set(np.round(np.linspace(
                1, self.mem_every, stagger)).astype(int).tolist())
        self.long_term = bool(core["use_long_term"])
        if self.long_term:
            lt = core["long_term"]
            # the first frame is permanent memory, so the ring holds one
            # frame fewer than the budget (memory_manager.py:29-38)
            self.ring_max = int(lt["max_mem_frames"]) - 1
            self.ring_min = int(lt["min_mem_frames"]) - 1
            self.num_prototypes = int(lt["num_prototypes"])
            self.max_long_tokens = int(lt["max_num_tokens"])
            self.buffer_tokens = int(lt["buffer_tokens"])
        else:
            self.ring_max = max(int(core["max_mem_frames"]) - 1, 1)
        self.ti = -1
        self.last_mem_ti = 0
        # object ids in the order of the per-object tensors' axis
        self.objects: List[int] = []
        self.buckets: List[dict] = []
        self.consolidations = 0

    # -------------------------------------------------------------- state

    def load(self, state: Optional[dict]) -> None:
        """Continue from `state` (export's layout; None: a new video)."""
        if state is None:
            return

        def own(d):
            return {k: v.clone() for k, v in d.items()}
        # copies: the read adds into the usage counters in place
        self.ti, self.last_mem_ti = state["ti"], state["last_mem_ti"]
        self.objects = list(state["objects"])
        self.sensory, self.obj_v = state["sensory"].clone(), state["obj_v"].clone()
        self.last_mask = state["last_mask"].clone()
        self.buckets = [dict(objects=list(b["objects"]), perm=own(b["perm"]),
                             ring=[own(f) for f in b["ring"]],
                             lt=own(b["lt"]) if b["lt"] is not None else None)
                        for b in state["buckets"]]

    def export(self) -> dict:
        """The state: counters, object ids, sensory, object memory, last
        mask, and each bucket's objects and its permanent, working (oldest
        first) and long-term memories; in long-term mode a working frame
        also holds its selection and usage."""
        return dict(ti=self.ti, last_mem_ti=self.last_mem_ti,
                    objects=list(self.objects), sensory=self.sensory,
                    obj_v=self.obj_v, last_mask=self.last_mask,
                    buckets=[dict(b, objects=list(b["objects"]), ring=list(b["ring"]))
                             for b in self.buckets])

    # ------------------------------------------------------------ helpers

    def _internal_size(self, h: int, w: int):
        m = self.max_internal_size
        if 0 < m < min(h, w):
            return int(h / min(h, w) * m), int(w / min(h, w) * m)
        return h, w

    def _encode(self, image: torch.Tensor, pad):
        x = F.pad(image[None], pad)
        if self.flip:
            x = torch.cat([x, x.flip(-1)])
        (f16, f8, f4), pix_feat = self.net.encode_image(x)
        key, shrinkage, selection = self.net.transform_key(f16)
        return dict(image=x, ms=(f16, f8, f4), pix_feat=pix_feat, key=key,
                    shrinkage=shrinkage, selection=selection)

    def _set_last_mask(self, prob_no_bg: torch.Tensor) -> None:
        """prob_no_bg [1, O, Hp, Wp]."""
        last = prob_no_bg.float()
        self.last_mask = torch.cat([last, last.flip(-1)]) if self.flip else last

    def _span(self, bucket: dict) -> slice:
        """The bucket's objects on the per-object axis: buckets are made in
        order and their objects appended, so each is one run of it."""
        s0 = self.objects.index(bucket["objects"][0])
        return slice(s0, s0 + len(bucket["objects"]))

    # --------------------------------------------------------------- read

    def _read(self, bucket: dict, feats) -> torch.Tensor:
        """One bucket's pixel readout [B, Ob, Cv, h, w] for its objects; in
        long-term mode the usage counters of its working and long-term
        memories grow."""
        b, ck, h, w = feats["key"].shape
        perm, lt, ring = bucket["perm"], bucket["lt"], bucket["ring"]
        out = []
        for r in range(b):
            keys = [perm["key"][r]]
            shr = [perm["shrink"][r]]
            vals = [perm["value"][r]]
            if lt is not None:
                keys.append(lt["key"][r])
                shr.append(lt["shrink"][r])
                vals.append(lt["value"][r])
            for fr in ring:
                keys.append(fr["key"][r])
                shr.append(fr["shrink"][r])
                vals.append(fr["value"][r])
            qk = _tokens(feats["key"][r:r + 1])[0]
            qe = _tokens(feats["selection"][r:r + 1])[0]
            rd, usage = topk_read(torch.cat(keys), torch.cat(shr), qk, qe,
                                  torch.cat(vals, dim=1), self.top_k)
            out.append(rd)
            if self.long_term:
                n0 = perm["key"].shape[1]
                if lt is not None:
                    nl = lt["key"].shape[1]
                    lt["use"][r] += usage[n0:n0 + nl]
                    lt["life"][r] += 1.0
                    n0 += nl
                hw = h * w
                for i, fr in enumerate(ring):
                    fr["use"][r] += usage[n0 + i * hw:n0 + (i + 1) * hw]
                    fr["life"][r] += 1.0
        rd = torch.stack(out)                                # [B, Ob, P, Cv]
        return rd.transpose(2, 3).reshape(b, rd.shape[1], rd.shape[3], h, w)

    # ------------------------------------------------------------ segment

    def _segment(self, feats, update_sensory: bool) -> torch.Tensor:
        net = self.net
        b = feats["key"].shape[0]
        o = len(self.objects)
        mem_readout = []
        for bucket in self.buckets:
            span = self._span(bucket)
            fused = net.pixel_fusion(feats["pix_feat"], self._read(bucket, feats),
                                     self.sensory[:, span], self.last_mask[:, span])
            ob = span.stop - span.start
            r, _ = net.readout_query(fused, self.obj_v[:, span, None],
                                     selector=torch.ones((b, ob), device=self.device))
            mem_readout.append(r)
        mem_readout = (mem_readout[0] if len(mem_readout) == 1
                       else torch.cat(mem_readout, dim=1))
        selector = torch.ones((b, o), device=self.device)
        sensory, _, prob = net.segment(feats["ms"], mem_readout, self.sensory,
                                       selector=selector,
                                       update_sensory=update_sensory)
        self.sensory = sensory
        if self.flip:
            prob = 0.5 * (prob[0:1] + prob[1:2].flip(-1))
            last = prob[:, 1:]
            self.last_mask = torch.cat([last, last.flip(-1)])
        else:
            self.last_mask = prob[:, 1:]
        return prob

    # ----------------------------------------------------------- memorize

    def _memorize(self, feats) -> None:
        """Every bucket made at this frame takes its tokens as permanent
        memory; every other one as a working-memory frame."""
        value, sensory, summaries = self.net.encode_mask(
            feats["image"], feats["pix_feat"], self.sensory, self.last_mask,
            deep_update=True)
        self.obj_v = self.obj_v + summaries
        self.sensory = sensory
        key, shrink = _tokens(feats["key"]), _tokens(feats["shrinkage"])[..., 0]
        value = value.flatten(3).transpose(2, 3).float()             # [B,O,HW,Cv]
        b, hw = shrink.shape
        for bucket in self.buckets:
            frame = dict(key=key, shrink=shrink, value=value[:, self._span(bucket)])
            if bucket.pop("new", False):
                bucket["perm"] = frame
                continue
            frame["sel"] = _tokens(feats["selection"])
            frame["use"] = torch.zeros((b, hw), dtype=torch.float64,
                                       device=self.device)
            frame["life"] = torch.full((b, hw), 1e-7, dtype=torch.float64,
                                       device=self.device)
            bucket["ring"].append(frame)
            if not self.long_term and len(bucket["ring"]) > self.ring_max:
                bucket["ring"].pop(0)
            elif self.long_term:
                self._consolidate(bucket)

    # -------------------------------------------------------- consolidate

    def _consolidate(self, bucket: dict) -> None:
        """Compress the bucket's oldest ring frames into prototypes once its
        ring holds ring_max frames (memory_manager.py:309-358), evicting
        long-term tokens by usage first when the budget is near."""
        ring = bucket["ring"]
        if len(ring) < self.ring_max:
            return
        n_cand = len(ring) - self.ring_min
        cand, bucket["ring"] = ring[:n_cand], ring[n_cand:]
        key = torch.cat([f["key"] for f in cand], 1)          # [B, Nc, Ck]
        shr = torch.cat([f["shrink"] for f in cand], 1)
        sel = torch.cat([f["sel"] for f in cand], 1)
        val = torch.cat([f["value"] for f in cand], 2)        # [B, O, Nc, Cv]
        use = torch.cat([f["use"] / f["life"] for f in cand], 1)
        b, _, ck = key.shape
        idx = _stable_top(use, self.num_prototypes)           # [B, P]
        p_key = key.gather(1, idx[..., None].expand(-1, -1, ck))
        p_sel = sel.gather(1, idx[..., None].expand(-1, -1, ck))
        p_shr, p_val = [], []
        for r in range(b):
            sim = similarity64(key[r], shr[r], p_key[r], p_sel[r])   # [P, Nc]
            aff = torch.softmax(sim, dim=-1)
            p_shr.append((aff @ shr[r].double()).float())
            p_val.append(torch.einsum("pn,onc->opc", aff, val[r].double()).float())
        p_shr, p_val = torch.stack(p_shr), torch.stack(p_val)

        lt = bucket["lt"]
        if lt is not None and (lt["key"].shape[1]
                               >= self.max_long_tokens - self.num_prototypes):
            keep = self.max_long_tokens - self.num_prototypes - self.buffer_tokens
            kidx = _stable_top(lt["use"] / lt["life"], keep)
            lt = dict(
                key=lt["key"].gather(1, kidx[..., None].expand(-1, -1, ck)),
                shrink=lt["shrink"].gather(1, kidx),
                value=lt["value"].gather(2, kidx[:, None, :, None].expand(
                    -1, lt["value"].shape[1], -1, lt["value"].shape[3])),
                use=lt["use"].gather(1, kidx),
                life=lt["life"].gather(1, kidx).clamp_min(1e-7))
        new = dict(key=p_key, shrink=p_shr, value=p_val,
                   use=torch.zeros_like(p_shr, dtype=torch.float64),
                   life=torch.full(p_shr.shape, 1e-7, dtype=torch.float64,
                                   device=self.device))
        if lt is None:
            bucket["lt"] = new
        else:
            bucket["lt"] = {k: torch.cat([lt[k], new[k]], 2 if k == "value" else 1)
                            for k in new}
        self.consolidations += 1

    # -------------------------------------------------------------- events

    def delete_objects(self, objects: List[int]) -> None:
        """Drop `objects`: their per-object tensors and values, and every
        bucket left without objects (inference_core.py delete_objects,
        memory_manager.py purge_except)."""
        keep = [s for s, o in enumerate(self.objects) if o not in objects]
        buckets = []
        for bucket in self.buckets:
            rows = [j for j, o in enumerate(bucket["objects"]) if o not in objects]
            if not rows:
                continue

            def values(mem):
                return None if mem is None else dict(mem, value=mem["value"][:, rows])
            buckets.append(dict(objects=[bucket["objects"][j] for j in rows],
                                perm=values(bucket["perm"]), lt=values(bucket["lt"]),
                                ring=[values(f) for f in bucket["ring"]]))
        self.buckets = buckets
        self.objects = [self.objects[s] for s in keep]
        self.sensory = self.sensory[:, keep]
        self.obj_v = self.obj_v[:, keep]
        self.last_mask = self.last_mask[:, keep]

    def _merge(self, mask_p: np.ndarray, objects: List[int],
               prob: Optional[torch.Tensor]) -> torch.Tensor:
        """A padded index mask of `objects` over the prediction prob [O'+1,
        Hp, Wp] of the objects there before it (None: none): the mask's
        pixels are taken from the prediction, each given object's channel is
        its mask, new objects appended; -> probabilities [O+1, Hp, Wp]."""
        new = [o for o in objects if o not in self.objects]
        n_before = len(self.objects)
        self.objects += new
        onehot = np.stack([(mask_p == obj).astype(np.float32) for obj in objects])
        out = np.zeros((len(self.objects),) + mask_p.shape, np.float32)
        if prob is not None:
            pred = prob[1:n_before + 1].float().cpu().numpy().copy()
            pred[:, onehot.sum(0) > 0.5] = 0
            out[:n_before] = pred
        for obj, m in zip(objects, onehot):
            out[self.objects.index(obj)] = m
        return torch.from_numpy(aggregate_wbg_np(out, keep_bg=True)).to(self.device)

    # --------------------------------------------------------------- step

    @torch.no_grad()
    def step(self, image, mask: Optional[np.ndarray] = None,
             objects: Optional[List[int]] = None) -> torch.Tensor:
        """image: HWC uint8 (numpy); mask: an index mask of `objects`, the
        object ids given in it. Returns the probabilities [O+1, H, W]
        float32 on the device, background first."""
        image = torch.from_numpy(np.asarray(image)).to(self.device)
        image = image.permute(2, 0, 1).float() / 255.0
        orig_h, orig_w = image.shape[-2:]
        new_h, new_w = self._internal_size(orig_h, orig_w)
        resize = (new_h, new_w) != (orig_h, orig_w)
        if resize:
            image = bilinear_resize(image, new_h, new_w)
            if mask is not None:
                mask = nearest_exact_resize_np(np.asarray(mask), new_h, new_w)
        h, w = image.shape[-2:]
        self.ti += 1
        pad = compute_pad(h, w, 16)
        lw, uw, lh, uh = pad
        hp, wp = h + lh + uh, w + lw + uw
        feats = self._encode(image, pad)
        b = feats["key"].shape[0]
        since = self.ti - self.last_mem_ti

        if mask is None:
            prob = self._segment(feats, since in self.stagger_ti)[0]
            if since >= self.mem_every:
                self._memorize(feats)
                self.last_mem_ti = self.ti
        else:
            new = [o for o in objects if o not in self.objects]
            prob = None
            if self.objects and new:
                prob = self._segment(feats, since in self.stagger_ti)[0]
            mask_p = np.zeros((hp, wp), np.asarray(mask).dtype)
            mask_p[lh:hp - uh, lw:wp - uw] = mask
            prob = self._merge(mask_p, objects, prob)
            # a new object starts with empty sensory and object memory
            hs, ws = hp // 16, wp // 16
            cs = self.net.model_cfg.sensory_dim
            q = self.net.model_cfg.object_transformer.num_queries
            e = self.net.model_cfg.object_transformer.embed_dim
            zeros = dict(sensory=torch.zeros((b, len(new), cs, hs, ws), device=self.device),
                         obj_v=torch.zeros((b, len(new), q, e + 1), device=self.device))
            for k, z in zeros.items():
                setattr(self, k, torch.cat([getattr(self, k), z], 1)
                        if self.buckets else z)
            if new:
                self.buckets.append(dict(objects=new, ring=[], lt=None, new=True))
            self._set_last_mask(prob[None, 1:])
            self._memorize(feats)
            self.last_mem_ti = self.ti
        out = prob[:, lh:hp - uh, lw:wp - uw]
        return bilinear_resize(out, orig_h, orig_w) if resize else out
