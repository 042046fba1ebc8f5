"""The memory read with its tokens sharded over the ranks of a mesh.

The port's counterpart of cutie_tpu/parallel/sharded_memory.py: an exact
top-k softmax readout when memory outgrows one device. Each rank holds a
slice of the memory-token axis N and, for the same queries,

  1. computes the similarity of its slice (ops.memory.get_similarity, the
     direct form, elementwise: the values equal the single-device read's
     bit for bit) and its local top-k values; the union of the local
     top-k's holds the global top-k;
  2. all-gathers them ([B, P, k_local] a rank) and takes the global top-k
     of the gathered values: the threshold is the k-th, m the first;
  3. forms w = exp(sim - m) [live, sim >= threshold] on its slice and
     contracts it against its value slice; one all-reduce sums the
     readouts and the weight sums Z, and the readout is divided by Z.

Communication a query: k_local * D gathered scalars and the readout,
whatever N is. Every token tied at the threshold is kept and Z sums every
kept weight, the semantics of the single-device read
(ops.read_kernel.radix_topk_readout); cutie_tpu's Z sums only the k
gathered values, which differs only under exact ties. A query whose
tokens are all invalid reads 0. Values are read as they are stored
(fp32, or bf16 under amp) and contracted with fp32 weights in fp32, as the
single-device read does (ROADMAP D4).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from cutie_tpu_torch.ops.memory import NEG_INF, get_similarity
from cutie_tpu_torch.parallel.mesh import (Mesh, all_gather, all_reduce_sum_,
                                           make_mesh)

# a section of memory: key [B, N, Ck], shrinkage [B, N] or None, value
# [B, O, N, Cv], validity [B, N] bool or None
Section = Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor,
                Optional[torch.Tensor]]


def make_mem_mesh(n_devices: Optional[int] = None) -> Mesh:
    return make_mesh(n_devices)


def shard_memory(mesh: Mesh, mem_key, mem_shrink, values, valid):
    """This rank's slice of the token axis of memory buffers held whole:
    mem_key [B, N, Ck], mem_shrink [B, N], values [B, O, N, Cv], valid
    [B, N]. N must divide by the mesh size."""
    n = mem_key.shape[1]
    if n % mesh.size:
        raise ValueError(f"token axis {n} not divisible by mesh size {mesh.size}")
    c = n // mesh.size
    s = slice(mesh.rank * c, (mesh.rank + 1) * c)
    return (mem_key[:, s], None if mem_shrink is None else mem_shrink[:, s],
            values[:, :, s], None if valid is None else valid[:, s])


def _local_read(mk, ms, qk, qe, vals, valid, top_k: int, n_global: int,
                mesh: Mesh, return_usage: bool):
    """Steps 1-3 on this rank's tokens (module docstring). Returns the
    readout [B, O, P, Cv] (fp32, summed over the mesh) and the usage of
    this rank's tokens [B, n_local] (or None)."""
    n_local = mk.shape[1]
    k = min(top_k, n_global)
    sim = get_similarity(mk, ms, qk, qe, valid)                 # [B, P, n]
    loc = torch.topk(sim, min(k, n_local), dim=-1).values
    glob = torch.topk(torch.cat(all_gather(loc, mesh), dim=-1), k, dim=-1).values
    thresh, m = glob[..., -1:], glob[..., :1]
    live = sim > NEG_INF / 2
    w = torch.where(live & (sim >= thresh), torch.exp(sim - m),
                    torch.zeros_like(sim))
    b, o, p, cv = vals.shape[0], vals.shape[1], sim.shape[1], vals.shape[-1]
    rd = torch.einsum("bpn,bonc->bopc", w, vals.float())
    # one all-reduce for the readout and the weight sums
    buf = all_reduce_sum_(torch.cat([rd.reshape(-1), w.sum(-1).reshape(-1)]), mesh)
    z = buf[rd.numel():].view(b, 1, p, 1).clamp_min(1e-30)
    rd = buf[:rd.numel()].view(b, o, p, cv) / z
    usage = (w / z[:, 0]).sum(dim=1) if return_usage else None
    return rd, usage


def sharded_topk_readout(mem_key: torch.Tensor, mem_shrink: Optional[torch.Tensor],
                         q_key: torch.Tensor, q_sel: Optional[torch.Tensor],
                         values: torch.Tensor, valid: Optional[torch.Tensor],
                         top_k: int, mesh: Mesh, return_usage: bool = False
                         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Exact top-k softmax readout over memory sharded on the token axis.

    mem_key [B, N/D, Ck], mem_shrink [B, N/D] or None, values
    [B, O, N/D, Cv], valid [B, N/D] or None: this rank's slice
    (shard_memory); q_key / q_sel [B, P, Ck] (q_sel may be None): the same
    on every rank. Returns (readout [B, O, P, Cv] fp32, the same on every
    rank; usage [B, N/D] of this rank's tokens, or None)."""
    n_global = mem_key.shape[1] * mesh.size
    return _local_read(mem_key, mem_shrink, q_key, q_sel, values, valid,
                       top_k, n_global, mesh, return_usage)


def _rank_chunk(x: torch.Tensor, dim: int, chunk: int, mesh: Mesh,
                fill=0) -> torch.Tensor:
    """This rank's `chunk` entries along `dim` of a replicated tensor,
    padded with `fill` past its end to chunk * mesh.size."""
    size = x.shape[dim]
    pad = chunk * mesh.size - size
    if pad:
        widths = [0, 0] * (x.dim() - 1 - dim) + [0, pad]
        x = F.pad(x, widths, value=fill)
    return x.narrow(dim, mesh.rank * chunk, chunk)


def _gather_tokens(x: torch.Tensor, mesh: Mesh, n: int) -> torch.Tensor:
    """The whole token axis [B, n] from every rank's chunk [B, c]."""
    return torch.cat(all_gather(x, mesh), dim=1)[:, :n]


def sharded_composite_readout(perm: Section, lt: Section, work: Section,
                              q_key: torch.Tensor, q_sel: Optional[torch.Tensor],
                              top_k: int, mesh: Mesh, lt_sharded: bool = False,
                              return_usage: bool = False):
    """The exact top-k readout over [perm | lt | work] without a global
    token concatenation (cutie_tpu sharded_memory.py:77-212).

    perm and work are replicated (the same on every rank, bounded by the
    commits and the ring): each rank slices its own chunk of each, padded
    to a mesh multiple. lt is the unbounded store: with lt_sharded its
    buffers are this rank's slice of a capacity that divides by the mesh;
    otherwise it is replicated and sliced like the others. Sections carry
    their own validity [B, N] (a shrinkage of None is taken as 1).

    Returns (readout [B, O, P, Cv] fp32, the same on every rank; lt usage:
    this rank's slice [B, L/D] when lt_sharded, else the whole [B, L];
    work usage [B, Nw], the whole, gathered, so that every rank's replica
    of the ring gets the same counters). Usages are None unless
    return_usage; the permanent tokens carry none (kv_memory_store.py:
    151-162)."""
    d = mesh.size
    sections = []
    for name, (k_, s_, v_, valid_) in (("perm", perm), ("lt", lt), ("work", work)):
        n = k_.shape[1]
        if s_ is None:
            s_ = k_.new_ones(k_.shape[:2])
        if valid_ is None:
            valid_ = torch.ones(k_.shape[:2], dtype=torch.bool, device=k_.device)
        if name == "lt" and lt_sharded:
            sections.append((k_, s_, v_, valid_, n * d, n))
            continue
        c = -(-n // d)
        sections.append((_rank_chunk(k_, 1, c, mesh), _rank_chunk(s_, 1, c, mesh),
                         _rank_chunk(v_, 2, c, mesh),
                         _rank_chunk(valid_, 1, c, mesh, fill=False), n, c))
    mk = torch.cat([s[0] for s in sections], dim=1)
    ms = torch.cat([s[1] for s in sections], dim=1)
    vals = torch.cat([s[2] for s in sections], dim=2)
    valid = torch.cat([s[3] for s in sections], dim=1)
    n_global = sum(s[4] for s in sections)
    rd, usage = _local_read(mk, ms, q_key, q_sel, vals, valid, top_k, n_global,
                            mesh, return_usage)
    if not return_usage:
        return rd, None, None
    cp, cl, cw = (s[5] for s in sections)
    lt_usage = usage[:, cp:cp + cl]
    if not lt_sharded:
        lt_usage = _gather_tokens(lt_usage, mesh, sections[1][4])
    work_usage = _gather_tokens(usage[:, cp + cl:], mesh, sections[2][4])
    return rd, lt_usage, work_usage
