"""Memory attention math in plain PyTorch.

The port's counterpart of cutie_tpu/ops/memory.py (reference
cutie/model/utils/memory_utils.py:7-95). Tokens are rows: memory keys
[B, N, Ck], query keys [B, P, Ck], similarity [B, P, N], values
[B, O, N, Cv]. A validity mask [B, N] replaces the reference's growing token
axis; invalid tokens get NEG_INF similarity. All of it is fp32.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

NEG_INF = -1e30


def get_similarity(mk: torch.Tensor, ms: Optional[torch.Tensor],
                   qk: torch.Tensor, qe: Optional[torch.Tensor],
                   valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Anisotropic negative squared L2 similarity (XMem appendix formula),
    -sum_c qe_c (mk_c - qk_c)^2 * ms / sqrt(Ck).

    mk [B, N, Ck], ms [B, N] or None, qk [B, P, Ck], qe [B, P, Ck] or None,
    valid [B, N] bool or None. Returns [B, P, N] fp32.

    Precision: the direct form, summed over the channels in order with every
    difference, product and sum rounded to fp32 on its own. Its terms are
    nonnegative, so it is exact to fp32 rounding (relative error at most
    about (Ck + 7) units of fp32 roundoff). The expanded form the reference
    uses, qe (2 qk mk - mk^2) - qe qk^2, cancels by about three digits on
    trained keys. The read kernel (csrc/radix_topk_readout.cu) performs the
    same operations in the same order, so the two agree bit for bit.
    """
    mk = mk.float()
    qk = qk.float()
    ck = mk.shape[-1]
    s = mk.new_zeros(qk.shape[:-1] + mk.shape[-2:-1])       # [B, P, N]
    for c in range(ck):
        d = mk[..., None, :, c] - qk[..., :, None, c]
        t = d if qe is None else qe[..., :, None, c].float() * d
        s = s + t * d
    if ms is not None:
        s = s * ms.float()[..., None, :]
    similarity = s * (-1.0 / math.sqrt(ck))
    if valid is not None:
        similarity = torch.where(valid[:, None, :], similarity,
                                 torch.full_like(similarity, NEG_INF))
    return similarity


def _float_order_key(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> order key whose unsigned integer order is the float order
    (the standard radix-sort transform the read kernel selects on; no NaNs
    here). Two keys differ by the number of fp32 values between them, so a
    key difference is a distance in ulps. torch has no uint32 arithmetic on
    every backend, so the 32-bit key is held in int64."""
    b = x.float().contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return torch.where(b >> 31 == 0, b | 0x80000000, (~b) & 0xFFFFFFFF)


def topk_threshold(similarity: torch.Tensor, top_k: int) -> torch.Tensor:
    """Exact k-th largest value along the last axis: [..., N] -> [..., 1].

    torch.topk returns the k-th largest VALUE exactly, whatever it does with
    ties, so this equals cutie_tpu's MSB-first radix select
    (ops/memory.py:topk_threshold_radix) bit for bit."""
    k = min(top_k, similarity.shape[-1])
    return torch.topk(similarity, k, dim=-1).values[..., -1:]


def topk_softmax_radix(similarity: torch.Tensor, top_k: int,
                       return_usage: bool = False
                       ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Top-k sparse softmax by the exact threshold (cutie_tpu
    ops/memory.py:216-233): EVERY token whose similarity equals the k-th
    value is kept, where a sort would keep an arbitrary k of them.
    exp without max subtraction: similarity <= 0, and NEG_INF gives 0."""
    tau = topk_threshold(similarity, top_k)
    w = torch.where(similarity >= tau, torch.exp(similarity),
                    torch.zeros_like(similarity))
    affinity = w / w.sum(-1, keepdim=True).clamp_min(1e-30)
    if return_usage:
        return affinity, affinity.sum(dim=1)
    return affinity, None


def softmax_affinity(similarity: torch.Tensor) -> torch.Tensor:
    """Full max-subtracted softmax over the token axis (training and
    long-term consolidation)."""
    return torch.softmax(similarity, dim=-1)


def readout(affinity: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """affinity [B, P, N] x values [B, N, Cv] -> [B, P, Cv], or
    values [B, O, N, Cv] -> [B, O, P, Cv], in fp32."""
    values = values.float()
    if values.dim() == 3:
        return torch.einsum("bpn,bnc->bpc", affinity, values)
    return torch.einsum("bpn,bonc->bopc", affinity, values)
