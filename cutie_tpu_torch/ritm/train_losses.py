"""RITM's training losses, metric and initialisers (torch).

The port's counterpart of cutie_tpu/ritm/train_losses.py (reference
gui/ritm/model/losses.py:9-185, metrics.py:29-101, initializer.py:47-105):
the normalised focal, focal, soft-IoU and sigmoid-BCE losses, AdaptiveIoU,
and the bilinear and Gluon-Xavier initialisers, which draw from an explicit
torch.Generator.

Labels may hold `ignore_label` (-1) pixels, which drop out of every loss.
Every loss returns per-sample values [B] as the reference does (a reduction
over the other dims); the caller reduces the batch.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F


def _rest(x: torch.Tensor):
    return tuple(range(1, x.ndim))


def _minimum(x: torch.Tensor, bound: float) -> torch.Tensor:
    """jnp.minimum with a constant: at a tie the gradient is halved, where
    torch.clamp would pass all of it."""
    return torch.minimum(x, x.new_tensor(bound))


def normalized_focal_loss_sigmoid(pred, label, *, alpha: float = 0.25,
                                  gamma: float = 2.0, max_mult: float = -1,
                                  eps: float = 1e-12, from_sigmoid: bool = False,
                                  detach_delimeter: bool = True,
                                  ignore_label: float = -1,
                                  return_mult: bool = False):
    """A focal loss whose modulation is renormalised per image so that the
    focal weights sum to the pixel count (losses.py:38-85). [B] (and the
    per-image multiplier with return_mult, the reference's `_k_sum`)."""
    one_hot = label > 0.5
    sw = (label != ignore_label).to(pred.dtype)
    p = pred if from_sigmoid else torch.sigmoid(pred)
    a = torch.where(one_hot, alpha * sw, (1 - alpha) * sw)
    pt = torch.where(sw > 0, 1.0 - torch.abs(label - p), torch.ones_like(p))
    beta = (1.0 - pt) ** gamma
    sw_sum = sw.sum(dim=(-2, -1), keepdim=True)
    beta_sum = beta.sum(dim=(-2, -1), keepdim=True)
    mult = sw_sum / (beta_sum + eps)
    if detach_delimeter:
        mult = mult.detach()
    beta = beta * mult
    if max_mult > 0:
        beta = _minimum(beta, max_mult)
    loss = -a * beta * torch.log(_minimum(pt + eps, 1.0)) * sw
    out = loss.sum(dim=_rest(loss)) / (sw.sum(dim=_rest(sw)) + eps)
    if return_mult:
        return out, mult.reshape(mult.shape[0], -1).mean(-1)
    return out


def focal_loss_sigmoid(pred, label, *, alpha: float = 0.25, gamma: float = 2.0,
                       eps: float = 1e-9, from_logits: bool = False,
                       scale: float = 1.0, ignore_label: float = -1):
    """The plain focal loss (losses.py:91-144). [B]"""
    one_hot = label > 0.5
    sw = (label != ignore_label).to(pred.dtype)
    p = pred if from_logits else torch.sigmoid(pred)
    a = torch.where(one_hot, alpha * sw, (1 - alpha) * sw)
    pt = torch.where(sw > 0, 1.0 - torch.abs(label - p), torch.ones_like(p))
    beta = (1.0 - pt) ** gamma
    loss = -a * beta * torch.log(_minimum(pt + eps, 1.0)) * sw
    return scale * loss.sum(dim=_rest(loss)) / (sw.sum(dim=_rest(sw)) + eps)


def soft_iou_loss(pred, label, *, from_sigmoid: bool = False,
                  ignore_label: float = -1):
    """1 - soft IoU over the [C, H, W] dims (losses.py:146-162). [B]"""
    sw = (label != ignore_label).to(pred.dtype)
    p = pred if from_sigmoid else torch.sigmoid(pred)
    inter = (p * label * sw).sum(dim=(1, 2, 3))
    union = (torch.maximum(p, label) * sw).sum(dim=(1, 2, 3))
    return 1.0 - inter / (union + 1e-8)


def sigmoid_bce_loss(pred, label, *, from_sigmoid: bool = False,
                     ignore_label: float = -1):
    """Sigmoid BCE with ignored pixels (losses.py:165-185): the mean over
    the non-batch dims. [B]"""
    sw = (label != ignore_label).to(pred.dtype)
    lbl = torch.where(sw > 0, label, torch.zeros_like(label))
    if not from_sigmoid:
        loss = F.relu(pred) - pred * lbl + F.softplus(-torch.abs(pred))
    else:
        eps = 1e-12
        loss = -(torch.log(pred + eps) * lbl + torch.log(1.0 - pred + eps) * (1.0 - lbl))
    loss = loss * sw
    return loss.mean(dim=_rest(loss))


class AdaptiveIoU:
    """Training IoU with a self-adapting binarisation threshold
    (metrics.py:29-84): each update tries thresh +/- step and tracks the best
    by EMA. Host numpy, as the reference's .cpu() bookkeeping."""

    def __init__(self, init_thresh: float = 0.4, thresh_step: float = 0.025,
                 thresh_beta: float = 0.99, iou_beta: float = 0.9,
                 ignore_label: float = -1, from_logits: bool = True):
        self._ignore_label = ignore_label
        self._from_logits = from_logits
        self._iou_thresh = init_thresh
        self._thresh_step = thresh_step
        self._thresh_beta = thresh_beta
        self._iou_beta = iou_beta
        self.ema_iou = 0.0
        self._epoch_iou_sum = 0.0
        self._epoch_batch_count = 0

    @property
    def iou_thresh(self) -> float:
        return self._iou_thresh

    def update(self, pred, gt) -> None:
        pred = np.asarray(torch.as_tensor(pred).detach().cpu(), np.float32)
        gt = np.asarray(torch.as_tensor(gt).detach().cpu(), np.float32)
        gt_mask = gt > 0.5
        if self._from_logits:
            pos = pred >= 0
            ex = np.exp(np.where(pos, -pred, pred))
            pred = np.where(pos, 1.0 / (1.0 + ex), ex / (1.0 + ex))
        if not gt_mask.reshape(gt_mask.shape[0], -1).any():
            return
        ignore = gt == self._ignore_label
        best_t = self._iou_thresh
        max_iou = compute_iou(pred > best_t, gt_mask, ignore).mean()
        for t in (best_t - self._thresh_step, best_t + self._thresh_step):
            iou = compute_iou(pred > t, gt_mask, ignore).mean()
            if iou > max_iou:
                max_iou, best_t = iou, t
        self._iou_thresh = (self._thresh_beta * self._iou_thresh
                            + (1 - self._thresh_beta) * best_t)
        self.ema_iou = self._iou_beta * self.ema_iou + (1 - self._iou_beta) * max_iou
        self._epoch_iou_sum += max_iou
        self._epoch_batch_count += 1

    def get_epoch_value(self) -> float:
        if self._epoch_batch_count > 0:
            return self._epoch_iou_sum / self._epoch_batch_count
        return 0.0

    def reset_epoch_stats(self) -> None:
        self._epoch_iou_sum = 0.0
        self._epoch_batch_count = 0


def compute_iou(pred_mask, gt_mask, ignore_mask=None, keep_ignore: bool = False):
    """Per-sample IoU over the non-batch dims (metrics.py:86-101)."""
    if ignore_mask is not None:
        pred_mask = np.where(ignore_mask, False, pred_mask)
    rest = tuple(range(1, gt_mask.ndim))
    union = (pred_mask | gt_mask).astype(np.float32).mean(axis=rest)
    inter = (pred_mask & gt_mask).astype(np.float32).mean(axis=rest)
    nonzero = union > 0
    iou = inter[nonzero] / union[nonzero]
    if not keep_ignore:
        return iou
    result = np.full_like(inter, -1.0)
    result[nonzero] = iou
    return result


# ----------------------------------------------------------- initialisers

def bilinear_upsample_kernel(scale: int) -> np.ndarray:
    """The bilinear upsampling kernel [k, k] (initializer.py:66-77)."""
    k = 2 * scale - scale % 2
    s = (k + 1) // 2
    center = s - 0.5 * (1 + k % 2)
    og = np.ogrid[:k, :k]
    return ((1 - np.abs(og[0] - center) / s)
            * (1 - np.abs(og[1] - center) / s)).astype(np.float32)


def bilinear_init_(weight: torch.Tensor, scale: int, groups: int,
                   in_channels: int) -> torch.Tensor:
    """Fill a transposed conv's weight [C_in, C_out / groups, k, k] so that
    it starts as exact bilinear upsampling (initializer.py:47-64)."""
    ker = torch.from_numpy(bilinear_upsample_kernel(scale))
    kh, kw = weight.shape[-2:]
    with torch.no_grad():
        weight.zero_()
        for i in range(in_channels):
            weight[i, i if groups == 1 else 0] = ker[:kh, :kw]
    return weight


def xavier_gluon_init_(weight: torch.Tensor, generator: torch.Generator,
                       rnd_type: str = "uniform", factor_type: str = "avg",
                       magnitude: float = 3.0) -> torch.Tensor:
    """Gluon's Xavier (initializer.py:79-105) in place, drawn from
    `generator`; fans as torch computes them for [O, I, kh, kw] kernels."""
    shape: Sequence[int] = weight.shape
    rf = int(np.prod(shape[2:])) if len(shape) > 2 else 1
    fan_in, fan_out = shape[1] * rf, shape[0] * rf
    factor: Optional[float] = {"avg": (fan_in + fan_out) / 2.0, "in": fan_in,
                               "out": fan_out}.get(factor_type)
    if factor is None:
        raise ValueError("Incorrect factor type")
    scale = float(np.sqrt(magnitude / factor))
    with torch.no_grad():
        if rnd_type == "uniform":
            weight.uniform_(-scale, scale, generator=generator)
        elif rnd_type == "gaussian":
            weight.normal_(0.0, scale, generator=generator)
        else:
            raise ValueError("Unknown random type")
    return weight
