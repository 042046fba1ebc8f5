"""One click of RITM's f-BRS-B predictor in plain float32 torch.

SamsungLabs ritm_interactive_segmentation, isegm/inference/:
predictors/base.py (BasePredictor.get_prediction: the previous-mask
channel, the transforms and their inverses), predictors/brs.py
(FeatureBRSPredictor for HRNet at insertion point A: a per-channel scale
and bias on the aggregated HRNet features, the OCR head rerun on them, the
click maps), predictors/brs_functors.py (ScaleBiasOptimizer: the
regulariser and the exits), predictors/brs_losses.py (BRSMaskLoss),
transforms/zoom_in.py, limit_longest_side.py, flip.py, with the predictor
parameters of Cutie's gui/click_controller.py (f-BRS-B, prob_thresh 0.5,
net_clicks_limit 8, max_size 800, flip, zoom-in to 480 after the first
click at expansion 1.4, min_iou_diff 1e-3, L-BFGS-B maxfun 20).

An Interaction follows one object's clicks as ZoomIn and LimitLongestSide
keep their state between clicks (the crop is recomputed from the previous
click's probabilities as upstream's ZoomIn computes it). Each click is
evaluated from what the checked program held before it: the clicks, the
previous mask (the GUI's for the first click, the program's previous
probabilities after it) and the scale and bias.

Departures from upstream:
  - the network input is zero-padded at the bottom and right to multiples
    of 64 and the logits cropped back, as the checked program pads it (its
    padding enters the result through the border convolutions and the OCR
    context, so an unpadded reference would differ by more than rounding);
  - fmin_l_bfgs_b's maxiter is 40 (upstream's 2 x maxfun), and its
    objective returns the loss and gradient of one autograd pass.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from scipy.optimize import fmin_l_bfgs_b

PAD = 64
LBFGS = {"m": 20, "factr": 0, "pgtol": 1e-8, "maxfun": 20, "maxiter": 40}


class Click(NamedTuple):
    y: float
    x: float
    positive: bool


class Params(NamedTuple):
    """The predictor parameters of one configuration."""
    prob_thresh: float = 0.5
    net_clicks_limit: int = 8
    max_size: int = 800
    with_flip: bool = True
    skip_clicks: int = 1
    target_size: int = 480
    expansion_ratio: float = 1.4
    min_crop_size: int = 200
    recompute_thresh_iou: float = 0.5
    min_iou_diff: float = 1e-3
    maxfun: int = 20
    reg_weight: float = 1e-3
    reg_bias_weight: float = 10.0


def _up(x, h, w):
    return F.interpolate(x, size=(h, w), mode="bilinear", align_corners=True)


def points_nd(clicks_lists: List[List[Click]], limit: int, device) -> torch.Tensor:
    """base.py get_points_nd: [B, 2K, 3] (row, col, click index), the
    positive clicks then the negative ones, each padded with -1 to K."""
    num_pos = [sum(c.positive for c in cl) for cl in clicks_lists]
    num_neg = [len(cl) - p for cl, p in zip(clicks_lists, num_pos)]
    k = max(1, min(limit, max(num_pos + num_neg)))
    rows = []
    for cl in clicks_lists:
        cl = [(c, i) for i, c in enumerate(cl)][:limit]
        pos = [(c.y, c.x, i) for c, i in cl if c.positive]
        neg = [(c.y, c.x, i) for c, i in cl if not c.positive]
        rows.append(pos + (k - len(pos)) * [(-1, -1, -1)]
                    + neg + (k - len(neg)) * [(-1, -1, -1)])
    return torch.tensor(rows, dtype=torch.float32, device=device)


def click_maps(clicks_lists: List[List[Click]], h: int, w: int, device, radius: int = 1):
    """brs.py _get_clicks_maps_nd: a (2 radius + 1)^2 square at each click,
    set by numpy slicing as upstream sets it -> (pos, neg) [B, 1, h, w]."""
    pos = np.zeros((len(clicks_lists), 1, h, w), np.float32)
    neg = np.zeros_like(pos)
    for i, cl in enumerate(clicks_lists):
        for c in cl:
            y, x = int(round(c.y)), int(round(c.x))
            (pos if c.positive else neg)[i, 0, y - radius:y + radius + 1,
                                         x - radius:x + radius + 1] = 1.0
    return torch.from_numpy(pos).to(device), torch.from_numpy(neg).to(device)


def _roi_image(image, roi, target_size: int):
    """zoom_in.py get_roi_image_nd."""
    rmin, rmax, cmin, cmax = roi
    height, width = rmax - rmin + 1, cmax - cmin + 1
    scale = target_size / max(height, width)
    crop = image[:, :, rmin:rmax + 1, cmin:cmax + 1]
    return _up(crop, int(round(height * scale)), int(round(width * scale)))


def _roi_clicks(clicks: List[Click], roi, crop_hw) -> List[Click]:
    """zoom_in.py ZoomIn._transform_clicks."""
    rmin, rmax, cmin, cmax = roi
    ch, cw = crop_hw
    return [c._replace(y=ch * (c.y - rmin) / (rmax - rmin + 1),
                       x=cw * (c.x - cmin) / (cmax - cmin + 1)) for c in clicks]


def object_roi(mask: np.ndarray, clicks: List[Click], expansion_ratio: float,
               min_crop_size: int):
    """zoom_in.py get_object_roi (with misc.py's get_bbox_from_mask,
    expand_bbox and clamp_bbox)."""
    mask = mask.copy()
    for c in clicks:
        if c.positive:
            mask[int(c.y), int(c.x)] = True
    rows, cols = np.any(mask, axis=1), np.any(mask, axis=0)
    rmin, rmax = np.where(rows)[0][[0, -1]]
    cmin, cmax = np.where(cols)[0][[0, -1]]
    rc, cc = 0.5 * (rmin + rmax), 0.5 * (cmin + cmax)
    height = max(expansion_ratio * (rmax - rmin + 1), min_crop_size)
    width = max(expansion_ratio * (cmax - cmin + 1), min_crop_size)
    bbox = (int(round(rc - height / 2)), int(round(rc + height / 2)),
            int(round(cc - width / 2)), int(round(cc + width / 2)))
    h, w = mask.shape
    return (max(0, bbox[0]), min(h - 1, bbox[1]), max(0, bbox[2]), min(w - 1, bbox[3]))


def _roi_holds_clicks(roi, clicks: List[Click]) -> bool:
    """zoom_in.py check_object_roi."""
    return all(roi[0] <= c.y < roi[1] and roi[2] <= c.x < roi[3]
               for c in clicks if c.positive)


def _bbox_iou(b1, b2) -> float:
    """misc.py get_bbox_iou."""
    def seg(s1, s2):
        inter = max(0, min(s1[1], s2[1]) - max(s1[0], s2[0]) + 1)
        return inter / max(1e-6, max(s1[1], s2[1]) - min(s1[0], s2[0]) + 1)
    return seg(b1[:2], b2[:2]) * seg(b1[2:4], b2[2:4])


def brs_mask_loss(result, pos, neg, eps: float = 1e-5):
    """brs_losses.py BRSMaskLoss -> (loss, f_max_pos, f_max_neg)."""
    pos_diff = (1 - result) * pos
    neg_diff = result * neg
    loss = ((pos_diff ** 2).sum() / (pos.sum() + eps)
            + (neg_diff ** 2).sum() / (neg.sum() + eps))
    return loss, pos_diff.abs().max(), neg_diff.abs().max()


class ClickInput(NamedTuple):
    """One click as the network sees it: the transformed batch (the flip's
    mirror second), its clicks, the crop, and whether LimitLongestSide and
    ZoomIn resize the prediction back."""
    image: torch.Tensor                 # [B, 4, h, w]
    clicks_lists: List[List[Click]]
    zoom_roi: Optional[tuple]           # ZoomIn's roi after the click
    limit: bool                         # LimitLongestSide's roi is set


class Interaction:
    """One object's clicks on one image through the predictor's
    transforms, with ZoomIn's state between clicks."""

    def __init__(self, net, image: torch.Tensor, params: Params = Params()):
        """image [3, H, W] in [0, 1] on the network's device."""
        self.net, self.image, self.p = net, image, params
        self.zoom_roi = None

    def transform(self, clicks: List[Click], prev_mask: torch.Tensor,
                  prev_probs: Optional[np.ndarray]) -> ClickInput:
        """The transforms of one click (ZoomIn, LimitLongestSide,
        AddHorizontalFlip). prev_mask [H, W], the previous-mask channel;
        prev_probs [H, W], the previous click's probabilities (ZoomIn's
        _prev_probs), None at an interaction's first click."""
        p = self.p
        h, w = self.image.shape[-2:]
        x = torch.cat([self.image, prev_mask[None]], 0)[None]
        cl = list(clicks)
        if len(cl) > p.skip_clicks and prev_probs is not None:
            mask = prev_probs > p.prob_thresh
            if mask.any():
                roi = object_roi(mask, cl, p.expansion_ratio, p.min_crop_size)
                if (self.zoom_roi is None or not _roi_holds_clicks(self.zoom_roi, cl)
                        or _bbox_iou(roi, self.zoom_roi) < p.recompute_thresh_iou):
                    self.zoom_roi = roi
                x = _roi_image(x, self.zoom_roi, p.target_size)
                cl = _roi_clicks(cl, self.zoom_roi, x.shape[-2:])
        limit = max(h, w) > p.max_size
        if max(x.shape[-2:]) > p.max_size:
            full = (0, x.shape[2] - 1, 0, x.shape[3] - 1)
            x = _roi_image(x, full, p.max_size)
            cl = _roi_clicks(cl, full, x.shape[-2:])
        lists = [cl]
        if p.with_flip:
            xw = x.shape[3]
            lists.append([c._replace(x=xw - c.x - 1) for c in cl])
            x = torch.cat([x, x.flip(3)])
        return ClickInput(x, lists, self.zoom_roi, limit)

    def features(self, ci: ClickInput) -> torch.Tensor:
        """The aggregated HRNet features of the padded input (insertion
        point A), with the clicks limited to net_clicks_limit."""
        h, w = ci.image.shape[-2:]
        hp, wp = -(-h // PAD) * PAD, -(-w // PAD) * PAD
        img = F.pad(ci.image, (0, wp - w, 0, hp - h))
        pts = points_nd(ci.clicks_lists, self.p.net_clicks_limit, img.device)
        return self.net.features(img, pts)

    def logits(self, feats: torch.Tensor, x: torch.Tensor, hw) -> torch.Tensor:
        """get_prediction_logits: the OCR head on the features scaled by 1
        + scale and shifted by bias (x = [scale, bias], one batch row,
        repeated for the flip), upsampled to the padded size and cropped to
        hw -> [B, 1, h, w]; and the regulariser."""
        scale, bias = x.chunk(2)
        reg = self.p.reg_weight * ((scale ** 2).sum()
                                   + self.p.reg_bias_weight * (bias ** 2).sum())
        rows = feats.shape[0]
        scale = (1 + scale).view(1, -1, 1, 1).repeat(rows, 1, 1, 1)
        bias = bias.view(1, -1, 1, 1).repeat(rows, 1, 1, 1)
        low = self.net.feature_extractor.head(feats * scale + bias)
        hp, wp = 4 * feats.shape[-2], 4 * feats.shape[-1]
        return _up(low, hp, wp)[:, :, :hw[0], :hw[1]], reg

    def objective(self, ci: ClickInput, feats: torch.Tensor):
        """f-BRS-B's objective x -> (loss + regulariser, logits, f_max_pos,
        f_max_neg) (ScaleBiasOptimizer with BRSMaskLoss, flip_average off)."""
        hw = ci.image.shape[-2:]
        pos, neg = click_maps(ci.clicks_lists, *hw, feats.device)

        def fn(x):
            logits, reg = self.logits(feats, x, hw)
            loss, fmp, fmn = brs_mask_loss(torch.sigmoid(logits), pos, neg)
            return loss + reg, logits, fmp, fmn
        return fn

    def probabilities(self, ci: ClickInput, logits: torch.Tensor) -> torch.Tensor:
        """The inverse transforms of the click's logits [B, 1, h, w] ->
        probabilities [H, W]: the flip's average, the sigmoid, then
        LimitLongestSide's and ZoomIn's resize back (ZoomIn pastes its
        crop into zeros; both keep their roi from earlier clicks)."""
        h, w = self.image.shape[-2:]
        if self.p.with_flip:
            n = logits.shape[0] // 2
            logits = 0.5 * (logits[:n] + logits[n:].flip(3))
        prob = torch.sigmoid(logits)
        if ci.limit:
            prob = _up(prob, h, w)
        if ci.zoom_roi is not None:
            rmin, rmax, cmin, cmax = ci.zoom_roi
            out = torch.zeros(1, 1, h, w, dtype=prob.dtype, device=prob.device)
            out[:, :, rmin:rmax + 1, cmin:cmax + 1] = _up(prob, rmax - rmin + 1,
                                                          cmax - cmin + 1)
            prob = out
        return prob[0, 0]


def lbfgs_b(fn, x0: np.ndarray, params: Params, device) -> Tuple[float, np.ndarray, int]:
    """fmin_l_bfgs_b over fn from x0, through brs_functors.py's functor:
    a zero gradient once the clicks are satisfied (max |1 - p| at positive
    clicks under 1 - prob_thresh, max p at negative clicks under
    prob_thresh) or the mask's IoU with the last evaluation's, averaged
    over the batch rows, exceeds 1 - min_iou_diff. -> (the best loss, its
    x, evaluations)."""
    state = {"best": None, "best_x": None, "last": None, "evals": 0}

    def functor(xv):
        x = torch.from_numpy(np.asarray(xv, np.float32)).to(device).requires_grad_()
        with torch.enable_grad():
            loss, logits, fmp, fmn = fn(x)
            grad, = torch.autograd.grad(loss, x)
        state["evals"] += 1
        f_val, fmp, fmn = (float(v.detach()) for v in (loss, fmp, fmn))
        if state["best"] is None or f_val < state["best"]:
            state["best"], state["best_x"] = f_val, np.asarray(xv, np.float32).copy()
        zero = [f_val, np.zeros_like(xv)]
        if fmp < 1 - params.prob_thresh and fmn < params.prob_thresh:
            return zero
        mask = torch.sigmoid(logits) > params.prob_thresh
        last = state["last"]
        if last is not None and params.min_iou_diff > 0:
            dims = tuple(range(1, mask.dim()))
            union = (mask | last).float().mean(dims)
            inter = (mask & last).float().mean(dims)
            keep = union > 0
            if bool(keep.any()) and float((inter[keep] / union[keep]).mean()) \
                    > 1 - params.min_iou_diff:
                return zero
        state["last"] = mask
        return [f_val, grad.double().cpu().numpy()]

    opts = dict(LBFGS, maxfun=params.maxfun, maxiter=2 * params.maxfun)
    fmin_l_bfgs_b(func=functor, x0=np.asarray(x0, np.float64), **opts)
    return state["best"], state["best_x"], state["evals"]
