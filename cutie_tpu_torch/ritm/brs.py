"""f-BRS and input BRS: online optimisation for click consistency.

The port's counterpart of cutie_tpu/ritm/brs.py (reference
gui/ritm/inference/predictors/{brs,brs_functors,brs_losses}.py):
  - HRNetFeatureBRSPredictor: a per-channel scale and bias on HRNet's
    features, at insertion point 'A' (the aggregated features before the
    OCR heads: f-BRS-A and f-BRS-B) or 'C' (the OCR features before
    cls_head: f-BRS-C), the head rerun on the cached backbone features;
  - InputBRSPredictor: an additive bias on the normalised RGB (RGB-BRS) or
    on the click maps (DistMap-BRS), through the whole forward;
  - ScaleBiasOptimizer / InputOptimizer, the functor with the reference's
    exits: the clicks already satisfied, or the mask's IoU change under
    min_iou_diff;
  - brs_mask_loss (BRSMaskLoss) and click_maps_from_points.

Two drivers, as in cutie_tpu. By default (host_lbfgs=False) a click runs
ritm/lbfgs.py:lbfgs_drive, the port of cutie_tpu's device_lbfgs_drive
(optax's L-BFGS with its zoom line search, the exits and the budget in the
drive): the scale/bias vector, the gradients and the L-BFGS memory stay on
the model's device, the click maps are built there from the click
coordinates over the padded canvas (brs.py:314), and the best low-resolution
logits are upsampled once at the end. With host_lbfgs=True, scipy's
fmin_l_bfgs_b runs on the host, as cutie_tpu's host_lbfgs=True path does
(brs.py:447-475, :642): each evaluation takes the loss and its gradient by
torch autograd on the model's device and fetches the gradient and three
scalars. Either way the functor's n_evals counts a click's evaluations.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from scipy.optimize import fmin_l_bfgs_b

from cutie_tpu_torch.ops.resize import (bilinear_resize_align_corners,
                                        bilinear_resize_align_corners_mm)
from cutie_tpu_torch.ritm.inference import Click, Predictor, pad_hw, pad_to
from cutie_tpu_torch.ritm.lbfgs import lbfgs_drive
from cutie_tpu_torch.utils.tracing import span

DEFAULT_LBFGS_PARAMS = {"m": 20, "factr": 0, "pgtol": 1e-8, "maxfun": 20,
                        "maxiter": 40}


class ScaleBiasOptimizer:
    """(brs_functors.py BaseOptimizer + ScaleBiasOptimizer) The function
    scipy's L-BFGS calls: x (float64) -> [loss, gradient], with a zero
    gradient, which ends the search, once the clicks are satisfied or the
    mask has stopped changing. n_evals counts the evaluations of a click,
    scipy's or the drive's; best_x is the point of the evaluation whose logits a
    click returns (best_prediction: host float32 from scipy, a tensor on
    the device from the drive); drive_info is the device drive's last
    report (lbfgs_drive's info without best_x)."""

    def __init__(self, optimizer_params=None, prob_thresh=0.49, reg_weight=1e-3,
                 min_iou_diff=0.01, with_flip=False, flip_average=False,
                 scale_act: Optional[str] = None, reg_bias_weight=10.0):
        self.optimizer_params = dict(DEFAULT_LBFGS_PARAMS)
        if optimizer_params:
            self.optimizer_params.update(optimizer_params)
        self.prob_thresh = prob_thresh
        self.reg_weight = reg_weight
        self.min_iou_diff = min_iou_diff
        self.with_flip = with_flip
        self.flip_average = flip_average
        self.scale_act = scale_act
        self.reg_bias_weight = reg_bias_weight
        self.best_prediction = None
        self.best_x = None
        self.n_evals = 0
        self.drive_info = None
        self._eval = None
        self._best_loss = None
        self._last_mask = None

    def init_click(self, eval_fn):
        """eval_fn(x float64) -> (loss, grad, logits, f_max_pos, f_max_neg),
        tensors on the model's device."""
        self.best_prediction = None
        self.best_x = None
        self.n_evals = 0
        self._eval = eval_fn
        self._best_loss = None
        self._last_mask = None

    def __call__(self, x):
        loss, grad, logits, f_max_pos, f_max_neg = self._eval(x)
        self.n_evals += 1
        f_val, f_max_pos, f_max_neg = torch.stack([loss, f_max_pos, f_max_neg]).tolist()
        if self.best_prediction is None or f_val < self._best_loss:
            self.best_prediction = logits
            self.best_x = np.asarray(x, np.float32).copy()
            self._best_loss = f_val

        # clicks already satisfied: a zero gradient stops L-BFGS
        if f_max_pos < 1 - self.prob_thresh and f_max_neg < self.prob_thresh:
            return [f_val, np.zeros_like(x)]

        current_mask = logits > 0   # logit > 0 is prob > 0.5
        if self._last_mask is not None and self.min_iou_diff > 0:
            inter, union = torch.stack([(current_mask & self._last_mask).sum(),
                                        (current_mask | self._last_mask).sum()]).tolist()
            if union > 0 and inter / union > 1 - self.min_iou_diff:
                return [f_val, np.zeros_like(x)]
        self._last_mask = current_mask
        return [f_val, grad.cpu().numpy().astype(np.float64)]

    def unpack_scale_bias(self, x: torch.Tensor, bs: int):
        """x [2 * bs * C] -> (1 + scale [bs, C, 1, 1], bias [bs, C, 1, 1],
        the regulariser)."""
        scale, bias = x.chunk(2)
        reg = self.reg_weight * (scale.square().sum()
                                 + self.reg_bias_weight * bias.square().sum())
        if self.scale_act == "tanh":
            scale = torch.tanh(scale)
        elif self.scale_act == "sin":
            scale = torch.sin(scale)
        return 1 + scale.view(bs, -1, 1, 1), bias.view(bs, -1, 1, 1), reg


class InputOptimizer(ScaleBiasOptimizer):
    """(brs_functors.py:83-91) The optimised vector is an additive bias map;
    the search and its exits are ScaleBiasOptimizer's."""

    def unpack_bias(self, x: torch.Tensor, shape):
        """x -> (bias [bs (x2 with flip), C, h, w], the regulariser). The
        flipped batch member takes the bias mirrored over the image's
        width."""
        bias = x.view(shape)
        reg = self.reg_weight * bias.square().sum()
        if self.with_flip:
            bias = torch.cat([bias, bias.flip(3)])
        return bias, reg


def brs_mask_loss(result, pos_mask, neg_mask, eps=1e-5):
    """(brs_losses.py BRSMaskLoss) result and masks [B, H, W] ->
    (loss, max |1 - p| at positive clicks, max p at negative clicks)."""
    pos_diff = (1 - result) * pos_mask
    pos_target = pos_diff.square().sum() / (pos_mask.sum() + eps)
    neg_diff = result * neg_mask
    neg_target = neg_diff.square().sum() / (neg_mask.sum() + eps)
    return pos_target + neg_target, pos_diff.abs().max(), neg_diff.abs().max()


def click_maps_from_points(pts: torch.Tensor, h: int, w: int, radius: int = 1):
    """The click-consistency maps (brs.py:23-43) built on the device from
    the points: pts [B, 2K, 3], the positive block then the negative one,
    -1 padded, integer coordinates. A pixel of the [h, w] grid is set where
    |row - y| <= radius and |col - x| <= radius for some click. -> (pos,
    neg) [B, h, w] fp32."""
    k = pts.shape[1] // 2
    rows = torch.arange(h, dtype=torch.float32, device=pts.device)
    cols = torch.arange(w, dtype=torch.float32, device=pts.device)

    def block(p):
        valid = (p[..., 0] >= 0)[..., None]
        ry = ((rows - p[..., 0, None]).abs() <= radius) & valid
        rx = (cols - p[..., 1, None]).abs() <= radius
        return torch.einsum("bkh,bkw->bhw", ry.float(), rx.float()).clamp(max=1.0)

    return block(pts[:, :k]), block(pts[:, k:])


def map_points(clicks_lists: Sequence[Sequence[Click]], device) -> torch.Tensor:
    """Every click (no net_clicks_limit: the consistency maps cover all of
    them) as [B, 2K, 3] for click_maps_from_points, coordinates rounded as
    the reference's int(round(.)) rounds them."""
    k = max(1, max(len(cl) for cl in clicks_lists))
    pts = np.full((len(clicks_lists), 2 * k, 3), -1.0, np.float32)
    for i, cl in enumerate(clicks_lists):
        for first, block in ((0, [c for c in cl if c.is_positive]),
                             (k, [c for c in cl if not c.is_positive])):
            for j, c in enumerate(block):
                pts[i, first + j] = (round(c.coords[0]), round(c.coords[1]), 0)
    return torch.from_numpy(pts).to(device)


def padded_click_maps(clicks_lists, h, w, hp, wp, device):
    pos, neg = click_maps_from_points(map_points(clicks_lists, device), h, w)
    return pad_to(pos, hp, wp), pad_to(neg, hp, wp)


def _value_and_grad(objective, xv: np.ndarray, device):
    """objective(x) -> (loss, low-resolution logits, logits, f_max_pos,
    f_max_neg) at the float64 host vector xv -> (loss, its gradient by
    autograd, logits, f_max_pos, f_max_neg). One call is one span
    ritm.brs.evaluate."""
    x = torch.from_numpy(np.asarray(xv, np.float32)).to(device).requires_grad_()
    with span("ritm.brs.evaluate"), torch.enable_grad():
        loss, _, logits, fmp, fmn = objective(x)
        grad, = torch.autograd.grad(loss, x)
    return loss.detach(), grad, logits.detach(), fmp.detach(), fmn.detach()


def _consistency(functor, low, pos, neg, out_h, out_w, w):
    """Logits [B, Hp, Wp] of the low-resolution logits, and BRSMaskLoss over
    their probabilities (flip_average: the flipped member's probabilities
    mirrored over the image width w and averaged in)."""
    logits = bilinear_resize_align_corners_mm(low, out_h, out_w)[:, 0]
    result = torch.sigmoid(logits)
    if functor.with_flip and functor.flip_average:
        n = result.shape[0] // 2
        mirrored = torch.cat([result[n:, :, :w].flip(2), result[n:, :, w:]], 2)
        result, pos, neg = 0.5 * (result[:n] + mirrored), pos[:n], neg[:n]
    loss, fmp, fmn = brs_mask_loss(result, pos, neg)
    return loss, logits, fmp, fmn


def _drive_objective(objective):
    """A predictor's objective as lbfgs_drive's: x -> (loss, (the
    low-resolution logits [B, h, w], the mask logits > 0 [B, Hp, Wp], fmp,
    fmn)), as cutie_tpu's _objective_from returns them (brs.py:269-295,
    :522-540)."""
    def fn(x):
        loss, low, logits, fmp, fmn = objective(x)
        return loss, (low[:, 0], logits > 0, fmp, fmn)

    return fn


class _BRSPredictor(Predictor):
    """What both BRS predictors share: the functor, the click count after
    which they optimise, the driver (host_lbfgs: scipy on the host, else
    the device drive, cutie_tpu's default), and the optimised vector
    (opt_data: host float32 for scipy, a tensor on the model's device for
    the drive), which undo restores."""

    def __init__(self, model, *, opt_functor: ScaleBiasOptimizer,
                 optimize_after_n_clicks=1, host_lbfgs: bool = False, **kwargs):
        super().__init__(model, **kwargs)
        self.opt_functor = opt_functor
        self.optimize_after_n_clicks = optimize_after_n_clicks
        self.host_lbfgs = host_lbfgs
        self.opt_data = None

    def set_input_image(self, image):
        super().set_input_image(image)
        self.opt_data = None

    def get_states(self):
        states = super().get_states()
        v = self.opt_data
        states["opt_data"] = None if v is None else (
            v.clone() if isinstance(v, torch.Tensor) else v.copy())
        return states

    def set_states(self, states):
        super().set_states(states)
        self.opt_data = states.get("opt_data")

    def _zero_opt_data(self, n: int):
        """opt_data set to zeros [n] on the driver's side, unless it already
        has n entries."""
        if self.opt_data is None or self.opt_data.shape[0] != n:
            self.opt_data = (np.zeros((n,), np.float32) if self.host_lbfgs
                             else torch.zeros(n, device=self.device))

    def _opt_tensor(self) -> torch.Tensor:
        return torch.as_tensor(self.opt_data, device=self.device)

    def _drive(self, objective, hp, wp):
        """The device drive from opt_data over objective; keeps its end point and
        returns the best evaluation's logits [B, 1, Hp, Wp], upsampled once
        from the low resolution."""
        f = self.opt_functor
        f.drive_info = {}
        self.opt_data, best_low, f.n_evals = lbfgs_drive(
            _drive_objective(objective), self._opt_tensor(),
            maxfun=int(f.optimizer_params.get("maxfun", 20)), thresh=f.prob_thresh,
            min_iou_diff=f.min_iou_diff, info=f.drive_info)
        f.best_x = f.drive_info.pop("best_x")
        return bilinear_resize_align_corners(best_low[:, None], hp, wp)

    def _optimise(self, objective):
        """Run scipy's L-BFGS from opt_data over objective; keeps its end
        point and returns the best evaluation's logits."""
        self.opt_functor.init_click(lambda xv: _value_and_grad(objective, xv, self.device))
        self.opt_data = fmin_l_bfgs_b(func=self.opt_functor,
                                      x0=np.asarray(self.opt_data, np.float64),
                                      **self.opt_functor.optimizer_params)[0].astype(np.float32)
        return self.opt_functor.best_prediction


class HRNetFeatureBRSPredictor(_BRSPredictor):
    """(brs.py:157-252) insertion_mode 'A': scale and bias on the aggregated
    HRNet features before the OCR heads (f-BRS-A, f-BRS-B); 'C': on the OCR
    features before cls_head (f-BRS-C). The features (input_data) are
    computed once a click and cached; the first click runs the head with
    the current scale and bias (zero after a reset: the identity)."""

    def __init__(self, model, *, insertion_mode: str = "A", **kwargs):
        super().__init__(model, **kwargs)
        self.insertion_mode = insertion_mode
        if insertion_mode == "A":
            self.num_channels = sum(k * model.width for k in (1, 2, 4, 8))
        elif insertion_mode == "C":
            self.num_channels = 2 * model.ocr_width
        else:
            raise NotImplementedError(insertion_mode)
        self.input_data = None

    def set_input_image(self, image):
        super().set_input_image(image)
        self.input_data = None

    def _head_low(self, x, bs):
        """The head's logits [B, 1, Hp/4, Wp/4] on the cached features
        scaled and biased by x, and the regulariser."""
        scale, bias, reg = self.opt_functor.unpack_scale_bias(x, bs)
        if self.with_flip:
            scale, bias = torch.cat([scale, scale]), torch.cat([bias, bias])
        return self.model.head_from_feats_low(self.input_data * scale + bias,
                                              self.insertion_mode), reg

    def objective(self, pos, neg, out_h, out_w, w, bs):
        """x -> (loss + regulariser, low-resolution logits [B, 1, h, w],
        logits [B, Hp, Wp], f_max_pos, f_max_neg) (brs_functors ScaleBias +
        BRSMaskLoss)."""
        def fn(x):
            low, reg = self._head_low(x, bs)
            loss, logits, fmp, fmn = _consistency(self.opt_functor, low, pos, neg,
                                                  out_h, out_w, w)
            return loss + reg, low, logits, fmp, fmn

        return fn

    def _run_model(self, image_nd, points_nd, clicks_lists=None):
        if clicks_lists is None:
            return super()._run_model(image_nd, points_nd)
        num_clicks = len(clicks_lists[0])
        b, _, h, w = image_nd.shape
        bs = b // 2 if self.with_flip else b
        self._zero_opt_data(bs * 2 * self.num_channels)
        hp, wp = pad_hw(h, w)
        if num_clicks <= (self.net_clicks_limit or 1 << 30) or self.input_data is None:
            self.input_data = self.model.get_head_input(
                pad_to(image_nd, hp, wp), points_nd, self.insertion_mode)

        if num_clicks > self.optimize_after_n_clicks and not self.host_lbfgs:
            pos, neg = click_maps_from_points(map_points(clicks_lists, self.device), hp, wp)
            return self._drive(self.objective(pos, neg, hp, wp, w, bs), hp, wp)[:, :, :h, :w]
        if num_clicks > self.optimize_after_n_clicks:
            pos, neg = padded_click_maps(clicks_lists, h, w, hp, wp, self.device)
            best = self._optimise(self.objective(pos, neg, hp, wp, w, bs))
            if best is not None:
                return best[:, None, :h, :w]

        # not optimising (the first click, or undone below the threshold)
        low, _ = self._head_low(self._opt_tensor(), bs)
        return bilinear_resize_align_corners(low, hp, wp)[:, :, :h, :w]


class InputBRSPredictor(_BRSPredictor):
    """(brs.py:257-317) An additive bias on the network input, the
    normalised RGB ('rgb', RGB-BRS) or the click maps ('dmaps',
    DistMap-BRS), optimised through the whole forward. The optimised
    vector covers the image (bs x C x h x w), not its padding."""

    def __init__(self, model, *, optimize_target: str = "rgb", **kwargs):
        super().__init__(model, **kwargs)
        self.optimize_target = optimize_target
        self.num_channels = 3 if optimize_target == "rgb" else 2

    def objective(self, img, points, pos, neg, h, w, bs):
        """x -> (loss + regulariser, low-resolution logits, logits [B, Hp,
        Wp], f_max_pos, f_max_neg)."""
        hp, wp = img.shape[-2:]

        def fn(x):
            bias, reg = self.opt_functor.unpack_bias(x, (bs, self.num_channels, h, w))
            low = self.model.low_res_instances_with_input_bias(
                img, points, pad_to(bias, hp, wp), self.optimize_target)
            loss, logits, fmp, fmn = _consistency(self.opt_functor, low, pos, neg, hp, wp, w)
            return loss + reg, low, logits, fmp, fmn

        return fn

    def _run_model(self, image_nd, points_nd, clicks_lists=None):
        if clicks_lists is None:
            return super()._run_model(image_nd, points_nd)
        num_clicks = len(clicks_lists[0])
        b, _, h, w = image_nd.shape
        bs = b // 2 if self.with_flip else b
        self._zero_opt_data(bs * self.num_channels * h * w)
        hp, wp = pad_hw(h, w)
        img = pad_to(image_nd, hp, wp)
        if num_clicks > self.optimize_after_n_clicks and not self.host_lbfgs:
            pos, neg = click_maps_from_points(map_points(clicks_lists, self.device), hp, wp)
            return self._drive(self.objective(img, points_nd, pos, neg, h, w, bs),
                               hp, wp)[:, :, :h, :w]
        pos, neg = padded_click_maps(clicks_lists, h, w, hp, wp, self.device)
        objective = self.objective(img, points_nd, pos, neg, h, w, bs)
        best = self._optimise(objective) if num_clicks > self.optimize_after_n_clicks else None
        if best is None:
            best = objective(self._opt_tensor())[2]
        return best[:, None, :h, :w]
