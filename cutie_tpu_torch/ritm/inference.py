"""RITM's interactive-segmentation inference stack.

The port's counterpart of cutie_tpu/ritm/inference.py (reference
gui/ritm/inference/clicker.py, transforms/{zoom_in,limit_longest_side,flip,
base}.py, predictors/base.py, controller.py, utils/misc.py):
  - Click and Clicker, with the automatic next click from the distance
    transforms of the false-negative and false-positive regions, computed
    by scipy's exact Euclidean distance transform where the reference calls
    cv2.distanceTransform(DIST_L2, 0);
  - the bbox helpers;
  - the transform cascade (ZoomIn, LimitLongestSide, SigmoidForPred,
    AddHorizontalFlip) on torch tensors on the model's device;
  - Predictor (NoBRS), get_predictor, InteractiveController.

The image, the transforms and the model's output stay on the model's
device; a click fetches its probabilities once, and the public API returns
numpy [1, 1, H, W]. The network input is zero-padded up to multiples of 64
on both sides and the logits cropped back, as cutie_tpu pads it: the
padding enters the result (border convolutions, the OCR context over every
pixel), so the port pads as cutie_tpu does.
"""
from __future__ import annotations

import contextlib
import math
from copy import deepcopy
from typing import List, Optional, Tuple

import numpy as np
import torch
from scipy.ndimage import distance_transform_edt

from cutie_tpu_torch.ops.resize import bilinear_resize_align_corners
from cutie_tpu_torch.utils.tracing import span

PAD_MULTIPLE = 64


def pad_hw(h: int, w: int) -> Tuple[int, int]:
    return (int(math.ceil(h / PAD_MULTIPLE) * PAD_MULTIPLE),
            int(math.ceil(w / PAD_MULTIPLE) * PAD_MULTIPLE))


def pad_to(x: torch.Tensor, hp: int, wp: int) -> torch.Tensor:
    """Zero-pad the last two axes at the bottom and right to (hp, wp)."""
    return torch.nn.functional.pad(x, (0, wp - x.shape[-1], 0, hp - x.shape[-2]))


# ------------------------------------------------------------------- clicks

class Click:
    def __init__(self, is_positive: bool, coords: Tuple[float, float], indx=None):
        self.is_positive = is_positive
        self.coords = coords
        self.indx = indx

    @property
    def coords_and_indx(self):
        return (*self.coords, self.indx)

    def copy(self, **kwargs):
        c = deepcopy(self)
        for k, v in kwargs.items():
            setattr(c, k, v)
        return c


def distance_transform(mask: np.ndarray) -> np.ndarray:
    """cv2.distanceTransform(mask, cv2.DIST_L2, 0) (the exact Euclidean
    distance of every nonzero pixel to the nearest zero pixel) as float32."""
    return distance_transform_edt(mask).astype(np.float32)


def box_distance_transform(mask: np.ndarray, box, padding: bool = True) -> np.ndarray:
    """distance_transform(mask) (of np.pad(mask, 1), cropped back, with
    padding) over box = (r0, r1, c0, c1), which holds every nonzero pixel
    of mask. It is computed on the box and a rim of one pixel around it,
    where the image has one: every pixel outside the box is 0, so a pixel's
    nearest 0 outside the rim is never nearer than the rim pixel between
    them (the nearest 0 clamped into the rimmed box), and the values are
    those of the whole image's."""
    r0, r1, c0, c1 = box
    if padding:
        return distance_transform(np.pad(mask[r0:r1, c0:c1], 1))[1:-1, 1:-1]
    h, w = mask.shape
    lr, lc = max(r0 - 1, 0), max(c0 - 1, 0)
    dt = distance_transform(mask[lr:min(r1 + 1, h), lc:min(c1 + 1, w)])
    return dt[r0 - lr:r1 - lr, c0 - lc:c1 - lc]


class Clicker:
    """(clicker.py:6-105)"""

    def __init__(self, gt_mask=None, init_clicks=None, ignore_label=-1,
                 click_indx_offset=0):
        self.click_indx_offset = click_indx_offset
        if gt_mask is not None:
            self.gt_mask = gt_mask == 1
            self.not_ignore_mask = gt_mask != ignore_label
        else:
            self.gt_mask = None
        self.reset_clicks()
        if init_clicks is not None:
            for click in init_clicks:
                self.add_click(click)

    def make_next_click(self, pred_mask):
        assert self.gt_mask is not None
        self.add_click(self._get_next_click(pred_mask))

    def get_clicks(self, clicks_limit=None):
        return self.clicks_list[:clicks_limit]

    def _get_next_click(self, pred_mask, padding=True) -> Click:
        """The click of clicker.py:47-70. Both distance maps are 0 outside
        the error regions' bounding box, so they are computed on the box
        alone (box_distance_transform), with the same values."""
        fn_mask = self.gt_mask & ~pred_mask & self.not_ignore_mask
        fp_mask = ~self.gt_mask & pred_mask & self.not_ignore_mask
        errors = fn_mask | fp_mask
        rows, cols = np.flatnonzero(errors.any(1)), np.flatnonzero(errors.any(0))
        if rows.size == 0:
            # both maps all 0: the first pixel of the negative map
            return Click(is_positive=False, coords=(0, 0))
        box = (rows[0], rows[-1] + 1, cols[0], cols[-1] + 1)
        not_clicked = self.not_clicked_map[box[0]:box[1], box[2]:box[3]]
        fn_dt = box_distance_transform(fn_mask, box, padding) * not_clicked
        fp_dt = box_distance_transform(fp_mask, box, padding) * not_clicked
        is_positive = fn_dt.max() > fp_dt.max()
        dt = fn_dt if is_positive else fp_dt
        if dt.max() == 0:
            return Click(is_positive=bool(is_positive), coords=(0, 0))
        ys, xs = np.where(dt == dt.max())
        return Click(is_positive=bool(is_positive),
                     coords=(int(box[0] + ys[0]), int(box[2] + xs[0])))

    def add_click(self, click: Click):
        click.indx = self.click_indx_offset + self.num_pos_clicks + self.num_neg_clicks
        if click.is_positive:
            self.num_pos_clicks += 1
        else:
            self.num_neg_clicks += 1
        self.clicks_list.append(click)
        if self.gt_mask is not None:
            self.not_clicked_map[click.coords[0], click.coords[1]] = False

    def reset_clicks(self):
        if self.gt_mask is not None:
            self.not_clicked_map = np.ones_like(self.gt_mask, dtype=bool)
        self.num_pos_clicks = 0
        self.num_neg_clicks = 0
        self.clicks_list: List[Click] = []

    def get_state(self):
        return deepcopy(self.clicks_list)

    def set_state(self, state):
        self.reset_clicks()
        for click in state:
            self.add_click(click)

    def __len__(self):
        return len(self.clicks_list)


# ------------------------------------------------------------- bbox helpers

def mask_extent(mask: torch.Tensor) -> Tuple[np.ndarray, np.ndarray]:
    """The rows and the columns of a [H, W] mask that hold a pixel, fetched
    to the host (all a bbox needs)."""
    return mask.any(1).cpu().numpy(), mask.any(0).cpu().numpy()


def _bbox_from_extent(rows, cols):
    rmin, rmax = np.where(rows)[0][[0, -1]]
    cmin, cmax = np.where(cols)[0][[0, -1]]
    return rmin, rmax, cmin, cmax


def expand_bbox(bbox, expand_ratio, min_crop_size=None):
    rmin, rmax, cmin, cmax = bbox
    rcenter = 0.5 * (rmin + rmax)
    ccenter = 0.5 * (cmin + cmax)
    height = expand_ratio * (rmax - rmin + 1)
    width = expand_ratio * (cmax - cmin + 1)
    if min_crop_size is not None:
        height = max(height, min_crop_size)
        width = max(width, min_crop_size)
    rmin = int(round(rcenter - height / 2))
    rmax = int(round(rcenter + height / 2))
    cmin = int(round(ccenter - width / 2))
    cmax = int(round(ccenter + width / 2))
    return rmin, rmax, cmin, cmax


def clamp_bbox(bbox, rmin, rmax, cmin, cmax):
    return (max(rmin, bbox[0]), min(rmax, bbox[1]),
            max(cmin, bbox[2]), min(cmax, bbox[3]))


def get_bbox_iou(b1, b2):
    return _segment_iou(b1[:2], b2[:2]) * _segment_iou(b1[2:4], b2[2:4])


def _segment_iou(s1, s2):
    a = max(s1[0], s2[0])
    b = min(s1[1], s2[1])
    inter = max(b - a + 1, 0)
    union = (s1[1] - s1[0] + 1) + (s2[1] - s2[0] + 1) - inter
    return inter / union


def get_object_roi(extent, clicks_list, expansion_ratio, min_crop_size):
    """The expanded bbox of a mask given by its extent (mask_extent), with
    the positive clicks' pixels set, clamped to the image."""
    rows, cols = (e.copy() for e in extent)
    for click in clicks_list:
        if click.is_positive:
            rows[int(click.coords[0])] = True
            cols[int(click.coords[1])] = True
    bbox = expand_bbox(_bbox_from_extent(rows, cols), expansion_ratio, min_crop_size)
    return clamp_bbox(bbox, 0, len(rows) - 1, 0, len(cols) - 1)


def get_roi_image_nd(image_nd, object_roi, target_size):
    rmin, rmax, cmin, cmax = object_roi
    height = rmax - rmin + 1
    width = cmax - cmin + 1
    if isinstance(target_size, tuple):
        nh, nw = target_size
    else:
        scale = target_size / max(height, width)
        nh, nw = int(round(height * scale)), int(round(width * scale))
    return bilinear_resize_align_corners(
        image_nd[:, :, rmin:rmax + 1, cmin:cmax + 1], nh, nw)


def check_object_roi(object_roi, clicks_list):
    for click in clicks_list:
        if click.is_positive:
            if not object_roi[0] <= click.coords[0] < object_roi[1]:
                return False
            if not object_roi[2] <= click.coords[1] < object_roi[3]:
                return False
    return True


# --------------------------------------------------------------- transforms

class BaseTransform:
    def __init__(self):
        self.image_changed = False

    def transform(self, image_nd, clicks_lists):
        raise NotImplementedError

    def inv_transform(self, prob_map):
        raise NotImplementedError

    def reset(self):
        pass

    def get_state(self):
        return None

    def set_state(self, state):
        pass


class SigmoidForPred(BaseTransform):
    def transform(self, image_nd, clicks_lists):
        return image_nd, clicks_lists

    def inv_transform(self, prob_map):
        return torch.sigmoid(prob_map)


class AddHorizontalFlip(BaseTransform):
    def transform(self, image_nd, clicks_lists):
        w = image_nd.shape[3]
        flipped = [[c.copy(coords=(c.coords[0], w - c.coords[1] - 1)) for c in cl]
                   for cl in clicks_lists]
        return torch.cat([image_nd, image_nd.flip(3)]), clicks_lists + flipped

    def inv_transform(self, prob_map):
        assert prob_map.shape[0] % 2 == 0
        n = prob_map.shape[0] // 2
        return 0.5 * (prob_map[:n] + prob_map[n:].flip(3))


class ZoomIn(BaseTransform):
    """(zoom_in.py:9-175)"""

    def __init__(self, target_size=400, skip_clicks=1, expansion_ratio=1.4,
                 min_crop_size=200, recompute_thresh_iou=0.5, prob_thresh=0.50):
        super().__init__()
        self.target_size = target_size
        self.min_crop_size = min_crop_size
        self.skip_clicks = skip_clicks
        self.expansion_ratio = expansion_ratio
        self.recompute_thresh_iou = recompute_thresh_iou
        self.prob_thresh = prob_thresh
        self.reset()

    def reset(self):
        self._input_image_shape = None
        self._prev_probs = None
        self._object_roi = None
        self._roi_image = None
        self.image_changed = False

    def transform(self, image_nd, clicks_lists):
        assert image_nd.shape[0] == 1 and len(clicks_lists) == 1
        self.image_changed = False
        clicks_list = clicks_lists[0]
        if len(clicks_list) <= self.skip_clicks:
            return image_nd, clicks_lists
        self._input_image_shape = tuple(image_nd.shape)

        current_object_roi = None
        if self._prev_probs is not None:
            extent = mask_extent(self._prev_probs[0, 0] > self.prob_thresh)
            if extent[0].any():
                current_object_roi = get_object_roi(extent, clicks_list,
                                                    self.expansion_ratio,
                                                    self.min_crop_size)
        if current_object_roi is None:
            if self.skip_clicks >= 0:
                return image_nd, clicks_lists
            current_object_roi = 0, image_nd.shape[2] - 1, 0, image_nd.shape[3] - 1

        update = (self._object_roi is None
                  or not check_object_roi(self._object_roi, clicks_list)
                  or get_bbox_iou(current_object_roi, self._object_roi)
                  < self.recompute_thresh_iou)
        if update:
            self._object_roi = current_object_roi
            self.image_changed = True
        self._roi_image = get_roi_image_nd(image_nd, self._object_roi, self.target_size)
        return self._roi_image, [self._transform_clicks(clicks_list)]

    def inv_transform(self, prob_map):
        if self._object_roi is None:
            self._prev_probs = prob_map
            return prob_map
        assert prob_map.shape[0] == 1
        rmin, rmax, cmin, cmax = self._object_roi
        prob_map = bilinear_resize_align_corners(prob_map, rmax - rmin + 1,
                                                 cmax - cmin + 1)
        if self._prev_probs is not None:
            new_prob_map = torch.zeros_like(self._prev_probs)
            new_prob_map[:, :, rmin:rmax + 1, cmin:cmax + 1] = prob_map
        else:
            new_prob_map = prob_map
        self._prev_probs = new_prob_map
        return new_prob_map

    def check_possible_recalculation(self):
        if (self._prev_probs is None or self._object_roi is not None
                or self.skip_clicks > 0):
            return False
        extent = mask_extent(self._prev_probs[0, 0] > self.prob_thresh)
        if extent[0].any():
            roi = get_object_roi(extent, [], self.expansion_ratio, self.min_crop_size)
            image_roi = (0, self._input_image_shape[2] - 1, 0,
                         self._input_image_shape[3] - 1)
            if get_bbox_iou(roi, image_roi) < 0.50:
                return True
        return False

    def get_state(self):
        return (self._input_image_shape, self._object_roi, self._prev_probs,
                self._roi_image, self.image_changed)

    def set_state(self, state):
        (self._input_image_shape, self._object_roi, self._prev_probs,
         self._roi_image, self.image_changed) = state

    def _transform_clicks(self, clicks_list):
        if self._object_roi is None:
            return clicks_list
        rmin, rmax, cmin, cmax = self._object_roi
        ch, cw = self._roi_image.shape[2:]
        return [click.copy(coords=(ch * (click.coords[0] - rmin) / (rmax - rmin + 1),
                                   cw * (click.coords[1] - cmin) / (cmax - cmin + 1)))
                for click in clicks_list]


class LimitLongestSide(ZoomIn):
    """(limit_longest_side.py)"""

    def __init__(self, max_size=800):
        super().__init__(target_size=max_size, skip_clicks=0)

    def transform(self, image_nd, clicks_lists):
        assert image_nd.shape[0] == 1 and len(clicks_lists) == 1
        self.image_changed = False
        if max(image_nd.shape[2:4]) <= self.target_size:
            return image_nd, clicks_lists
        self._input_image_shape = tuple(image_nd.shape)
        self._object_roi = (0, image_nd.shape[2] - 1, 0, image_nd.shape[3] - 1)
        self._roi_image = get_roi_image_nd(image_nd, self._object_roi, self.target_size)
        self.image_changed = True
        return self._roi_image, [self._transform_clicks(clicks_lists[0])]


# ---------------------------------------------------------------- predictor

class Predictor:
    """(predictors/base.py:7-133) NoBRS. The image is a [C, H, W] (or
    [1, C, H, W]) array in [0, 1]; get_prediction returns numpy
    [1, 1, H, W] probabilities."""

    def __init__(self, model, *, net_clicks_limit=None, with_flip=False,
                 zoom_in: Optional[ZoomIn] = None, max_size=None):
        self.net_clicks_limit = net_clicks_limit
        self.with_flip = with_flip
        self.zoom_in = zoom_in
        self.model = model
        self.device = next(model.parameters()).device
        self.with_prev_mask = model.with_prev_mask
        self.original_image = None
        self.prev_prediction = None
        self.transforms: List[BaseTransform] = []
        if zoom_in is not None:
            self.transforms.append(zoom_in)
        if max_size is not None:
            self.transforms.append(LimitLongestSide(max_size=max_size))
        self.transforms.append(SigmoidForPred())
        if with_flip:
            self.transforms.append(AddHorizontalFlip())

    def set_input_image(self, image):
        for t in self.transforms:
            t.reset()
        image = torch.as_tensor(np.asarray(image, np.float32)).to(self.device)
        self.original_image = image[None] if image.ndim == 3 else image
        self.prev_prediction = torch.zeros_like(self.original_image[:, :1])

    def get_prediction(self, clicker: Clicker, prev_mask=None) -> np.ndarray:
        if prev_mask is not None:
            prev_mask = torch.as_tensor(np.asarray(prev_mask, np.float32)).to(self.device)
            if prev_mask.ndim == 2:
                prev_mask = prev_mask[None, None]
        with torch.no_grad():
            prediction = self._predict(clicker, prev_mask)
        return prediction.cpu().numpy()

    def _predict(self, clicker: Clicker, prev_mask=None) -> torch.Tensor:
        clicks_list = clicker.get_clicks()
        input_image = self.original_image
        if prev_mask is None:
            prev_mask = self.prev_prediction
        if self.with_prev_mask:
            input_image = torch.cat([input_image, prev_mask], 1)
        image_nd, clicks_lists = self._apply_transforms(input_image, [clicks_list])
        pred_logits = self._run_model(image_nd, self._get_points_nd(clicks_lists),
                                      clicks_lists=clicks_lists)
        prediction = bilinear_resize_align_corners(pred_logits, *image_nd.shape[2:])
        for t in reversed(self.transforms):
            with self._span_of(t):
                prediction = t.inv_transform(prediction)
        if self.zoom_in is not None and self.zoom_in.check_possible_recalculation():
            return self._predict(clicker)
        self.prev_prediction = prediction
        return prediction

    def _run_model(self, image_nd, points_nd, clicks_lists=None) -> torch.Tensor:
        """Logits [B, 1, H, W] of the padded input, cropped back; clicks_lists
        is for the BRS predictors."""
        h, w = image_nd.shape[2:]
        hp, wp = pad_hw(h, w)
        low = self.model.low_res_instances(pad_to(image_nd, hp, wp), points_nd)
        return bilinear_resize_align_corners(low, hp, wp)[:, :, :h, :w]

    def _apply_transforms(self, image_nd, clicks_lists):
        for t in self.transforms:
            with self._span_of(t):
                image_nd, clicks_lists = t.transform(image_nd, clicks_lists)
        return image_nd, clicks_lists

    def _span_of(self, t: BaseTransform):
        """The span ritm.zoom_in around the zoom-in's transform and inverse;
        the other transforms run in their caller's span."""
        return span("ritm.zoom_in") if t is self.zoom_in else contextlib.nullcontext()

    def _get_points_nd(self, clicks_lists) -> torch.Tensor:
        """[B, 2 * K, 3]: each list's positive clicks, then its negative ones,
        each block padded with (-1, -1, -1) to K, the larger count (at most
        net_clicks_limit)."""
        total_clicks = []
        num_pos = [sum(c.is_positive for c in cl) for cl in clicks_lists]
        num_neg = [len(cl) - p for cl, p in zip(clicks_lists, num_pos)]
        num_max = max(num_pos + num_neg)
        if self.net_clicks_limit is not None:
            num_max = min(self.net_clicks_limit, num_max)
        num_max = max(1, num_max)
        for cl in clicks_lists:
            cl = cl[:self.net_clicks_limit]
            pos = [c.coords_and_indx for c in cl if c.is_positive]
            pos = pos + (num_max - len(pos)) * [(-1, -1, -1)]
            neg = [c.coords_and_indx for c in cl if not c.is_positive]
            neg = neg + (num_max - len(neg)) * [(-1, -1, -1)]
            total_clicks.append(pos[:num_max] + neg[:num_max])
        return torch.tensor(total_clicks, dtype=torch.float32, device=self.device)

    def get_states(self):
        return {"transform_states": [t.get_state() for t in self.transforms],
                "prev_prediction": self.prev_prediction}

    def set_states(self, states):
        for s, t in zip(states["transform_states"], self.transforms):
            t.set_state(s)
        self.prev_prediction = states["prev_prediction"]


def get_predictor(model, brs_mode: str = "NoBRS", *, prob_thresh=0.49,
                  with_flip=True, zoom_in_params=None, predictor_params=None,
                  brs_opt_func_params=None, lbfgs_params=None):
    """(predictors/__init__.py:8-108) brs_mode: 'NoBRS', 'f-BRS-A', 'f-BRS-B'
    and 'f-BRS-C' (scale and bias on HRNet's features: A and B at insertion
    point 'A', C at 'C'), 'RGB-BRS', 'DistMap-BRS' (an additive bias on the
    input, through the whole forward)."""
    zoom_in = ZoomIn(**zoom_in_params) if zoom_in_params is not None else None
    params = {"with_flip": with_flip, "zoom_in": zoom_in}
    if predictor_params:
        params.update(predictor_params)

    if brs_mode == "NoBRS":
        return Predictor(model, **params)
    if brs_mode.startswith("f-BRS"):
        from cutie_tpu_torch.ritm.brs import HRNetFeatureBRSPredictor, ScaleBiasOptimizer
        params.setdefault("net_clicks_limit", 8)
        opt_functor = ScaleBiasOptimizer(optimizer_params=lbfgs_params,
                                         prob_thresh=prob_thresh, with_flip=with_flip,
                                         **(brs_opt_func_params or {}))
        return HRNetFeatureBRSPredictor(
            model, opt_functor=opt_functor,
            insertion_mode="C" if brs_mode == "f-BRS-C" else "A", **params)
    if brs_mode in ("RGB-BRS", "DistMap-BRS"):
        from cutie_tpu_torch.ritm.brs import InputBRSPredictor, InputOptimizer
        params.setdefault("net_clicks_limit", 5)
        opt_functor = InputOptimizer(optimizer_params=lbfgs_params,
                                     prob_thresh=prob_thresh, with_flip=with_flip,
                                     **(brs_opt_func_params or {}))
        return InputBRSPredictor(
            model, opt_functor=opt_functor,
            optimize_target="dmaps" if brs_mode == "DistMap-BRS" else "rgb", **params)
    raise NotImplementedError(brs_mode)


# --------------------------------------------------------------- controller

class InteractiveController:
    """The click state machine with undo (gui/ritm/controller.py:12-110).
    Probabilities are numpy [1, 1, H, W]."""

    def __init__(self, model, predictor_params, prob_thresh=0.5):
        self.model = model
        self.prob_thresh = prob_thresh
        self.clicker = Clicker()
        self.states = []
        self.probs_history = []
        self.object_count = 0
        self._result_mask = None
        self.image = None
        self.predictor = None
        self.predictor_params = predictor_params
        self.reset_predictor()

    def set_image(self, image: np.ndarray):
        """image: [C, H, W] float in [0, 1]."""
        self.image = np.asarray(image, np.float32)
        self._result_mask = np.zeros(image.shape[-2:], np.uint8)
        self.object_count = 0
        self.reset_last_object()

    def add_click(self, x, y, is_positive, prev_mask=None) -> np.ndarray:
        self.states.append({"clicker": self.clicker.get_state(),
                            "predictor": self.predictor.get_states()})
        self.clicker.add_click(Click(is_positive=is_positive, coords=(y, x)))
        pred = self.predictor.get_prediction(self.clicker, prev_mask=prev_mask)
        if self.probs_history:
            self.probs_history.append((self.probs_history[-1][0], pred))
        else:
            self.probs_history.append((np.zeros_like(pred), pred))
        return pred

    def undo_click(self):
        if not self.states:
            return
        prev = self.states.pop()
        self.clicker.set_state(prev["clicker"])
        self.predictor.set_states(prev["predictor"])
        self.probs_history.pop()

    def partially_finish_object(self):
        object_prob = self.current_object_prob
        if object_prob is None:
            return
        self.probs_history.append((object_prob, np.zeros_like(object_prob)))
        self.states.append(self.states[-1])
        self.clicker.reset_clicks()
        self.reset_predictor()

    def finish_object(self):
        object_prob = self.current_object_prob
        if object_prob is None:
            return
        self.object_count += 1
        self._result_mask[object_prob[0, 0] > self.prob_thresh] = self.object_count
        self.reset_last_object()

    def reset_last_object(self):
        self.states = []
        self.probs_history = []
        self.clicker.reset_clicks()
        self.reset_predictor()

    def reset_predictor(self, predictor_params=None):
        if predictor_params is not None:
            self.predictor_params = predictor_params
        params = dict(self.predictor_params)
        brs_mode = params.pop("brs_mode", "NoBRS")
        zoom_in_params = params.pop("zoom_in_params", None)
        inner = params.pop("predictor_params", None)
        brs_opt_func_params = params.pop("brs_opt_func_params", None)
        lbfgs_params = params.pop("lbfgs_params", None)
        self.predictor = get_predictor(
            self.model, brs_mode,
            prob_thresh=params.pop("prob_thresh", 0.49),
            with_flip=params.pop("with_flip", True),
            zoom_in_params=zoom_in_params,
            predictor_params={**params, **(inner or {})},
            brs_opt_func_params=brs_opt_func_params,
            lbfgs_params=lbfgs_params)
        if self.image is not None:
            self.predictor.set_input_image(self.image)

    @property
    def current_object_prob(self):
        if self.probs_history:
            total, additive = self.probs_history[-1]
            return np.maximum(total, additive)
        return None

    @property
    def is_incomplete_mask(self):
        return len(self.probs_history) > 0

    @property
    def result_mask(self):
        return self._result_mask.copy()

