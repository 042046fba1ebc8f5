"""Pre-training on static images: pseudo-videos made by deformation.

The port's counterpart of cutie_tpu/data/static_dataset.py (reference
cutie/dataset/static_dataset.py:19-194), without PIL or cv2: the same
draws from the same np.random.Generator, the same pixels (images through
utils/image_io.py, transforms through data/augment.py). Sequence-level
transforms (scale affine, hflip, jitter, grayscale) are shared across the
clip, frame-level ones (affine deg20/scale0.5-2/shear10, resize, random
crop, jitter) drawn per frame, a TPS warp a third of the time, and extra
objects composited from other images.

get() returns rgb [T, 3, H, W] float32 (channels first), first_frame_gt
[O, H, W], cls_gt [T, H, W], selector [O] and info.
"""
from __future__ import annotations

import logging
import os
from os import path
from typing import Dict, List, Tuple

import numpy as np

from cutie_tpu_torch.data import augment as A
from cutie_tpu_torch.utils.image_io import read_image, read_mask

log = logging.getLogger(__name__)


class SyntheticVideoDataset:
    def __init__(self, parameters: List[Tuple[str, int, int]], *, size=384,
                 seq_length=3, max_num_obj=1):
        self.seq_length = seq_length
        self.max_num_obj = max_num_obj
        self.size = size

        self.im_list: List[str] = []
        for root, method, multiplier in parameters:
            if method == 0:  # FSS style: class/1.jpg + class/1.png
                for c in sorted(os.listdir(root)):
                    imgs = os.listdir(path.join(root, c))
                    jpgs = [im for im in imgs if im[-3:].lower() == "jpg"]
                    self.im_list.extend(
                        [path.join(root, c, im) for im in jpgs] * multiplier)
            elif method == 1:  # flat style: XXX.jpg + XXX.png
                self.im_list.extend(
                    [path.join(root, im) for im in sorted(os.listdir(root))
                     if ".jpg" in im] * multiplier)
        log.info("SyntheticVideoDataset: %d images found.", len(self.im_list))

    def _get_sample(self, idx: int, rng: np.random.Generator):
        im = read_image(self.im_list[idx])
        gt = read_mask(self.im_list[idx][:-3] + "png", "L")

        # sequence-level params, shared by all frames
        seq_angle, seq_scale, seq_shear = A.sample_affine_params(
            rng, 0, (0.5, 2.0), 0)
        seq_flip = rng.uniform() < 0.5
        # one seed for the whole clip: the reference reseeds the sequence
        # jitter to the same value every frame (static_dataset.py:117-119)
        seq_jitter_seed = int(rng.integers(2 ** 31))
        gray = rng.uniform() < 0.05

        images, masks = [], []
        for _ in range(self.seq_length):
            this_im, this_gt = im, gt
            if seq_flip:
                this_im, this_gt = this_im[:, ::-1], this_gt[:, ::-1]
            this_im = A.apply_affine(this_im, seq_angle, seq_scale, seq_shear,
                                     fill=A.IM_MEAN, nearest=False)
            this_gt = A.apply_affine(this_gt, seq_angle, seq_scale, seq_shear,
                                     fill=0, nearest=True)
            jr = np.random.default_rng(seq_jitter_seed)
            this_im = A.color_jitter(jr, this_im, 0.1, 0.05, 0.05, 0.05)
            if gray:
                this_im = A.to_gray(this_im)

            # frame-level: affine -> resize shorter -> random crop (+ jitter)
            f_angle, f_scale, f_shear = A.sample_affine_params(
                rng, 20, (0.5, 2.0), 10)
            this_im = A.apply_affine(this_im, f_angle, f_scale, f_shear,
                                     fill=A.IM_MEAN, nearest=False)
            this_gt = A.apply_affine(this_gt, f_angle, f_scale, f_shear,
                                     fill=0, nearest=True)
            this_im = A.resize_shorter_np(this_im, self.size, nearest=False)
            this_gt = A.resize_shorter_np(this_gt, self.size, nearest=True)
            this_im = A.pad_to_min(this_im, self.size, A.IM_MEAN)
            this_gt = A.pad_to_min(this_gt, self.size, 0)
            top, left = A.sample_crop(rng, *this_im.shape[:2], self.size)
            this_im = this_im[top:top + self.size, left:left + self.size]
            this_gt = this_gt[top:top + self.size, left:left + self.size]
            this_im = A.color_jitter(np.random.default_rng(rng.integers(2 ** 31)),
                                     this_im, 0.1, 0.05, 0.05, 0)

            # TPS only some of the time (speed; static_dataset.py:127-130)
            if rng.uniform() < 0.33:
                this_im, this_gt = A.random_tps_warp(rng, this_im, this_gt,
                                                     scale=0.02)
            images.append(this_im.astype(np.float32) / 255.0)
            # keep the continuous mask: saliency GTs have soft boundaries
            # and the reference composites with soft alpha
            # (static_dataset.py:160); labels binarize at > 0.5 in get()
            masks.append(this_gt.astype(np.float32) / 255.0)

        return np.stack(images), np.stack(masks)

    def get(self, idx: int, rng: np.random.Generator) -> Dict:
        additional_objects = int(rng.integers(self.max_num_obj))
        indices = [idx] + list(rng.integers(len(self), size=additional_objects))

        merged_images = None
        merged_masks = np.zeros((self.seq_length, self.size, self.size), np.int64)
        for i, list_id in enumerate(indices):
            images, masks = self._get_sample(int(list_id), rng)
            m = masks[..., None]
            if merged_images is None:
                merged_images = images
            else:
                merged_images = merged_images * (1 - m) + images * m
            merged_masks[masks > 0.5] = i + 1

        labels = np.unique(merged_masks[0])
        target_objects = labels[labels != 0].tolist()

        cls_gt = np.zeros((self.seq_length, self.size, self.size), np.int64)
        first_frame_gt = np.zeros((self.max_num_obj, self.size, self.size),
                                  np.float32)
        for i, l in enumerate(target_objects):
            this_mask = merged_masks == l
            cls_gt[this_mask] = i + 1
            first_frame_gt[i] = this_mask[0]

        num_objects = max(1, len(target_objects))
        selector = (np.arange(self.max_num_obj) < num_objects).astype(np.float32)
        return {
            "rgb": np.ascontiguousarray(merged_images.transpose(0, 3, 1, 2)),
            "first_frame_gt": first_frame_gt,
            "cls_gt": cls_gt,
            "selector": selector,
            "info": {"name": self.im_list[idx], "num_objects": num_objects},
        }

    def __len__(self):
        return len(self.im_list)
