"""Main-training VOS dataset with sequence merging.

The port's counterpart of cutie_tpu/data/vos_dataset.py (reference
cutie/dataset/vos_dataset.py:20-339), without PIL or cv2: the same draws
from the same np.random.Generator and the same pixels. Seed-frame
expansion under a max_skip window with retry budgets, 50% time reversal,
empty-first-frame rejection through the empty-mask lists, shared-parameter
dual transforms (hflip + affine deg25/shear20 + RandomResizedCrop scale
0.36-1), the Gaussian-blurred alpha merge of two sequences, and object
subsampling to max_num_obj.

get() returns rgb [T, 3, H, W] float32 (channels first), first_frame_gt
[O, H, W], cls_gt [T, H, W], selector [O] and info.
"""
from __future__ import annotations

import logging
import os
from os import path
from typing import Dict, List, Optional, Tuple

import numpy as np

from cutie_tpu_torch.data import augment as A
from cutie_tpu_torch.utils.image_io import read_image, read_mask

log = logging.getLogger(__name__)


class VOSMergeTrainDataset:
    def __init__(self, data_configs: Dict[str, Dict], seq_length=3, max_num_obj=3,
                 size=480, merge_probability=0.0):
        self.configs = data_configs
        self.seq_length = seq_length
        self.max_num_obj = max_num_obj
        self.size = size
        self.merge_probability = merge_probability

        self.max_crop_trials = 5
        self.max_seed_trials = 5
        self.max_seq_trials = 100

        self.frames: Dict[str, Dict[str, List[str]]] = {}
        self.videos: Dict[str, List[str]] = {}
        self.video_frames: List[Tuple[str, str, int]] = []

        for dataset, config in data_configs.items():
            self.frames[dataset] = {}
            self.videos[dataset] = []
            im_root, subset = config["im_root"], config["subset"]
            for vid in sorted(os.listdir(im_root)):
                if subset is not None and vid not in subset:
                    continue
                frames = sorted(os.listdir(path.join(im_root, vid)))
                if len(frames) < seq_length:
                    continue
                self.frames[dataset][vid] = frames
                self.videos[dataset].append(vid)
                self.video_frames.extend(
                    [(dataset, vid, i) for i in range(len(frames))]
                    * config["multiplier"])
            log.info("%s: %d videos used.", dataset, len(self.videos[dataset]))
        log.info("Total number of video-frames: %d.", len(self.video_frames))

    # ------------------------------------------------------------- sampling

    def _sample_frame_indices(self, rng, length: int, seed_idx: int,
                              max_skip: int) -> List[int]:
        """Expand a seed frame into seq_length indices where consecutive picks
        stay within max_skip of some already-picked frame
        (vos_dataset.py:165-185)."""
        sampled = [seed_idx]
        acceptable = set(range(max(0, seed_idx - max_skip),
                               min(length, seed_idx + max_skip + 1))) - set(sampled)
        while len(sampled) < self.seq_length:
            idx = int(rng.choice(sorted(acceptable)))
            sampled.append(idx)
            new_set = set(range(max(0, idx - max_skip),
                                min(length, idx + max_skip + 1)))
            acceptable = (acceptable | new_set) - set(sampled)
        sampled = sorted(sampled)
        if rng.uniform() < 0.5:
            sampled = sampled[::-1]
        return sampled

    def _apply_seq_transform(self, rng_seed: int, img: np.ndarray,
                             nearest: bool) -> np.ndarray:
        """Shared-seed sequence transform: hflip + affine + resized crop."""
        rng = np.random.default_rng(rng_seed)
        flip = rng.uniform() < 0.5
        angle, scale, shear = A.sample_affine_params(rng, 25, None, 20)
        if flip:
            img = img[:, ::-1]
        img = A.apply_affine(img, angle, scale, shear,
                             fill=(0 if nearest else A.IM_MEAN), nearest=nearest)
        top, left, ch, cw = A.sample_resized_crop(rng, *img.shape[:2],
                                                  scale=(0.36, 1.0))
        return A.apply_resized_crop(img, top, left, ch, cw, self.size, nearest)

    def _get_sample(self, rng: np.random.Generator, idx: Optional[int] = None):
        if idx is None:
            idx = int(rng.integers(len(self.video_frames)))
        dataset, video, frame_idx = self.video_frames[idx]

        while True:
            config = self.configs[dataset]
            empty_masks = (config["empty_masks"].get(video)
                           if config["empty_masks"] else None)
            im_path = path.join(config["im_root"], video)
            gt_path = path.join(config["gt_root"], video)
            frames = self.frames[dataset][video]
            length = len(frames)
            this_max_skip = min(length, config["max_skip"])
            info = {"name": video}
            seed_idx = frame_idx

            for seed_trial in range(self.max_seed_trials):
                seed_ok = True
                # find an admissible (non-empty first frame) sequence
                frames_idx = None
                for seq_trial in range(self.max_seq_trials):
                    cand = self._sample_frame_indices(rng, length, seed_idx,
                                                      this_max_skip)
                    if (empty_masks is None
                            or frames[cand[0]][:-4] not in empty_masks):
                        frames_idx = cand
                        break
                if frames_idx is None:
                    seed_ok = False

                if seed_ok:
                    info["frames"] = []
                    images, masks = [], []
                    sequence_seed = int(rng.integers(2 ** 31))
                    for i, f_idx in enumerate(frames_idx):
                        jpg_name = frames[f_idx][:-4] + ".jpg"
                        png_name = frames[f_idx][:-4] + ".png"
                        info["frames"].append(jpg_name)
                        gt = read_mask(path.join(gt_path, png_name), "P")
                        if i == 0:
                            # find a non-empty crop for the first frame
                            for crop_trial in range(self.max_crop_trials):
                                this_gt = self._apply_seq_transform(
                                    sequence_seed, gt, nearest=True)
                                if this_gt.max() > 0:
                                    break
                                if crop_trial >= self.max_crop_trials - 1:
                                    seed_ok = False
                                    break
                                sequence_seed = int(rng.integers(2 ** 31))
                        else:
                            this_gt = self._apply_seq_transform(
                                sequence_seed, gt, nearest=True)
                        if not seed_ok:
                            break
                        im = read_image(path.join(im_path, jpg_name))
                        this_im = self._apply_seq_transform(sequence_seed, im,
                                                            nearest=False)
                        this_im = A.color_jitter(
                            np.random.default_rng(sequence_seed + 1),
                            this_im, 0.1, 0.03, 0.03, 0)
                        if np.random.default_rng(sequence_seed + 2).uniform() < 0.05:
                            this_im = A.to_gray(this_im)
                        this_im = A.color_jitter(
                            np.random.default_rng(int(rng.integers(2 ** 31))),
                            this_im, 0.1, 0.05, 0.05, 0)
                        images.append(this_im.astype(np.float32) / 255.0)
                        masks.append(this_gt)

                if seed_ok:
                    return info, np.stack(images), np.stack(masks)
                if seed_trial == self.max_seed_trials - 1:
                    break
                seed_idx = int(rng.integers(length))

            # this video failed: pick a fresh one
            idx = int(rng.integers(len(self.video_frames)))
            dataset, video, frame_idx = self.video_frames[idx]

    # --------------------------------------------------------------- output

    def get(self, idx: int, rng: np.random.Generator) -> Dict:
        info, images, masks = self._get_sample(rng, idx)
        labels = np.unique(masks[0])
        labels = labels[labels != 0].tolist()

        # two-sequence merge (vos_dataset.py:286-300)
        if len(labels) < self.max_num_obj and rng.uniform() < self.merge_probability:
            _, images2, masks2 = self._get_sample(rng)
            labels2 = np.unique(masks2[0])
            for l2 in labels2[labels2 != 0].tolist():
                obj_masks2 = masks2 == l2
                blur = A.gaussian_blur_5x5(
                    obj_masks2.astype(np.float32).transpose(1, 2, 0))
                blur = blur.transpose(2, 0, 1)[..., None]
                images = images * (1 - blur) + images2 * blur
                new_label = (l2 + 10) % 255
                while new_label in labels:
                    new_label = (new_label + 1) % 255
                masks[obj_masks2] = new_label
                labels.append(new_label)

        labels = np.unique(masks[0])
        target_objects = labels[labels != 0].tolist()
        if not target_objects:
            raise RuntimeError(f"{info['name']}: no object in the first frame "
                               f"after the retries")
        if len(target_objects) > self.max_num_obj:
            target_objects = list(rng.choice(target_objects,
                                             size=self.max_num_obj, replace=False))
        info["num_objects"] = max(1, len(target_objects))

        cls_gt = np.zeros((self.seq_length, self.size, self.size), np.int64)
        first_frame_gt = np.zeros((self.max_num_obj, self.size, self.size),
                                  np.float32)
        for i, l in enumerate(target_objects):
            this_mask = masks == l
            cls_gt[this_mask] = i + 1
            first_frame_gt[i] = this_mask[0]

        selector = (np.arange(self.max_num_obj)
                    < info["num_objects"]).astype(np.float32)
        return {
            "rgb": np.ascontiguousarray(images.transpose(0, 3, 1, 2)),
            "first_frame_gt": first_frame_gt,
            "cls_gt": cls_gt,
            "selector": selector,
            "info": info,
        }

    def __len__(self):
        return len(self.video_frames)
