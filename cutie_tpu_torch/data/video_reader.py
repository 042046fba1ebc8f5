"""Per-video frame readers for benchmark evaluation (the port's copy of
cutie_tpu/data/video_reader.py, reading images through utils/image_io in
place of PIL).

Behavioral parity targets:
  - cutie/inference/data/video_reader.py (VideoReader: P/RGB/L mask modes,
    24-bit long-id decode, shorter-edge resize, size_dir override,
    use_all_masks incremental-object loading)
  - cutie/inference/data/vos_test_dataset.py (VOSTestDataset: subset txt,
    YouTubeVOS meta.json required frames)
The shorter-edge resizes are Pillow's BILINEAR (frames) and NEAREST (masks),
bit for bit, in numpy (utils/image_io.py).
"""
from __future__ import annotations

import copy
import json
import os
from os import path
from typing import Dict, Iterable, List, Optional

import numpy as np

from cutie_tpu_torch.utils.image_io import (read_image, read_png,
                                            resize_bilinear, resize_nearest,
                                            resize_shorter)


class VideoReader:
    """Reads one video frame at a time; see module docstring for parity notes."""

    def __init__(self, vid_name: str, image_dir: str, mask_dir: str, *,
                 size: int = -1, to_save: Optional[List[str]] = None,
                 use_all_masks: bool = False, size_dir: Optional[str] = None,
                 start: int = -1, end: int = -1, reverse: bool = False,
                 enabled_frame_list: Optional[List[str]] = None):
        self.vid_name = vid_name
        self.image_dir = image_dir
        self.mask_dir = mask_dir
        self.to_save = to_save
        self.use_all_mask = use_all_masks
        self.size_dir = size_dir if size_dir is not None else image_dir
        self.size = size

        self.frames = sorted(os.listdir(self.image_dir))
        if enabled_frame_list is not None:
            self.frames = [f for f in self.frames if f[:-4] in enabled_frame_list]
        self._all_frames = copy.deepcopy(self.frames)
        if start >= 0:
            self.frames = self.frames[start:end] if end >= 0 else self.frames[start:]
        elif end >= 0:
            self.frames = self.frames[:end]
        if reverse:
            self.frames = list(reversed(self.frames))

        # P-mode palettes vs 24-bit RGB long ids vs plain L masks
        self.first_mask_frame = sorted(os.listdir(self.mask_dir))[0]
        _, mode, palette = read_png(path.join(self.mask_dir,
                                              self.first_mask_frame))
        if mode == "P":
            self.use_long_id = False
            self.palette = palette
        elif mode == "RGB":
            self.use_long_id = True
            self.palette = None
        elif mode == "L":
            self.use_long_id = False
            self.palette = None
        else:
            raise NotImplementedError(
                f"Unknown mode {mode} in {self.first_mask_frame}.")

    def __getitem__(self, idx: int) -> Dict:
        frame = self.frames[idx]
        info = {
            "frame": frame,
            "save": (self.to_save is None) or (frame[:-4] in self.to_save),
        }
        data: Dict = {}
        im_path = path.join(self.image_dir, frame)
        img = read_image(im_path)

        if self.image_dir == self.size_dir:
            output_shape = img.shape[:2]
            input_shape = output_shape
        else:
            output_shape = read_image(path.join(self.size_dir, frame)).shape[:2]
            input_shape = img.shape[:2]

        resize_needed = (input_shape != output_shape) or (
            self.size > 0 and min(input_shape) > self.size)
        if resize_needed:
            if self.size > 0:
                img = resize_shorter(img, self.size, bilinear=True)
            else:
                # size_dir override with full-res eval (size<0): match the
                # size_dir shape exactly (a shorter-edge resize to -1 would
                # compute negative dimensions)
                img = resize_bilinear(img, *output_shape)

        load_mask = self.use_all_mask or (frame[:-4] == self.first_mask_frame[:-4])
        if load_mask:
            mask_path = path.join(self.mask_dir, frame[:-4] + ".png")
            if path.exists(mask_path):
                mask = read_png(mask_path)[0]
                if resize_needed:
                    if self.size > 0:
                        mask = resize_shorter(mask, self.size, bilinear=False)
                    else:
                        mask = resize_nearest(mask, *output_shape)
                mask = mask.astype(np.int64)
                if self.use_long_id:
                    assert mask.ndim == 3, "RGB masks should have 3 dimensions"
                    mask = (mask[:, :, 0] + mask[:, :, 1] * 256 +
                            mask[:, :, 2] * 256 * 256)
                else:
                    assert mask.ndim == 2
                valid_labels = np.unique(mask)
                data["mask"] = mask
                data["valid_labels"] = valid_labels[valid_labels != 0]

        info["shape"] = output_shape
        info["resize_needed"] = resize_needed
        info["path_to_image"] = im_path
        # uint8 HWC: InferenceCore uploads this raw and converts on device
        data["rgb"] = img
        data["info"] = info
        return data

    def get_palette(self):
        return self.palette

    def __len__(self):
        return len(self.frames)


class VOSTestDataset:
    """DAVIS/YTVOS/MOSE/LVOS-style directory dataset."""

    def __init__(self, image_dir: str, mask_dir: str, *, use_all_masks: bool,
                 req_frames_json: Optional[str] = None, size: int = -1,
                 size_dir: Optional[str] = None, subset: Optional[str] = None):
        self.image_dir = image_dir
        self.mask_dir = mask_dir
        self.use_all_masks = use_all_masks
        self.size = size
        self.size_dir = size_dir

        if subset is None:
            self.vid_list = sorted(os.listdir(self.mask_dir))
        else:
            with open(subset) as f:
                self.vid_list = sorted(line.strip() for line in f)

        self.req_frame_list: Dict[str, List[str]] = {}
        if req_frames_json is not None:
            with open(req_frames_json) as f:
                meta = json.load(f)["videos"]
            for vid in self.vid_list:
                req_frames: List[str] = []
                for value in meta[vid]["objects"].values():
                    req_frames.extend(value["frames"])
                self.req_frame_list[vid] = list(set(req_frames))

    def get_datasets(self, process_index: int = 0,
                     process_count: int = 1) -> Iterable[VideoReader]:
        """Yield per-video readers; with process_count > 1 only every
        process_count-th video is CONSTRUCTED (VideoReader.__init__ does
        directory listings + opens the first mask — filtering afterwards
        would pay that I/O for every skipped video on every host)."""
        for vi, video in enumerate(self.vid_list):
            if vi % process_count != process_index:
                continue
            yield VideoReader(
                video,
                path.join(self.image_dir, video),
                path.join(self.mask_dir, video),
                size=self.size,
                to_save=self.req_frame_list.get(video),
                use_all_masks=self.use_all_masks,
                size_dir=(path.join(self.size_dir, video)
                          if self.size_dir is not None else None),
            )

    def __len__(self):
        return len(self.vid_list)
