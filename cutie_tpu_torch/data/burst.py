"""BURST dataset reader + result handler (COCO-RLE first-frame annotations;
the port's copy of cutie_tpu/data/burst.py, through utils/image_io).

Behavioral parity targets:
  - cutie/inference/data/burst_video_reader.py (skip_frames subsampling that
    keeps annotated frames, RLE mask composition)
  - cutie/inference/data/burst_test_dataset.py
  - cutie/inference/utils/burst_utils.py (BURSTResultHandler)
RLE decode/encode uses the numpy codec utils/rle.py instead of pycocotools.
"""
from __future__ import annotations

import copy
import json
from os import path
from typing import Dict, Iterable

import numpy as np

from cutie_tpu_torch.utils import rle as rle_codec
from cutie_tpu_torch.utils.image_io import read_image, resize_shorter
from cutie_tpu_torch.utils.palette import davis_palette


class BURSTVideoReader:
    def __init__(self, image_root: str, sequence_json: Dict, *,
                 size: int = -1, skip_frames: int = -1):
        self.sequence_json = sequence_json
        dataset = sequence_json["dataset"]
        self.vid_name = sequence_json["seq_name"]
        annotated_frames = sequence_json["annotated_image_paths"]
        self.annotated_frames = [f[:-4] for f in annotated_frames]

        self.image_dir = path.join(image_root, dataset, self.vid_name)
        self.frames = sequence_json["all_image_paths"]
        if skip_frames > 0:
            frames = set(self.frames[::skip_frames]).union(set(annotated_frames))
            self.frames = sorted(frames)
        self.size = size
        self.use_long_id = False

    def __getitem__(self, idx: int) -> Dict:
        frame = self.frames[idx]
        info = {"frame": frame, "save": frame[:-4] in self.annotated_frames}
        data: Dict = {}
        im_path = path.join(self.image_dir, frame)
        img = read_image(im_path)
        shape = img.shape[:2]
        if self.size > 0:
            img = resize_shorter(img, self.size, bilinear=True)

        if info["save"]:
            ann_idx = self.annotated_frames.index(frame[:-4])
            segmentations = self.sequence_json["segmentations"][ann_idx]
            if len(segmentations) > 0:
                valid_labels = np.array([int(k) for k in segmentations])
                mask = np.zeros(shape, dtype=np.uint8)
                for id, segment in segmentations.items():
                    obj = rle_codec.decode({"size": shape, "counts": segment["rle"]})
                    mask[obj == 1] = int(id)
                    assert int(id) <= 255, "Too many objects -- long id needed"
                if self.size > 0:
                    mask = resize_shorter(mask, self.size, bilinear=False)
                data["mask"] = mask.astype(np.int64)
                data["valid_labels"] = valid_labels

        info["shape"] = shape
        info["resize_needed"] = not (self.size < 0)
        info["time_index"] = idx
        info["path_to_image"] = im_path
        data["rgb"] = img
        data["info"] = info
        return data

    def get_palette(self):
        return davis_palette

    def __len__(self):
        return len(self.frames)


class BURSTTestDataset:
    def __init__(self, image_dir: str, json_dir: str, *, size: int = -1,
                 skip_frames: int = -1):
        self.image_dir = image_dir
        self.size = size
        self.skip_frames = skip_frames
        with open(json_dir) as f:
            self.json = json.load(f)
        self.sequences = self.json["sequences"]

    def get_datasets(self, process_index: int = 0,
                     process_count: int = 1) -> Iterable[BURSTVideoReader]:
        for vi, sequence in enumerate(self.sequences):
            if vi % process_count != process_index:
                continue
            yield BURSTVideoReader(self.image_dir, sequence, size=self.size,
                                   skip_frames=self.skip_frames)

    def __len__(self):
        return len(self.sequences)


class BURSTResultHandler:
    def __init__(self, dataset_json: Dict):
        self.dataset_json = copy.deepcopy(dataset_json)
        self.dataset_json["sequences"] = []

    def add_sequence(self, sequence_json: Dict) -> None:
        self.dataset_json["sequences"].append(sequence_json)

    def dump(self, root: str, suffix: str = "") -> None:
        """suffix distinguishes per-process files in multi-host eval (each
        handler holds a disjoint video shard)."""
        with open(path.join(root, f"predictions{suffix}.json"), "w") as f:
            json.dump(self.dataset_json, f)
