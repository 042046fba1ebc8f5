"""Result saving: background saver thread, palette/long-id PNGs, BURST RLE
JSON, score dumps, blended visualizations, benchmark zips (the port's copy
of cutie_tpu/utils/results.py).

Behavioral parity target: reference cutie/inference/utils/results_utils.py:30-256.
Differences: process() takes the step's probability tensor on its device,
resizes it there and takes the argmax there, and copies only the id map
(and, with save_scores, the uint8 scores) to the host; score dumps are
.npz (scripts/merge_multi_scale.py reads them); PNGs are written by
utils/image_io.py, and Pillow is needed only for the JPEG visualizations;
RLE encoding uses utils/rle.py.
"""
from __future__ import annotations

import copy
import logging
import os
import shutil
from dataclasses import dataclass
from os import path
from queue import Queue
from threading import Thread
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from cutie_tpu_torch.inference.object_manager import ObjectInfo, ObjectManager
from cutie_tpu_torch.ops.resize import bilinear_resize
from cutie_tpu_torch.utils import rle as rle_codec
from cutie_tpu_torch.utils.image_io import (read_image, require_pillow,
                                            write_jpeg, write_png)
from cutie_tpu_torch.utils.palette import ID2RGBConverter, davis_palette_np

log = logging.getLogger(__name__)


class ResultSaver:
    def __init__(self, output_root, video_name, *, dataset,
                 object_manager: ObjectManager, use_long_id, palette=None,
                 save_mask=True, save_scores=False, score_output_root=None,
                 visualize_output_root=None, visualize=False, init_json=None):
        self.output_root = output_root
        self.video_name = video_name
        self.dataset = dataset.lower()
        self.use_long_id = use_long_id
        self.palette = palette
        self.object_manager = object_manager
        self.save_mask = save_mask
        self.save_scores = save_scores
        self.score_output_root = score_output_root
        self.visualize_output_root = visualize_output_root
        self.visualize = visualize

        if self.visualize:
            require_pillow()   # here, not first in the saver thread
            if self.palette is not None:
                self.colors = np.array(self.palette, dtype=np.uint8).reshape(-1, 3)
            else:
                self.colors = davis_palette_np

        self.need_remapping = True
        self.json_style = None
        self.id2rgb_converter = ID2RGBConverter()

        if "burst" in self.dataset:
            assert init_json is not None
            self.input_segmentations = init_json["segmentations"]
            self.segmentations = [{} for _ in init_json["segmentations"]]
            self.annotated_frames = init_json["annotated_image_paths"]
            self.video_json = {k: v for k, v in init_json.items()
                               if k != "segmentations"}
            self.video_json["segmentations"] = self.segmentations
            self.json_style = "burst"

        self.queue: Queue = Queue(maxsize=10)
        self.error: Optional[BaseException] = None  # set by the saver thread
        self._ended = False
        self.thread = Thread(target=save_result, args=(self.queue,), daemon=True)
        self.thread.start()

    def process(self, prob, frame_name: str, resize_needed: bool = False,
                shape: Optional[Tuple[int, int]] = None, last_frame: bool = False,
                path_to_image: Optional[str] = None):
        """prob: [num_objects+1, H, W] probabilities, a tensor on the step's
        device (or a numpy array). The resize (bilinear without antialias,
        as the reference's F.interpolate) and the argmax (the first index
        among ties) run on that device; the host gets the id map and, with
        save_scores, the scores as uint8."""
        prob = torch.as_tensor(prob)
        if resize_needed:
            prob = bilinear_resize(prob, shape[0], shape[1])
        ids = prob.argmax(dim=0)
        id_dtype = torch.uint8 if prob.shape[0] <= 256 else torch.int32
        mask = ids.to(id_dtype).cpu().numpy().astype(np.int64)
        prob = ((prob * 255).to(torch.uint8).cpu().numpy()
                if self.save_scores else None)

        if self.need_remapping:
            mask = self.object_manager.tmp_to_obj_cls(mask)

        self.queue.put(ResultArgs(
            saver=self, prob=prob, mask=mask, frame_name=frame_name,
            path_to_image=path_to_image,
            tmp_id_to_obj=copy.deepcopy(self.object_manager.tmp_id_to_obj),
            obj_to_tmp_id=copy.deepcopy(self.object_manager.obj_to_tmp_id),
            last_frame=last_frame))

    def end(self):
        # idempotent: a second end() (e.g. from an exception handler after a
        # successful end) must not enqueue another sentinel — the consumer
        # is gone and queue.join() would deadlock
        if self._ended:
            return
        self._ended = True
        self.queue.put(None)
        self.queue.join()
        self.thread.join()
        if self.error is not None:
            raise RuntimeError(
                f"saver thread failed for {self.video_name}") from self.error


@dataclass
class ResultArgs:
    saver: ResultSaver
    prob: Optional[np.ndarray]   # uint8 scores [num_objects+1, H, W]
    mask: np.ndarray
    frame_name: str
    path_to_image: Optional[str]
    tmp_id_to_obj: Dict[int, ObjectInfo]
    obj_to_tmp_id: Dict[ObjectInfo, int]
    last_frame: bool


def save_result(queue: Queue):
    while True:
        args: Optional[ResultArgs] = queue.get()
        if args is None:
            queue.task_done()
            break
        try:
            _save_one(args)
        except BaseException as e:  # noqa: BLE001 — surfaced by end()
            log.exception("saver thread error on %s", args.frame_name)
            if args.saver.error is None:
                args.saver.error = e
        finally:
            queue.task_done()


def _save_one(args: ResultArgs):
    """Write one queued result (mask/scores/visualization)."""
    saver = args.saver
    mask = args.mask
    frame_name = args.frame_name
    all_obj_ids = [k.id for k in args.obj_to_tmp_id]
    rgb_mask = None

    if saver.json_style == "burst":
        if frame_name in saver.annotated_frames:
            frame_index = saver.annotated_frames.index(frame_name)
            input_segments = saver.input_segmentations[frame_index]
            frame_segments = saver.segmentations[frame_index]
            for id in all_obj_ids:
                if str(id) in input_segments or id in input_segments:
                    key = str(id) if str(id) in input_segments else id
                    frame_segments[key] = input_segments[key]
                    continue
                segment_mask = (mask == id)
                if segment_mask.sum() > 0:
                    coco = rle_codec.encode(segment_mask)
                    frame_segments[id] = {"rle": coco["counts"]}

    if saver.save_mask:
        if saver.use_long_id:
            out_mask = mask.astype(np.uint32)
            rgb_mask = np.zeros((*out_mask.shape[-2:], 3), dtype=np.uint8)
            for id in all_obj_ids:
                _, image = saver.id2rgb_converter.convert(id)
                rgb_mask[out_mask == id] = image
            out_img, palette = rgb_mask, None
        else:
            out_img, palette = mask.astype(np.uint8), saver.palette
        this_out_path = path.join(saver.output_root, saver.video_name)
        os.makedirs(this_out_path, exist_ok=True)
        write_png(path.join(this_out_path, frame_name[:-4] + ".png"), out_img,
                  palette)

    if saver.save_scores:
        this_out_path = path.join(saver.score_output_root, saver.video_name)
        os.makedirs(this_out_path, exist_ok=True)
        if args.last_frame:
            backward = {obj.id: tmp for obj, tmp in args.obj_to_tmp_id.items()}
            np.savez(path.join(this_out_path, "backward.npz"), **{
                str(k): np.asarray(v) for k, v in backward.items()})
        np.savez_compressed(
            path.join(this_out_path, f"{frame_name[:-4]}.npz"), prob=args.prob)

    if saver.visualize:
        if args.path_to_image is None:
            raise ValueError("Cannot visualize without path_to_image")
        image_np = read_image(args.path_to_image)
        if rgb_mask is None:
            out_mask = mask.astype(np.uint32)
            rgb_mask = np.zeros((*out_mask.shape, 3), dtype=np.uint8)
            for id in all_obj_ids:
                rgb_mask[out_mask == id] = saver.colors[id]
        alpha = ((mask == 0).astype(np.float32) * 0.5 + 0.5)[:, :, None]
        blend = (image_np * alpha + rgb_mask * (1 - alpha)).astype(np.uint8)
        this_vis_path = path.join(saver.visualize_output_root, saver.video_name)
        os.makedirs(this_vis_path, exist_ok=True)
        write_jpeg(path.join(this_vis_path, frame_name[:-4] + ".jpg"), blend)


def make_zip(dataset, run_dir, exp_id, mask_output_root):
    """Per-benchmark submission zips (results_utils.py:236-256)."""
    if dataset.startswith("y"):
        log.info("Making zip for YouTubeVOS...")
        shutil.make_archive(path.join(run_dir, f"{exp_id}_{dataset}"), "zip",
                            run_dir, "Annotations")
    elif dataset == "d17-test-dev":
        log.info("Making zip for DAVIS test-dev...")
        shutil.make_archive(path.join(run_dir, f"{exp_id}_{dataset}"), "zip",
                            mask_output_root)
    elif dataset == "mose-val":
        log.info("Making zip for MOSE validation...")
        shutil.make_archive(path.join(run_dir, f"{exp_id}_{dataset}"), "zip",
                            mask_output_root)
    elif dataset == "lvos-test":
        log.info("Making zip for LVOS test...")
        shutil.make_archive(path.join(run_dir, f"{exp_id}_{dataset}"), "zip",
                            run_dir, "Annotations")
    else:
        log.info("Not making zip for %s.", dataset)
