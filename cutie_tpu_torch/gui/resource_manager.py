"""GUI workspace resource management (no Qt, no PIL, no cv2 for still
images): the port's counterpart of cutie_tpu/gui/resource_manager.py.

Behavioral parity target: reference gui/resource_manager.py:25-317 —
video->frames extraction with a shorter-edge cap, image import with resizing,
LRU frame/mask caches, a multi-threaded save queue writing palette masks /
visualizations / per-object soft masks, mask/layer import helpers.

Still images go through utils/image_io.py: frames and masks are read as
Pillow reads them, masks and soft masks are written as PNG, visualizations
as JPEG at quality 95 (the bytes cv2.imwrite writes) or, in the rgba mode,
as RGBA PNG; the shorter-edge cap resizes by cv2's INTER_AREA (resize_area).
Only video ingest needs cv2 (cv2.VideoCapture), imported when a video is
given. Each saved file is written under a temporary name and renamed into
place, so that a reader never sees a half-written file (two save threads
may write the same frame's file).
"""
from __future__ import annotations

import collections
import logging
import os
import shutil
import threading
from dataclasses import dataclass
from os import path
from queue import Queue
from threading import Thread
from typing import Optional, Tuple

import numpy as np

from cutie_tpu_torch.utils.image_io import (read_any, read_image, read_png,
                                            resize_area, resize_bilinear,
                                            resize_nearest, to_rgba,
                                            write_jpeg, write_png)
from cutie_tpu_torch.utils.palette import davis_palette

log = logging.getLogger(__name__)

JPEG_QUALITY = 95   # cv2.imwrite's default, which the reference writes with


class LRU:
    """Tiny LRU wrapper (resource_manager.py:25-44)."""

    def __init__(self, func, maxsize=128):
        self.cache = collections.OrderedDict()
        self.func = func
        self.maxsize = maxsize

    def __call__(self, *args):
        if args in self.cache:
            self.cache.move_to_end(args)
            return self.cache[args]
        result = self.func(*args)
        self.cache[args] = result
        if len(self.cache) > self.maxsize:
            self.cache.popitem(last=False)
        return result

    def invalidate(self, key):
        self.cache.pop(key, None)


@dataclass
class SaveItem:
    type: str  # 'mask' | 'visualization_<mode>' | 'soft_mask'
    data: np.ndarray
    name: Optional[str] = None


def _replace_into(final: str, write) -> None:
    """write(tmp_path), then rename tmp_path to `final`."""
    tmp = f"{final}.{threading.get_ident()}.tmp"
    write(tmp)
    os.replace(tmp, final)


def write_image(file_name: str, rgb: np.ndarray) -> None:
    """[H, W, 3] uint8 RGB in the format of the file's extension, as
    cv2.imwrite writes PNG and JPEG (quality 95)."""
    ext = path.splitext(file_name)[1].lower()
    if ext == ".png":
        write_png(file_name, rgb)
    elif ext in (".jpg", ".jpeg"):
        write_jpeg(file_name, rgb, JPEG_QUALITY)
    else:
        raise ValueError(f"{file_name}: frames are written as .png or .jpg, not {ext!r}")


def capped_size(h: int, w: int, max_size: int) -> Tuple[int, int]:
    """(h, w) with the shorter edge capped at max_size (> 0), as the
    reference computes it (resource_manager.py:165-170)."""
    if max_size > 0 and min(h, w) > max_size:
        return h * max_size // min(w, h), w * max_size // min(w, h)
    return h, w


class ResourceManager:

    def __init__(self, cfg):
        images = cfg["images"]
        video = cfg["video"]
        self.workspace = cfg["workspace"]
        self.max_size = cfg["max_overall_size"]
        self.palette = davis_palette

        if self.workspace is None:
            if images is not None:
                basename = path.basename(images)
            elif video is not None:
                basename = path.basename(video)[:-4]
            else:
                raise NotImplementedError(
                    "Either images, video, or workspace has to be specified")
            self.workspace = path.join("./workspace", basename)
        log.info("Workspace is in: %s", self.workspace)
        cfg["workspace"] = self.workspace

        need_decoding = need_resizing = False
        if path.exists(path.join(self.workspace, "images")):
            pass
        elif images is not None:
            need_resizing = True
        elif video is not None:
            need_decoding = True

        self.image_dir = path.join(self.workspace, "images")
        self.mask_dir = path.join(self.workspace, "masks")
        self.visualization_dir = path.join(self.workspace, "visualization")
        self.soft_mask_dir = path.join(self.workspace, "soft_masks")
        for d in (self.image_dir, self.mask_dir, self.visualization_dir,
                  self.soft_mask_dir):
            os.makedirs(d, exist_ok=True)
        for i in range(1, cfg["num_objects"] + 1):
            os.makedirs(path.join(self.soft_mask_dir, str(i)), exist_ok=True)

        self.get_image = LRU(self._get_image_unbuffered, maxsize=cfg["buffer_size"])
        self.get_mask = LRU(self._get_mask_unbuffered, maxsize=cfg["buffer_size"])

        if need_decoding:
            self._extract_frames(video)
        if need_resizing:
            self._copy_resize_frames(images)

        self._files = sorted(os.listdir(self.image_dir))
        self.names = [path.splitext(f)[0] for f in self._files]
        self.length = len(self.names)
        if self.length == 0:
            raise FileNotFoundError(
                f"No images found! Check {self.workspace}/images.")
        log.info("%d images found.", self.length)
        self.height, self.width = self.get_image(0).shape[:2]

        self.save_queue: Queue = Queue(maxsize=cfg["save_queue_size"])
        self.save_error: Optional[BaseException] = None
        self.num_save_threads = cfg["num_save_threads"]
        self.save_threads = [Thread(target=self.save_thread,
                                    args=(self.save_queue,), daemon=True)
                             for _ in range(self.num_save_threads)]
        for t in self.save_threads:
            t.start()

    def close(self):
        """Drain the save queue and stop its threads; raises if a save
        failed."""
        for _ in range(self.num_save_threads):
            self.save_queue.put(None)
        self.save_queue.join()
        for t in self.save_threads:
            t.join()
        if self.save_error is not None:
            raise RuntimeError("a save thread failed") from self.save_error

    def save_thread(self, queue: Queue):
        while True:
            args: Optional[SaveItem] = queue.get()
            if args is None:
                queue.task_done()
                break
            try:
                self._save(args)
            except Exception as e:  # keep draining the queue; close() raises
                log.exception("saving %s %s failed", args.type, args.name)
                self.save_error = self.save_error or e
            queue.task_done()

    def _save(self, args: SaveItem):
        if args.type == "mask":
            _replace_into(path.join(self.mask_dir, args.name + ".png"),
                          lambda f: write_png(f, args.data, self.palette))
        elif args.type.startswith("visualization"):
            vis_mode = args.type.split("_")[-1]
            os.makedirs(path.join(self.visualization_dir, vis_mode), exist_ok=True)
            if vis_mode == "rgba":
                _replace_into(path.join(self.visualization_dir, vis_mode,
                                        args.name + ".png"),
                              lambda f: write_png(f, args.data))
            else:
                _replace_into(path.join(self.visualization_dir, vis_mode,
                                        args.name + ".jpg"),
                              lambda f: write_jpeg(f, args.data, JPEG_QUALITY))
        elif args.type == "soft_mask":
            for i in range(1, args.data.shape[0]):  # channel 0 = background
                data = (args.data[i] * 255).astype(np.uint8)
                _replace_into(path.join(self.soft_mask_dir, str(i), args.name + ".png"),
                              lambda f: write_png(f, data))
        else:
            raise NotImplementedError(args.type)

    def _extract_frames(self, video: str):
        try:
            import cv2
        except ImportError as e:
            raise ImportError(
                "extracting frames from a video needs cv2 (opencv-python), "
                "which is not installed; give a directory of images instead") from e
        cap = cv2.VideoCapture(video)
        frame_index = 0
        log.info("Extracting frames from %s into %s...", video, self.image_dir)
        try:
            while cap.isOpened():
                _, frame = cap.read()
                if frame is None:
                    break
                rgb = np.ascontiguousarray(frame[..., ::-1])
                h, w = capped_size(*rgb.shape[:2], self.max_size)
                if (h, w) != rgb.shape[:2]:
                    rgb = resize_area(rgb, w, h)
                write_jpeg(path.join(self.image_dir, f"{frame_index:07d}.jpg"), rgb,
                           JPEG_QUALITY)
                frame_index += 1
        finally:
            cap.release()

    def _copy_resize_frames(self, images: str):
        log.info("Copying/resizing frames into %s...", self.image_dir)
        for image_name in os.listdir(images):
            if self.max_size < 0:
                shutil.copy2(path.join(images, image_name), self.image_dir)
            else:
                frame = read_image(path.join(images, image_name))
                h, w = capped_size(*frame.shape[:2], self.max_size)
                if (h, w) != frame.shape[:2]:
                    frame = resize_area(frame, w, h)
                write_image(path.join(self.image_dir, image_name), frame)

    def add_to_queue_with_warning(self, item: SaveItem):
        if self.save_queue.full():
            log.warning("The save queue is full! You need more threads or "
                        "faster IO. Program might pause.")
        self.save_queue.put(item)

    def save_mask(self, ti: int, mask: np.ndarray):
        self._check_index(ti)
        self.invalidate(ti)
        self.add_to_queue_with_warning(
            SaveItem("mask", np.ascontiguousarray(mask, np.uint8), self.names[ti]))

    def save_visualization(self, ti: int, vis_mode: str, image: np.ndarray):
        self._check_index(ti)
        self.add_to_queue_with_warning(
            SaveItem(f"visualization_{vis_mode}", image, self.names[ti]))

    def save_soft_mask(self, ti: int, prob: np.ndarray):
        self._check_index(ti)
        self.add_to_queue_with_warning(SaveItem("soft_mask", prob, self.names[ti]))

    def _check_index(self, ti: int):
        if not 0 <= ti < self.length:
            raise IndexError(f"frame {ti} of {self.length}")

    def _get_image_unbuffered(self, ti: int) -> np.ndarray:
        self._check_index(ti)
        return read_image(path.join(self.image_dir, self._files[ti]))

    def _get_mask_unbuffered(self, ti: int) -> Optional[np.ndarray]:
        self._check_index(ti)
        mask_path = path.join(self.mask_dir, self.names[ti] + ".png")
        if path.exists(mask_path):
            return read_png(mask_path)[0]
        return None

    def import_mask(self, file_name: str,
                    size: Optional[Tuple[int, int]] = None) -> np.ndarray:
        """The file's pixels (palette indices for a palette image), resized
        by Pillow's NEAREST to size (h, w)."""
        pixels = read_any(file_name)[0]
        if size is not None:
            pixels = resize_nearest(pixels, size[0], size[1])
        return pixels

    def import_layer(self, file_name: str, size: Tuple[int, int]) -> np.ndarray:
        """The file as RGBA, fitted into size (h, w) by Pillow's BILINEAR
        (on premultiplied alpha, as Image.resize resizes RGBA) and centred
        on a transparent canvas."""
        image = to_rgba(*read_any(file_name))
        im_h, im_w = image.shape[:2]
        im_ratio = im_w / im_h
        canvas_ratio = size[1] / size[0]
        if im_ratio < canvas_ratio:
            new_h = size[0]
            new_w = int(new_h * im_ratio)
        else:
            new_w = size[1]
            new_h = int(new_w / im_ratio)
        image = _unpremultiply(resize_bilinear(_premultiply(image), new_h, new_w))
        pad_h = (size[0] - new_h) // 2
        pad_w = (size[1] - new_w) // 2
        return np.pad(image, ((pad_h, size[0] - new_h - pad_h),
                              (pad_w, size[1] - new_w - pad_w), (0, 0)))

    def invalidate(self, ti: int):
        self.get_mask.invalidate((ti,))

    def __len__(self):
        return self.length

    @property
    def T(self) -> int:
        return self.length

    @property
    def h(self) -> int:
        return self.height

    @property
    def w(self) -> int:
        return self.width


def _premultiply(rgba: np.ndarray) -> np.ndarray:
    """Pillow's RGBA -> RGBa (Convert.c:rgbA2rgba): each colour times
    alpha / 255, rounded by MULDIV255."""
    v = rgba.astype(np.uint32)
    tmp = v[..., :3] * v[..., 3:] + 128
    out = rgba.copy()
    out[..., :3] = ((tmp >> 8) + tmp) >> 8
    return out


def _unpremultiply(rgba: np.ndarray) -> np.ndarray:
    """Pillow's RGBa -> RGBA (Convert.c:rgba2rgbA): each colour times
    255 / alpha, truncated and clipped; unchanged at alpha 0 and 255."""
    v = rgba.astype(np.uint32)
    alpha = v[..., 3:]
    scaled = np.minimum(255 * v[..., :3] // np.maximum(alpha, 1), 255)
    out = rgba.copy()
    out[..., :3] = np.where((alpha == 0) | (alpha == 255), v[..., :3], scaled)
    return out
