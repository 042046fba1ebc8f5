"""Mask palettes + id->RGB conversion (the port's copy of
cutie_tpu/utils/palette.py).

Parity targets: reference cutie/utils/palette.py (DAVIS palette == the
standard PASCAL-VOC colormap, generated here instead of stored as a blob)
and cutie/utils/pano_utils.py (random 24-bit long-id converter).
"""
from __future__ import annotations

from threading import Lock

import numpy as np


def _voc_colormap(n: int = 256) -> np.ndarray:
    """Standard PASCAL VOC bit-interleaved colormap, [N, 3] uint8."""
    cmap = np.zeros((n, 3), dtype=np.uint8)
    for i in range(n):
        c = i
        r = g = b = 0
        for j in range(8):
            r |= ((c >> 0) & 1) << (7 - j)
            g |= ((c >> 1) & 1) << (7 - j)
            b |= ((c >> 2) & 1) << (7 - j)
            c >>= 3
        cmap[i] = (r, g, b)
    return cmap


davis_palette_np = _voc_colormap(256)
davis_palette = davis_palette_np.tobytes()

# the YouTubeVOS release palette (first 16 entries; rest zeros)
youtube_palette_np = np.zeros((256, 3), dtype=np.uint8)
youtube_palette_np[:16] = np.array([
    [0x00, 0x00, 0x00], [0xec, 0x5f, 0x67], [0xf9, 0x91, 0x57],
    [0xfa, 0xc8, 0x63], [0x99, 0xc7, 0x94], [0x62, 0xb3, 0xb2],
    [0x66, 0x99, 0xcc], [0xc5, 0x94, 0xc5], [0xab, 0x79, 0x67],
    [0xff, 0xff, 0xff], [0x65, 0x73, 0x7e], [0x0b, 0x0b, 0x0b],
    [0x0c, 0x0c, 0x0c], [0x0d, 0x0d, 0x0d], [0x0e, 0x0e, 0x0e],
    [0x0f, 0x0f, 0x0f]], dtype=np.uint8)
youtube_palette = youtube_palette_np[:16].tobytes()


class ID2RGBConverter:
    """Maps object ids to unique random 24-bit colors (pano_utils.py:5-30)."""

    def __init__(self):
        self.all_id = set()
        self.obj_to_id = {}
        self.lock = Lock()

    def _id_to_rgb(self, id: int) -> np.ndarray:
        rgb = np.zeros((3,), dtype=np.uint8)
        for i in range(3):
            rgb[i] = id % 256
            id //= 256
        return rgb

    def convert(self, obj: int):
        with self.lock:
            if obj in self.obj_to_id:
                id = self.obj_to_id[obj]
            else:
                while True:
                    id = int(np.random.randint(255, 256 ** 3))
                    if id not in self.all_id:
                        break
                self.obj_to_id[obj] = id
                self.all_id.add(id)
        return id, self._id_to_rgb(id)
