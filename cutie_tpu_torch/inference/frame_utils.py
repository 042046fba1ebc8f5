"""Per-frame metadata bundle for streaming pipelines.

The port's counterpart of cutie_tpu/inference/frame_utils.py (reference
cutie/inference/utils/frame_utils.py): a frame, its mask or None, the
ObjectInfo list, the frame index and the reader's info dict.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from cutie_tpu_torch.inference.object_manager import ObjectInfo


class FrameInfo:
    def __init__(self, image, mask, segments_info: List[ObjectInfo], ti: int,
                 info: Dict):
        self.image = image
        self.mask = mask
        self.segments_info = segments_info
        self.ti = ti
        self.info = info

    @property
    def name(self) -> str:
        return self.info["frame"]

    @property
    def shape(self) -> Tuple[int, ...]:
        return self.info["shape"]

    @property
    def need_save(self) -> bool:
        return self.info["save"]
