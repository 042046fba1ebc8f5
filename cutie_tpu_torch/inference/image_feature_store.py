"""Per-frame feature cache.

The port's counterpart of cutie_tpu/inference/image_feature_store.py
(reference cutie/inference/image_feature_store.py:7-49): encode each frame
index once, even when it is stepped several times.
"""
from __future__ import annotations

import logging
from typing import Dict

log = logging.getLogger(__name__)


class ImageFeatureStore:
    def __init__(self, steps):
        self._steps = steps
        self._store: Dict[int, object] = {}

    def get_features(self, ti: int, image, *, pad):
        if ti not in self._store:
            self._store[ti] = self._steps.encode(image, pad=pad)
        return self._store[ti]

    def delete(self, ti: int) -> None:
        self._store.pop(ti, None)

    def __contains__(self, ti: int) -> bool:
        return ti in self._store

    def __len__(self):
        return len(self._store)

    def __del__(self):
        if self._store:
            log.warning("Leaking %d cached frame features; did you forget "
                        "delete_buffer/delete()?", len(self._store))
