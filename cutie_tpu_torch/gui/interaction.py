"""GUI click interactions (numpy), over the port's RITM ClickController:
the port's counterpart of cutie_tpu/gui/interaction.py.

Behavioral parity target: reference gui/interaction.py — per-object clicks go
through the RITM ClickController; the target object's channel is overwritten
and hard-aggregated with the x1000 low-temperature trick.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from cutie_tpu_torch.ops.tensor_utils import aggregate_wbg_np as aggregate_wbg
from cutie_tpu_torch.ritm.utils import ClickController


class Interaction:
    def __init__(self, image: np.ndarray, prev_mask: np.ndarray,
                 true_size: Tuple[int, int], controller: ClickController):
        self.image = image
        self.prev_mask = prev_mask
        self.controller = controller
        self.h, self.w = true_size
        self.out_prob = None
        self.out_mask = None

    def predict(self):
        pass


class ClickInteraction(Interaction):
    """(interaction.py:46-99). prev_mask: [num_objects+1, H, W] probs."""

    def __init__(self, image, prev_mask, true_size, controller: ClickController,
                 tar_obj: int):
        super().__init__(image, prev_mask, true_size, controller)
        self.tar_obj = tar_obj
        self.pos_clicks = []
        self.neg_clicks = []
        self.first_click = True
        self.out_prob = self.prev_mask.copy()

    def push_point(self, x: int, y: int, is_neg: bool) -> None:
        if is_neg:
            self.neg_clicks.append((x, y))
        else:
            self.pos_clicks.append((x, y))
        if self.first_click:
            last_obj_mask = self.prev_mask[self.tar_obj][None, None]
            self.obj_mask = self.controller.interact(
                self.image, x, y, not is_neg, prev_mask=last_obj_mask)[0, 0]
            self.first_click = False
        else:
            self.obj_mask = self.controller.interact(
                self.image, x, y, not is_neg, prev_mask=None)[0, 0]

    def predict(self) -> np.ndarray:
        self.out_prob = self.prev_mask.copy()
        # allow the interacting object to overwrite existing masks without
        # remembering all object probabilities (interaction.py:93-96)
        self.out_prob = np.clip(self.out_prob, None, 0.9)
        self.out_prob[self.tar_obj] = self.obj_mask
        self.out_prob = aggregate_wbg(self.out_prob[1:], keep_bg=True, hard=True)
        return self.out_prob
