"""Interactive-session controller (headless-drivable; the Qt and tk views
are optional): the port's counterpart of cutie_tpu/gui/main_controller.py.

Behavioral parity target: reference gui/main_controller.py:35-623 — mediator
owning CUTIE + InferenceCore + RITM ClickController + ResourceManager:
click-to-segment, bidirectional propagation with prefetching, permanent-
memory commit, live memory-budget updates, visualization modes, mask/layer
import, video/binary export, memory gauges.

The controller calls an optional `view` object (refresh(controller),
text_to_console; gui/widgets.py, gui/tk_widgets.py) so the same logic runs
under tests and under a window. It runs on the card unless the CPU is asked
for (device="cpu").
"""
from __future__ import annotations

import logging
from collections import deque
from os import path
from typing import Optional

import numpy as np
import torch

from cutie_tpu_torch.gui.interaction import ClickInteraction
from cutie_tpu_torch.gui.interactive_utils import get_visualization, get_visualization_prob
from cutie_tpu_torch.gui.reader import PropagationReader
from cutie_tpu_torch.gui.resource_manager import ResourceManager
from cutie_tpu_torch.inference import InferenceCore
from cutie_tpu_torch.ops.tensor_utils import aggregate_wbg_np
from cutie_tpu_torch.ritm.utils import ClickController, check_device

log = logging.getLogger(__name__)

# frames whose probabilities are in flight to the host during propagation
# before the oldest is drained (cutie_tpu main_controller.py:167-169)
FETCH_DEPTH = 2


def fetch_to_host(prob: torch.Tensor):
    """Start the copy of a step's probabilities to the host: on the card, a
    non-blocking copy into pinned host memory and an event recorded after
    it, which the drain waits on; on the CPU the tensor itself."""
    if prob.device.type != "cuda":
        return prob, None
    host = torch.empty(prob.shape, dtype=prob.dtype, pin_memory=True)
    host.copy_(prob, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return host, done


class MainController:

    def __init__(self, cfg, *, view=None, bundle=None, click_ckpt=None,
                 device="cuda"):
        """cfg: the GUI config (interactive_demo.py); bundle: (network,
        model config) as utils.get_default_model.get_default_model returns
        them, else cutie-base is built from cfg (cfg.weights, cfg.amp) on
        `device`; click_ckpt: the RITM checkpoint (None: a random
        HRNet-18/OCR-64). Raises when the card is asked for and absent."""
        self.device = check_device(device)
        self.cfg = cfg
        self.view = view
        self.num_objects = cfg["num_objects"]

        # networks (main_controller.py:129-135)
        if bundle is None:
            from cutie_tpu_torch.config import eval_config, get_dataset_cfg
            from cutie_tpu_torch.utils.get_default_model import build_model
            model_cfg = eval_config("base")
            model_cfg.merge({k: v for k, v in cfg.items() if k in model_cfg})
            get_dataset_cfg(model_cfg)
            bundle = (build_model(model_cfg, cfg.get("weights"), self.device), model_cfg)
        network, model_cfg = bundle
        if next(network.parameters()).device.type != self.device.type:
            raise ValueError(f"the bundle's network is on "
                             f"{next(network.parameters()).device}, not {self.device}")
        self.bundle = bundle
        self.click_ctrl = ClickController(click_ckpt,
                                          max_size=cfg.get("ritm_max_size", 800),
                                          device=self.device)

        self.res_man = ResourceManager(cfg)
        # inference config: model defaults + the GUI's memory/cadence settings
        infer_cfg = model_cfg.copy()
        for key in ("mem_every", "use_long_term", "max_internal_size",
                    "top_k", "stagger_updates"):
            if cfg.get(key) is not None:
                infer_cfg[key] = cfg[key]
        self.processor = InferenceCore(network, infer_cfg)

        self.T = self.res_man.T
        self.h, self.w = self.res_man.h, self.res_man.w

        self.curr_ti = 0
        self.curr_object = 1
        self.vis_mode = "davis"
        self.interaction: Optional[ClickInteraction] = None
        self.layer: Optional[np.ndarray] = None
        self.propagating = False
        # reference main_controller.py:92 — soft-mask dumps are opt-in
        self.save_soft_mask = bool(cfg.get("save_soft_mask", False))
        self.output_fps = cfg.get("output_fps", 24)
        self.output_bitrate = cfg.get("output_bitrate", 1)

        self.curr_image: Optional[np.ndarray] = None
        self.curr_mask = np.zeros((self.h, self.w), np.uint8)
        self.curr_prob = np.zeros((self.num_objects + 1, self.h, self.w),
                                  np.float32)
        self.curr_prob[0] = 1.0
        self.load_frame(0)

    # -------------------------------------------------------------- frames

    def load_frame(self, ti: int):
        self.curr_ti = int(np.clip(ti, 0, self.T - 1))
        self.curr_image = self.res_man.get_image(self.curr_ti)
        saved = self.res_man.get_mask(self.curr_ti)
        if saved is not None:
            self.curr_mask = saved.astype(np.uint8)
        else:
            self.curr_mask = np.zeros((self.h, self.w), np.uint8)
        self._mask_to_prob()
        self.interaction = None
        self.click_ctrl.unanchor()
        self._notify()

    def _mask_to_prob(self):
        one_hot = np.stack([(self.curr_mask == i).astype(np.float32)
                            for i in range(1, self.num_objects + 1)])
        self.curr_prob = aggregate_wbg_np(one_hot, keep_bg=True, hard=True)

    def _prob_to_mask(self):
        self.curr_mask = self.curr_prob.argmax(0).astype(np.uint8)

    def _notify(self):
        if self.view is not None:
            self.view.refresh(self)

    # --------------------------------------------------------------- clicks

    def click(self, x: int, y: int, is_neg: bool = False):
        """(main_controller.py:148-186)"""
        if self.interaction is None or self.interaction.tar_obj != self.curr_object:
            image_chw = np.transpose(
                self.curr_image.astype(np.float32) / 255.0, (2, 0, 1))
            self.click_ctrl.unanchor()
            self.interaction = ClickInteraction(
                image_chw, self.curr_prob, (self.h, self.w), self.click_ctrl,
                self.curr_object)
        self.interaction.push_point(x, y, is_neg)
        self.curr_prob = self.interaction.predict()
        self._prob_to_mask()
        self.save_current_mask()
        self._notify()

    def undo_click(self):
        if self.interaction is None:
            return
        out = self.click_ctrl.undo()
        if out is not None:
            self.interaction.obj_mask = out[0, 0] if out.ndim == 4 else out
            self.curr_prob = self.interaction.predict()
            self._prob_to_mask()
            self._notify()

    # ---------------------------------------------------------- propagation

    def on_propagate(self, direction: str = "forward", max_frames: int = -1):
        """(main_controller.py:297-346) Each step's probabilities are copied
        to the host without blocking and drained in order, FETCH_DEPTH frames
        behind the steps, for the state updates, saves and the view."""
        self.propagating = True
        # memorize the current (possibly interacted) frame
        self.processor.clear_sensory_memory()
        self.processor.step(np.ascontiguousarray(self.curr_image),
                            self.curr_prob[1:], idx_mask=False)
        self.save_current_mask()

        def finish(fetched, image_np, ti):
            host, done = fetched
            if done is not None:
                done.synchronize()
            self.curr_ti = ti
            self.curr_image = image_np
            self._set_prob_padded(host.numpy())
            self._prob_to_mask()
            self.save_current_mask()
            self._notify()

        n = 0
        inflight = deque()  # (fetched, image_np, ti), in step order
        for image_np, ti in PropagationReader(self.res_man, self.curr_ti, direction):
            if not self.propagating:
                break
            prob = self.processor.step(np.ascontiguousarray(image_np))
            inflight.append((fetch_to_host(prob), image_np, ti))
            while len(inflight) > FETCH_DEPTH:
                finish(*inflight.popleft())
            n += 1
            if 0 < max_frames <= n:
                break
        while inflight:
            finish(*inflight.popleft())
        self.propagating = False

    def stop_propagation(self):
        self.propagating = False

    def _set_prob_padded(self, prob_np: np.ndarray):
        out = np.zeros((self.num_objects + 1, *prob_np.shape[1:]), np.float32)
        k = min(self.num_objects + 1, prob_np.shape[0])
        out[:k] = prob_np[:k]
        self.curr_prob = out

    # ------------------------------------------------------------- memory ops

    def on_commit(self):
        """Commit to permanent memory (main_controller.py:351-368)."""
        self.processor.step(np.ascontiguousarray(self.curr_image),
                            self.curr_prob[1:], idx_mask=False,
                            force_permanent=True)
        self._notify()

    def on_clear_memory(self):
        self.processor.clear_memory()
        self._notify()

    def on_clear_non_permanent_memory(self):
        """Drop working/long-term memory but keep the permanent prefix
        (main_controller.py:552-561; sensory has its own clear)."""
        self.processor.clear_non_permanent_memory()
        self._notify()

    def on_reset_object(self):
        self.curr_mask[self.curr_mask == self.curr_object] = 0
        self._mask_to_prob()
        self.save_current_mask()
        self._notify()

    def update_memory_config(self, **updates):
        cfg = self.processor.cfg.copy()
        cfg.merge(updates)
        self.processor.update_config(cfg)

    def get_memory_gauges(self):
        """perm/work/LT token occupancy (main_controller.py:494-516), from
        the memory state's host-side counters (0 before the first step)."""
        st = self.processor.state
        return {
            "permanent": st.perm_n if st is not None else 0,
            "working": st.work_count if st is not None else 0,
            "working_max": self.processor.max_mem_frames,
            "long_term": st.lt_count if st is not None else 0,
            "long_term_max": getattr(self.processor, "max_long_tokens", 0),
        }

    # ----------------------------------------------------------------- saving

    def save_current_mask(self):
        self.res_man.save_mask(self.curr_ti, self.curr_mask)
        if self.save_soft_mask:
            # opt-in, like the reference's save-soft-mask checkbox
            # (gui/main_controller.py:229-230,606-607)
            self.res_man.save_soft_mask(self.curr_ti, self.curr_prob)
        vis = self.visualize(self.vis_mode)
        self.res_man.save_visualization(self.curr_ti, self.vis_mode, vis)

    def on_save_soft_mask_toggle(self, enabled: bool):
        self.save_soft_mask = bool(enabled)

    def on_fps_change(self, fps: int):
        self.output_fps = int(fps)

    def on_bitrate_change(self, mbps: int):
        self.output_bitrate = int(mbps)

    def visualize(self, mode: Optional[str] = None) -> np.ndarray:
        mode = mode or self.vis_mode
        targets = list(range(1, self.num_objects + 1))
        if self.curr_prob is not None and mode in ("popup", "layer", "rgba"):
            return get_visualization_prob(
                mode, self.curr_image.astype(np.float32) / 255.0,
                self.curr_prob, self.layer, targets)
        return get_visualization(mode, self.curr_image, self.curr_mask,
                                 self.layer, targets)

    def set_vis_mode(self, mode: str):
        self.vis_mode = mode
        self._notify()

    # -------------------------------------------------------------- import/export

    def import_mask(self, file_name: str):
        mask = self.res_man.import_mask(file_name, size=(self.h, self.w))
        self.curr_mask = mask.astype(np.uint8)
        self._mask_to_prob()
        self.save_current_mask()
        self._notify()

    def import_layer(self, file_name: str):
        self.layer = self.res_man.import_layer(file_name, (self.h, self.w))
        self._notify()

    def export_video(self, fps: Optional[int] = None):
        from cutie_tpu_torch.gui.exporter import convert_frames_to_video
        vis_dir = path.join(self.res_man.visualization_dir, self.vis_mode)
        out = path.join(self.res_man.workspace, f"{self.vis_mode}.mp4")
        return convert_frames_to_video(vis_dir, out, fps=fps or self.output_fps,
                                       bitrate_mbps=self.output_bitrate)

    def export_binary_masks(self, target_objects):
        from cutie_tpu_torch.gui.exporter import convert_mask_to_binary
        out = path.join(self.res_man.workspace, "binary_masks")
        return convert_mask_to_binary(self.res_man.mask_dir, out, target_objects)

    def close(self):
        self.res_man.close()
