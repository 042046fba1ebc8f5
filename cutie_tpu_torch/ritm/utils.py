"""RITM model loading and the GUI's click controller.

The port's counterpart of cutie_tpu/ritm/utils.py (reference
gui/ritm/inference/utils.py:20-44, load_is_model rebuilding the model from
the checkpoint's serialized config, and gui/click_controller.py).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from cutie_tpu_torch.ritm.inference import InteractiveController
from cutie_tpu_torch.ritm.model import HRNetISModel
from cutie_tpu_torch.ritm.weight_import import load_ritm_checkpoint, state_dict_tensors
from cutie_tpu_torch.utils.get_default_model import set_fp32_precision

HRNET_KEYS = ("width", "ocr_width", "small", "with_prev_mask", "use_disks",
              "norm_radius", "use_rgb_conv", "use_leaky_relu")
DEEPLAB_KEYS = ("deeplab_ch", "with_prev_mask", "use_disks", "norm_radius",
                "use_leaky_relu")


def _config_param(params: dict, key: str):
    """Serialized configs store {'type', 'value', 'specified'} a parameter
    (gui/ritm/utils/serialization.py:16-33); plain dicts the value."""
    v = params[key]
    return v["value"] if isinstance(v, dict) and "value" in v else v


def check_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a CUDA device was asked for and "
                           "torch.cuda.is_available() is False")
    return device


def load_is_model(checkpoint_path: Optional[str], device="cuda", **model_overrides):
    """The interactive model in eval mode on `device` (the card unless the
    CPU is asked for; raises when CUDA is asked for and absent). With a
    RITM .pth (or a .npz state dict), the class and parameters of its
    serialized config (HRNetModel -> HRNetISModel, DeeplabModel ->
    DeepLabISModel, as gui/ritm/utils/serialization.py:load_model
    dispatches) and its weights, loaded strictly; a path that does not load
    raises (cutie_tpu only warns: ROADMAP.md section 3, D8). Without a path,
    HRNet-18/OCR-64 (the shipped checkpoint's configuration) with a random
    initialisation from seed 0. model_overrides (amp, ...) win over the
    config. Turns TF32 off."""
    device = check_device(device)
    set_fp32_precision()
    sd, config = load_ritm_checkpoint(checkpoint_path) if checkpoint_path else (None, {})
    cls_name = str(config.get("class", "")).rsplit(".", 1)[-1]
    params = config.get("params", {}) or {}
    if cls_name == "DeeplabModel":
        from cutie_tpu_torch.ritm.deeplab import DeepLabISModel
        cls, keys = DeepLabISModel, DEEPLAB_KEYS
        kwargs = dict(deeplab_ch=256, with_prev_mask=True, use_disks=True,
                      norm_radius=5.0, use_leaky_relu=False)
    else:
        cls, keys = HRNetISModel, HRNET_KEYS
        kwargs = dict(width=18, ocr_width=64, small=False, with_prev_mask=True,
                      use_disks=True, norm_radius=5, use_rgb_conv=False,
                      use_leaky_relu=True)
    kwargs.update({k: _config_param(params, k) for k in keys if k in params})
    kwargs.update(model_overrides)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = cls(**kwargs)
    if sd is not None:
        model.load_state_dict(state_dict_tensors(sd), strict=True)
    return model.to(device).eval()


class ClickController:
    """The GUI's click controller (gui/click_controller.py) with its
    predictor parameters: f-BRS-B, net_clicks_limit 8, max_size 800, flip,
    zoom-in to 480 at expansion 1.4, min_iou_diff 1e-3, L-BFGS maxfun 20.
    The BRS modes optimise with the device drive (ritm/lbfgs.py, cutie_tpu's
    default); host_lbfgs=True takes scipy's L-BFGS on the host instead.

    amp (bf16 convolutions, fp32 logits and loss) defaults to on for the
    card and off for the CPU, as cutie_tpu's defaults to bf16 on
    accelerators (ritm/utils.py:116-124)."""

    def __init__(self, checkpoint_path: Optional[str], max_size: int = 800,
                 brs_mode: str = "f-BRS-B", amp: Optional[bool] = None,
                 device="cuda", host_lbfgs: bool = False):
        device = check_device(device)
        if amp is None:
            amp = device.type == "cuda"
        self.model = load_is_model(checkpoint_path, device, amp=amp)
        predictor_params = {
            "brs_mode": brs_mode,
            "prob_thresh": 0.5,
            "net_clicks_limit": 8,
            "max_size": max_size,
            "with_flip": True,
            "zoom_in_params": {"skip_clicks": 1, "target_size": 480,
                               "expansion_ratio": 1.4},
            "brs_opt_func_params": {"min_iou_diff": 1e-3},
            "lbfgs_params": {"maxfun": 20},
        }
        if brs_mode != "NoBRS":
            predictor_params["predictor_params"] = {"host_lbfgs": host_lbfgs}
        self.controller = InteractiveController(self.model, predictor_params)
        self.anchored = False

    def unanchor(self):
        self.anchored = False

    def interact(self, image: np.ndarray, x: int, y: int, is_positive: bool,
                 prev_mask: Optional[np.ndarray] = None) -> np.ndarray:
        """image: [C, H, W] float in [0, 1]. Returns probabilities
        [1, 1, H, W] (numpy)."""
        if not self.anchored:
            self.controller.set_image(image)
            self.controller.reset_predictor()
            self.anchored = True
        return self.controller.add_click(x, y, is_positive, prev_mask=prev_mask)

    def undo(self) -> Optional[np.ndarray]:
        self.controller.undo_click()
        if len(self.controller.probs_history) == 0:
            return None
        return (self.controller.probs_history[-1][1] > 0.5).astype(np.float32)
