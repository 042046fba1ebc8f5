"""Visualization overlay renderers for the interactive GUI (numpy): the
port's copy of cutie_tpu/gui/interactive_utils.py.

Behavioral parity target: reference gui/interactive_utils.py:52-229
(davis/fade/light/popup/layer/rgba/mask/image modes; colors brightened 1.5x;
grayscale popup weights). The prob-based variants use soft probabilities for
softer edges, like the reference's torch path. Every mode is bit-equal to
cutie_tpu's (tests/test_torch_gui.py).
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from cutie_tpu_torch.utils.palette import davis_palette_np

color_map_np = (davis_palette_np.astype(np.float32) * 1.5).clip(0, 255).astype(np.uint8)
grayscale_weights = np.array([[0.3, 0.59, 0.11]], np.float32)


def overlay_davis(image, mask, alpha: float = 0.5, fade: bool = False):
    im_overlay = image.copy()
    colored_mask = color_map_np[mask]
    foreground = image * alpha + (1 - alpha) * colored_mask
    binary_mask = mask > 0
    im_overlay[binary_mask] = foreground[binary_mask]
    if fade:
        im_overlay[~binary_mask] = im_overlay[~binary_mask] * 0.6
    return im_overlay.astype(image.dtype)


def overlay_popup(image, mask, target_objects: List[int]):
    im_overlay = image.copy().astype(np.float32)
    bg = ~np.isin(mask, target_objects)
    im_overlay[bg] = (im_overlay[bg] * grayscale_weights).sum(-1, keepdims=True)
    return im_overlay.astype(image.dtype)


def overlay_layer(image, mask, layer, target_objects: List[int]):
    obj_mask = np.isin(mask, target_objects).astype(np.float32)[:, :, None]
    layer_alpha = layer[:, :, 3].astype(np.float32)[:, :, None] / 255
    layer_rgb = layer[:, :, :3]
    background_alpha = (1 - obj_mask) * (1 - layer_alpha)
    out = (image * background_alpha + layer_rgb * (1 - obj_mask) * layer_alpha
           + image * obj_mask).clip(0, 255)
    return out.astype(image.dtype)


def overlay_rgba(image, mask, target_objects: List[int]):
    obj_mask = np.isin(mask, target_objects).astype(np.float32)[:, :, None] * 255
    return np.concatenate([image, obj_mask], axis=-1).astype(image.dtype)


def get_visualization(mode: str, image: np.ndarray, mask: np.ndarray,
                      layer: Optional[np.ndarray],
                      target_objects: List[int]) -> np.ndarray:
    """image HWC uint8; mask HW int; layer HWC RGBA uint8 or None."""
    if mode == "image":
        return image
    if mode == "mask":
        return color_map_np[mask]
    if mode == "fade":
        return overlay_davis(image, mask, fade=True)
    if mode == "davis":
        return overlay_davis(image, mask)
    if mode == "light":
        return overlay_davis(image, mask, 0.9)
    if mode == "popup":
        return overlay_popup(image, mask, target_objects)
    if mode == "layer":
        if layer is None:
            return overlay_davis(image, mask)
        return overlay_layer(image, mask, layer, target_objects)
    if mode == "rgba":
        return overlay_rgba(image, mask, target_objects)
    raise NotImplementedError(mode)


def get_visualization_prob(mode: str, image: np.ndarray, prob: np.ndarray,
                           layer: Optional[np.ndarray],
                           target_objects: List[int]) -> np.ndarray:
    """Soft variants (reference *_torch path): image HWC float 0..1;
    prob [num_objects+1, H, W]. Returns HWC uint8."""
    mask = prob.argmax(0)
    if mode == "image":
        return (image * 255).astype(np.uint8)
    if mode == "mask":
        return color_map_np[mask]
    if mode in ("fade", "davis", "light"):
        alpha = 0.9 if mode == "light" else 0.5
        out = image.copy()
        colored = color_map_np[mask].astype(np.float32) / 255
        fg = image * alpha + (1 - alpha) * colored
        bin_mask = mask > 0
        out[bin_mask] = fg[bin_mask]
        if mode == "fade":
            out[~bin_mask] = out[~bin_mask] * 0.6
        return (out * 255).astype(np.uint8)
    if len(target_objects) == 0:
        obj = np.zeros_like(prob[0])[:, :, None]
    else:
        obj = prob[np.asarray(target_objects, np.int32)].sum(0)[:, :, None]
    if mode == "popup":
        gray = (image * grayscale_weights).sum(-1, keepdims=True)
        return ((obj * image + (1 - obj) * gray) * 255).astype(np.uint8)
    if mode == "layer":
        if layer is None:
            return get_visualization_prob("davis", image, prob, layer,
                                          target_objects)
        layer_alpha = layer[:, :, 3:].astype(np.float32) / 255
        layer_rgb = layer[:, :, :3].astype(np.float32) / 255
        background_alpha = (1 - obj) * (1 - layer_alpha)
        out = (image * background_alpha + layer_rgb * (1 - obj) * layer_alpha
               + image * obj).clip(0, 1)
        return (out * 255).astype(np.uint8)
    if mode == "rgba":
        return (np.concatenate([image, obj], axis=-1).clip(0, 1)
                * 255).astype(np.uint8)
    raise NotImplementedError(mode)
