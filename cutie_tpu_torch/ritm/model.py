"""Interactive segmentation model (RITM, HRNet flavour), NCHW.

The port's counterpart of cutie_tpu/ritm/model.py (reference
gui/ritm/model/is_model.py:9-168, is_hrnet_model.py): the click encoding
(disks or tanh distance maps, plus the previous-mask channel), fused into
the HRNet stem through maps_transform (or mixed into the RGB by rgb_conv),
and the align_corners=True upsample of the logits. It also exposes the
backbone-features / head split that f-BRS needs (brs.py).

The shipped GUI checkpoint (coco_lvis_h18_itermask.pth): width 18,
ocr_width 64, with_prev_mask, use_disks, norm_radius 5, use_leaky_relu,
maps_transform (not rgb_conv).

amp=True runs every method under torch.autocast to bf16 (bf16 convolutions)
and returns fp32 logits, as cutie_tpu's dtype=bfloat16 model does.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from cutie_tpu_torch.models.layers import FrozenBatchNorm
from cutie_tpu_torch.ops.resize import bilinear_resize_align_corners
from cutie_tpu_torch.ritm.dist_maps import encode_clicks
from cutie_tpu_torch.ritm.hrnet import HighResolutionNet
from cutie_tpu_torch.utils.tracing import span

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


class ScaleLayer(nn.Module):
    """x * |scale| (reference modeling/basic_blocks.py:ScaleLayer, lr_mult 1)."""

    def __init__(self, init_value: float = 1.0):
        super().__init__()
        self.scale = nn.Parameter(torch.full((1,), init_value))

    def forward(self, x):
        return x * torch.abs(self.scale)


def activation(leaky: bool) -> nn.Module:
    return nn.LeakyReLU(0.2) if leaky else nn.ReLU()


def maps_transform(coord_channels: int, leaky: bool) -> nn.Sequential:
    """The click-feature stem: 1x1 conv, activation, stride-2 3x3 conv,
    ScaleLayer(0.05); added to the backbone after its first conv block."""
    return nn.Sequential(nn.Conv2d(coord_channels, 16, 1), activation(leaky),
                         nn.Conv2d(16, 64, 3, 2, 1), ScaleLayer(0.05))


class ClickEncoder(nn.Module):
    """What HRNet's and DeepLab's interactive models share: the input
    normalisation, the click maps and the amp region."""

    def __init__(self, with_prev_mask: bool, binary_prev_mask: bool, use_disks: bool,
                 norm_radius: float, amp: bool):
        super().__init__()
        self.with_prev_mask = with_prev_mask
        self.binary_prev_mask = binary_prev_mask
        self.use_disks = use_disks
        self.norm_radius = norm_radius
        self.amp = amp
        self.coord_channels = 2 + (1 if with_prev_mask else 0)

    def autocast(self, x: torch.Tensor):
        return torch.autocast(x.device.type, dtype=torch.bfloat16, enabled=self.amp)

    def _prepare_input(self, image):
        """(is_model.py:102-111) image [B, 3(+1), H, W] in [0, 1] ->
        (normalised RGB, previous mask or None)."""
        prev_mask = None
        if self.with_prev_mask:
            prev_mask = image[:, 3:]
            image = image[:, :3]
            if self.binary_prev_mask:
                prev_mask = (prev_mask > 0.5).float()
        mean = image.new_tensor(MEAN)[None, :, None, None]
        std = image.new_tensor(STD)[None, :, None, None]
        return (image - mean) / std, prev_mask

    def _coord_features(self, prev_mask, points, h, w):
        coord = encode_clicks(points, h, w, norm_radius=self.norm_radius,
                              use_disks=self.use_disks)
        return coord if prev_mask is None else torch.cat([prev_mask, coord], 1)


class HRNetISModel(ClickEncoder):
    def __init__(self, width: int = 18, ocr_width: int = 64, small: bool = False,
                 with_aux_output: bool = False, with_prev_mask: bool = True,
                 binary_prev_mask: bool = False, use_disks: bool = True,
                 norm_radius: float = 5.0, use_rgb_conv: bool = False,
                 use_leaky_relu: bool = False, amp: bool = False):
        super().__init__(with_prev_mask, binary_prev_mask, use_disks, norm_radius, amp)
        self.width = width
        self.ocr_width = ocr_width
        self.with_aux_output = with_aux_output
        self.use_rgb_conv = use_rgb_conv
        self.feature_extractor = HighResolutionNet(width, 1, ocr_width, small)
        cch = self.coord_channels
        if use_rgb_conv:
            self.rgb_conv = nn.Sequential(nn.Conv2d(3 + cch, 6 + cch, 1),
                                          FrozenBatchNorm(6 + cch),
                                          activation(use_leaky_relu),
                                          nn.Conv2d(6 + cch, 3, 1))
        else:
            self.maps_transform = maps_transform(cch, use_leaky_relu)

    def _stem_inputs(self, image, points, bias=None, target="rgb"):
        """-> (backbone input, additional features) (is_model.py:82-88). An
        additive bias on the normalised image ('rgb') or on the click
        channels ('dmaps') is the Input-BRS path (brs.py:InputBRSPredictor)."""
        h, w = image.shape[-2:]
        image, prev_mask = self._prepare_input(image)
        coord = self._coord_features(prev_mask, points, h, w)
        if bias is not None:
            if self.use_rgb_conv:
                raise NotImplementedError("Input-BRS targets the maps_transform "
                                          "configuration (the shipped checkpoint)")
            if target == "rgb":
                image = image + bias
            elif target == "dmaps":
                # the click channels only: the previous-mask channel stays
                # (reference brs.py:284-285 dmaps[:, 1:] += bias)
                k = 1 if self.with_prev_mask else 0
                coord = torch.cat([coord[:, :k], coord[:, k:] + bias], 1)
            else:
                raise NotImplementedError(target)
        if self.use_rgb_conv:
            return self.rgb_conv(torch.cat([image, coord], 1)), None
        return image, self.maps_transform(coord)

    def forward(self, image, points):
        """image [B, 3(+1), H, W]; points [B, 2K, 3]. Returns {'instances':
        [B, 1, H, W] fp32 logits} (and 'instances_aux' with_aux_output)."""
        h, w = image.shape[-2:]
        with self.autocast(image):
            out, aux = self.feature_extractor(*self._stem_inputs(image, points))
        result = {"instances": bilinear_resize_align_corners(out.float(), h, w)}
        if self.with_aux_output and aux is not None:
            result["instances_aux"] = bilinear_resize_align_corners(aux.float(), h, w)
        return result

    def low_res_instances(self, image, points):
        """The logits before the upsample: [B, 1, H/4, W/4] fp32 (span
        ritm.backbone: HRNet and its OCR head)."""
        with span("ritm.backbone"), self.autocast(image):
            out, _ = self.feature_extractor(*self._stem_inputs(image, points))
        return out.float()

    def get_head_input(self, image, points, insertion_mode: str = "A"):
        """The f-BRS feature cache (brs.py:229-252): 'A' the aggregated
        multi-resolution features (before OCR), 'C' the OCR features
        (before cls_head). One span ritm.backbone."""
        with span("ritm.backbone"), self.autocast(image):
            feats = self.feature_extractor.backbone(*self._stem_inputs(image, points))
            if insertion_mode == "C":
                feats, _ = self.feature_extractor.head_ocr(feats)
        return feats

    def head_from_feats_low(self, feats, insertion_mode: str = "A"):
        """Logits [B, 1, H/4, W/4] fp32 from (scaled and biased) features:
        'A' reruns the OCR heads, 'C' only cls_head (brs.py:182-210)."""
        with self.autocast(feats):
            if insertion_mode == "C":
                out = self.feature_extractor.cls_from_ocr(feats)
            else:
                out, _ = self.feature_extractor.head(feats)
        return out.float()

    def head_from_feats(self, feats, out_h: int, out_w: int,
                        insertion_mode: str = "A"):
        return bilinear_resize_align_corners(
            self.head_from_feats_low(feats, insertion_mode), out_h, out_w)

    def low_res_instances_with_input_bias(self, image, points, bias,
                                          target: str = "rgb"):
        """The full forward with an additive bias [B, C, H, W] on the
        normalised image ('rgb', RGB-BRS) or on the click maps ('dmaps',
        DistMap-BRS) (brs.py:257-304): logits [B, 1, H/4, W/4] fp32."""
        with self.autocast(image):
            out, _ = self.feature_extractor(*self._stem_inputs(image, points, bias, target))
        return out.float()
