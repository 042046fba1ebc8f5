"""DeepLabV3+ flavour of RITM's interactive model (NCHW).

The port's counterpart of cutie_tpu/ritm/deeplab.py (reference
gui/ritm/model/modeling/deeplab_v3.py, resnetv1b.py, basic_blocks.py,
is_deeplab_model.py): a dilated ResNet-50 v1s with a deep stem, ASPP, the
skip projection and the separable-conv heads, with the same click encoding
as the HRNet flavour. Module names follow the reference's state dict
(tests/golden/deeplab_shapes.npz). The shipped GUI checkpoint is HRNet.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from cutie_tpu_torch.models.layers import FrozenBatchNorm
from cutie_tpu_torch.ops.resize import bilinear_resize_align_corners
from cutie_tpu_torch.ritm.hrnet import BottleneckV1b
from cutie_tpu_torch.ritm.model import ClickEncoder, maps_transform


def conv_bn_relu(cin: int, cout: int, kernel: int = 1, dilation: int = 1):
    return [nn.Conv2d(cin, cout, kernel, 1, dilation * (kernel // 2), dilation,
                      bias=False), FrozenBatchNorm(cout), nn.ReLU()]


class ResNetV1s(nn.Module):
    """Dilated resnet50_v1s (resnetv1b.py:114-190): a deep stem, layer3 and
    layer4 at stride 1 with dilation 2 and 4. Returns (c1, c2, c3, c4); the
    additional features are zero-padded on channels and added after the
    stem (modeling/resnet.py:29-41)."""

    def __init__(self, layers=(3, 4, 6, 3), stem_width: int = 64):
        super().__init__()
        sw = stem_width
        self.conv1 = nn.Sequential(
            nn.Conv2d(3, sw, 3, 2, 1, bias=False), FrozenBatchNorm(sw), nn.ReLU(),
            nn.Conv2d(sw, sw, 3, 1, 1, bias=False), FrozenBatchNorm(sw), nn.ReLU(),
            nn.Conv2d(sw, 2 * sw, 3, 1, 1, bias=False))
        self.bn1 = FrozenBatchNorm(2 * sw)
        inplanes = 2 * sw
        for i, (planes, blocks, stride, dilation) in enumerate(
                [(64, layers[0], 1, 1), (128, layers[1], 2, 1),
                 (256, layers[2], 1, 2), (512, layers[3], 1, 4)]):
            downsample = nn.Sequential(
                nn.Conv2d(inplanes, planes * 4, 1, stride, bias=False),
                FrozenBatchNorm(planes * 4))
            first = BottleneckV1b(inplanes, planes, stride, downsample,
                                  dilation=1 if dilation in (1, 2) else 2)
            inplanes = planes * 4
            setattr(self, f"layer{i + 1}", nn.Sequential(
                first, *[BottleneckV1b(inplanes, planes, dilation=dilation)
                         for _ in range(blocks - 1)]))

    def forward(self, x, additional_features=None):
        x = F.relu(self.bn1(self.conv1(x)))
        if additional_features is not None:
            x = x + F.pad(additional_features,
                          (0, 0, 0, 0, 0, x.shape[1] - additional_features.shape[1]))
        x = F.max_pool2d(x, 3, 2, 1)
        c1 = self.layer1(x)
        c2 = self.layer2(c1)
        c3 = self.layer3(c2)
        return c1, c2, c3, self.layer4(c3)


class SeparableConv2d(nn.Module):
    """Depthwise 3x3, pointwise 1x1, norm, ReLU (basic_blocks.py:68-92)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.body = nn.Sequential(
            nn.Conv2d(in_channels, in_channels, 3, 1, 1, groups=in_channels, bias=False),
            nn.Conv2d(in_channels, out_channels, 1, bias=False),
            FrozenBatchNorm(out_channels), nn.ReLU())

    def forward(self, x):
        return self.body(x)


class AsppPooling(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.gap = nn.Sequential(nn.AdaptiveAvgPool2d(1),
                                 *conv_bn_relu(in_channels, out_channels))

    def forward(self, x):
        return self.gap(x).expand(-1, -1, *x.shape[-2:])


class ASPP(nn.Module):
    """(deeplab_v3.py:_ASPP); dropout is inactive at inference."""

    def __init__(self, in_channels: int, out_channels: int = 256,
                 atrous_rates=(12, 24, 36)):
        super().__init__()
        self.concurent = nn.ModuleList(
            [nn.Sequential(*conv_bn_relu(in_channels, out_channels))]
            + [nn.Sequential(*conv_bn_relu(in_channels, out_channels, 3, rate))
               for rate in atrous_rates]
            + [AsppPooling(in_channels, out_channels)])
        self.project = nn.Sequential(*conv_bn_relu(5 * out_channels, out_channels))

    def forward(self, x):
        return self.project(torch.cat([branch(x) for branch in self.concurent], 1))


class SkipProject(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.skip_project = nn.Sequential(*conv_bn_relu(in_channels, out_channels))

    def forward(self, x):
        return self.skip_project(x)


class DeepLabHead(nn.Module):
    def __init__(self, in_channels: int, mid_channels: int, out_channels: int):
        super().__init__()
        self.block = nn.Sequential(SeparableConv2d(in_channels, mid_channels),
                                   SeparableConv2d(mid_channels, mid_channels),
                                   nn.Conv2d(mid_channels, out_channels, 1))

    def forward(self, x):
        return self.block(x)


class DeepLabV3Plus(nn.Module):
    """(deeplab_v3.py:12-91)"""

    def __init__(self, ch: int = 256):
        super().__init__()
        self.backbone = ResNetV1s()
        self.skip_project = SkipProject(256, 32)
        self.aspp = ASPP(2048, ch)
        self.head = DeepLabHead(ch + 32, ch, ch)

    def forward(self, x, additional_features=None):
        c1, _, _, c4 = self.backbone(x, additional_features)
        c1 = self.skip_project(c1)
        x = bilinear_resize_align_corners(self.aspp(c4), *c1.shape[-2:])
        return self.head(torch.cat([x, c1], 1))


class SepConvHead(nn.Module):
    """SepConvHead(1, ch, ch // 2, num_layers=2) (basic_blocks.py)."""

    def __init__(self, in_channels: int, mid_channels: int):
        super().__init__()
        self.layers = nn.Sequential(SeparableConv2d(in_channels, mid_channels),
                                    SeparableConv2d(mid_channels, mid_channels),
                                    nn.Conv2d(mid_channels, 1, 1))

    def forward(self, x):
        return self.layers(x)


class DeepLabISModel(ClickEncoder):
    """(is_deeplab_model.py) DeepLabV3+ features and a separable-conv head,
    with HRNetISModel's click encoding and amp."""

    def __init__(self, deeplab_ch: int = 256, with_prev_mask: bool = True,
                 binary_prev_mask: bool = False, use_disks: bool = True,
                 norm_radius: float = 5.0, use_leaky_relu: bool = False,
                 amp: bool = False):
        super().__init__(with_prev_mask, binary_prev_mask, use_disks, norm_radius, amp)
        self.maps_transform = maps_transform(self.coord_channels, use_leaky_relu)
        self.feature_extractor = DeepLabV3Plus(deeplab_ch)
        self.head = SepConvHead(deeplab_ch, deeplab_ch // 2)

    def low_res_instances(self, image, points):
        """The logits before the upsample: [B, 1, H/4, W/4] fp32."""
        h, w = image.shape[-2:]
        with self.autocast(image):
            image, prev_mask = self._prepare_input(image)
            coord = self._coord_features(prev_mask, points, h, w)
            feats = self.feature_extractor(image, self.maps_transform(coord))
            out = self.head(feats)
        return out.float()

    def forward(self, image, points):
        h, w = image.shape[-2:]
        return {"instances": bilinear_resize_align_corners(
            self.low_res_instances(image, points), h, w)}
