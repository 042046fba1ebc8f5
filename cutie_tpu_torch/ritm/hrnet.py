"""HRNet-W18/W48 + OCR backbone for interactive click segmentation (NCHW).

The port's counterpart of cutie_tpu/ritm/hrnet.py (reference
gui/ritm/model/modeling/hrnet_ocr.py, ocr.py, resnetv1b.py). Modules are
laid out as the reference lays them out (nn.Sequential wherever it uses
one), so that the reference state dict loads by name. BatchNorm runs in
eval mode: models/layers.py:FrozenBatchNorm, whose affine stays trainable.
The cross-resolution fusion upsamples with align_corners=True.
"""
from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from cutie_tpu_torch.models.layers import FrozenBatchNorm
from cutie_tpu_torch.ops.resize import bilinear_resize_align_corners


def conv_bn(cin: int, cout: int, kernel: int, stride: int = 1, relu: bool = False,
            bias: bool = False) -> nn.Sequential:
    layers = [nn.Conv2d(cin, cout, kernel, stride, kernel // 2, bias=bias),
              FrozenBatchNorm(cout)]
    return nn.Sequential(*layers, nn.ReLU()) if relu else nn.Sequential(*layers)


def conv_bnrelu(cin: int, cout: int) -> List[nn.Module]:
    """A 1x1 conv and its norm wrapped with the ReLU, as ocr.py nests them."""
    return [nn.Conv2d(cin, cout, 1, bias=False),
            nn.Sequential(FrozenBatchNorm(cout), nn.ReLU())]


class BasicBlockV1b(nn.Module):
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: Optional[nn.Module] = None):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 3, stride, 1, bias=False)
        self.bn1 = FrozenBatchNorm(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = FrozenBatchNorm(planes)
        self.downsample = downsample

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(out + residual)


class BottleneckV1b(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: Optional[nn.Module] = None, dilation: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = FrozenBatchNorm(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, dilation, dilation,
                               bias=False)
        self.bn2 = FrozenBatchNorm(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = FrozenBatchNorm(planes * 4)
        self.downsample = downsample

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(out + residual)


def make_layer(block, inplanes: int, planes: int, blocks: int) -> nn.Sequential:
    downsample = None
    if inplanes != planes * block.expansion:
        downsample = nn.Sequential(
            nn.Conv2d(inplanes, planes * block.expansion, 1, bias=False),
            FrozenBatchNorm(planes * block.expansion))
    layers = [block(inplanes, planes, downsample=downsample)]
    layers += [block(planes * block.expansion, planes) for _ in range(blocks - 1)]
    return nn.Sequential(*layers)


class HighResolutionModule(nn.Module):
    """(hrnet_ocr.py:13-152) A branch of BasicBlocks for each width, then
    every branch's output sums every branch brought to its resolution."""

    def __init__(self, num_blocks: int, channels: List[int]):
        super().__init__()
        self.branches = nn.ModuleList(
            make_layer(BasicBlockV1b, c, c, num_blocks) for c in channels)
        fuse = []
        for i in range(len(channels)):
            row = []
            for j in range(len(channels)):
                if j > i:     # 1x1 conv to branch i's width, then upsampled
                    row.append(conv_bn(channels[j], channels[i], 1))
                elif j == i:
                    row.append(None)
                else:         # i - j stride-2 3x3 convs
                    row.append(nn.Sequential(*[
                        conv_bn(channels[j], channels[i] if k == i - j - 1 else channels[j],
                                3, 2, relu=k != i - j - 1)
                        for k in range(i - j)]))
            fuse.append(nn.ModuleList(row))
        self.fuse_layers = nn.ModuleList(fuse)

    def forward(self, x: List[torch.Tensor]) -> List[torch.Tensor]:
        x = [branch(t) for branch, t in zip(self.branches, x)]
        out = []
        for i, row in enumerate(self.fuse_layers):
            y = None
            for j, layer in enumerate(row):
                if j == i:
                    t = x[j]
                elif j > i:
                    t = bilinear_resize_align_corners(layer(x[j]), *x[i].shape[-2:])
                else:
                    t = layer(x[j])
                y = t if y is None else y + t
            out.append(F.relu(y))
        return out


class SpatialGather(nn.Module):
    """Soft class-context pooling (ocr.py:7-27): feats [B, C, H, W], probs
    [B, K, H, W] -> context [B, C, K, 1]."""

    def __init__(self, scale: float = 1.0):
        super().__init__()
        self.scale = scale

    def forward(self, feats, probs):
        b, k = probs.shape[:2]
        probs = F.softmax(self.scale * probs.reshape(b, k, -1), dim=2)
        feats = feats.reshape(b, feats.shape[1], -1).transpose(1, 2)
        return torch.matmul(probs, feats).transpose(1, 2).unsqueeze(3)


class ObjectAttentionBlock2D(nn.Module):
    """(ocr.py:63-141) x [B, C, H, W]; proxy [B, C, K, 1] -> [B, C, H, W]."""

    def __init__(self, in_channels: int, key_channels: int):
        super().__init__()
        self.key_channels = key_channels
        self.f_pixel = nn.Sequential(*conv_bnrelu(in_channels, key_channels),
                                     *conv_bnrelu(key_channels, key_channels))
        self.f_object = nn.Sequential(*conv_bnrelu(in_channels, key_channels),
                                      *conv_bnrelu(key_channels, key_channels))
        self.f_down = nn.Sequential(*conv_bnrelu(in_channels, key_channels))
        self.f_up = nn.Sequential(*conv_bnrelu(key_channels, in_channels))

    def forward(self, x, proxy):
        b, kc = x.shape[0], self.key_channels
        query = self.f_pixel(x).reshape(b, kc, -1).transpose(1, 2)
        key = self.f_object(proxy).reshape(b, kc, -1)
        value = self.f_down(proxy).reshape(b, kc, -1).transpose(1, 2)
        sim = F.softmax(torch.matmul(query, key) * kc ** -0.5, dim=-1)
        context = torch.matmul(sim, value).transpose(1, 2)
        return self.f_up(context.reshape(b, kc, *x.shape[2:]))


class SpatialOCR(nn.Module):
    """(ocr.py:30-60); dropout is inactive at inference."""

    def __init__(self, in_channels: int, key_channels: int, out_channels: int):
        super().__init__()
        self.object_context_block = ObjectAttentionBlock2D(in_channels, key_channels)
        self.conv_bn_dropout = nn.Sequential(*conv_bnrelu(2 * in_channels, out_channels))

    def forward(self, feats, proxy_feats):
        context = self.object_context_block(feats, proxy_feats)
        return self.conv_bn_dropout(torch.cat([context, feats], 1))


class HighResolutionNet(nn.Module):
    """(hrnet_ocr.py:155-398) backbone(x, additional_features) gives the
    aggregated multi-resolution features (f-BRS insertion point 'A');
    head(feats) -> (logits, aux logits) at stride 4; head_ocr(feats) ->
    (OCR features, aux), insertion point 'C'; cls_from_ocr(ocr feats) ->
    logits. The additional features are added after conv1/bn1/relu."""

    def __init__(self, width: int = 18, num_classes: int = 1, ocr_width: int = 64,
                 small: bool = False, in_channels: int = 3):
        super().__init__()
        blocks = 2 if small else 4
        self.ocr_width = ocr_width
        self.conv1 = nn.Conv2d(in_channels, 64, 3, 2, 1, bias=False)
        self.bn1 = FrozenBatchNorm(64)
        self.conv2 = nn.Conv2d(64, 64, 3, 2, 1, bias=False)
        self.bn2 = FrozenBatchNorm(64)
        self.layer1 = make_layer(BottleneckV1b, 64, 64, blocks)
        chans = [[width * m for m in (1, 2, 4, 8)[:n]] for n in (2, 3, 4)]
        self.transition1 = self._transition([256], chans[0])
        self.stage2 = nn.Sequential(HighResolutionModule(blocks, chans[0]))
        self.transition2 = self._transition(chans[0], chans[1])
        self.stage3 = nn.Sequential(*[HighResolutionModule(blocks, chans[1])
                                      for _ in range(3 if small else 4)])
        self.transition3 = self._transition(chans[1], chans[2])
        self.stage4 = nn.Sequential(*[HighResolutionModule(blocks, chans[2])
                                      for _ in range(2 if small else 3)])
        last = sum(chans[2])
        if ocr_width > 0:
            mid = 2 * ocr_width
            self.conv3x3_ocr = conv_bn(last, mid, 3, relu=True, bias=True)
            self.ocr_gather_head = SpatialGather()
            self.ocr_distri_head = SpatialOCR(mid, ocr_width, mid)
            self.cls_head = nn.Conv2d(mid, num_classes, 1)
            self.aux_head = nn.Sequential(nn.Conv2d(last, last, 1), FrozenBatchNorm(last),
                                          nn.ReLU(), nn.Conv2d(last, num_classes, 1))
        else:
            self.cls_head = nn.Sequential(nn.Conv2d(last, last, 3, 1, 1),
                                          FrozenBatchNorm(last), nn.ReLU(),
                                          nn.Conv2d(last, num_classes, 1))

    @staticmethod
    def _transition(pre: List[int], cur: List[int]) -> nn.ModuleList:
        layers = []
        for i, c in enumerate(cur):
            if i < len(pre):
                layers.append(conv_bn(pre[i], c, 3, relu=True) if c != pre[i] else None)
            else:
                layers.append(nn.Sequential(*[
                    conv_bn(pre[-1], c if j == i - len(pre) else pre[-1], 3, 2, relu=True)
                    for j in range(i + 1 - len(pre))]))
        return nn.ModuleList(layers)

    @staticmethod
    def _apply_transition(transition: nn.ModuleList, x: List[torch.Tensor]):
        return [x[i] if layer is None else layer(x[i] if i < len(x) else x[-1])
                for i, layer in enumerate(transition)]

    def backbone(self, x, additional_features=None):
        x = F.relu(self.bn1(self.conv1(x)))
        if additional_features is not None:
            x = x + additional_features
        x = F.relu(self.bn2(self.conv2(x)))
        xs = self._apply_transition(self.transition1, [self.layer1(x)])
        xs = self.stage2(xs)
        xs = self.stage3(self._apply_transition(self.transition2, xs))
        xs = self.stage4(self._apply_transition(self.transition3, xs))
        h, w = xs[0].shape[-2:]
        return torch.cat([xs[0]] + [bilinear_resize_align_corners(t, h, w)
                                    for t in xs[1:]], 1)

    def head_ocr(self, feats):
        aux = self.aux_head(feats)
        ocr = self.conv3x3_ocr(feats)
        return self.ocr_distri_head(ocr, self.ocr_gather_head(ocr, aux)), aux

    def cls_from_ocr(self, ocr_feats):
        return self.cls_head(ocr_feats)

    def head(self, feats):
        if self.ocr_width > 0:
            ocr, aux = self.head_ocr(feats)
            return self.cls_head(ocr), aux
        return self.cls_head(feats), None

    def forward(self, x, additional_features=None):
        return self.head(self.backbone(x, additional_features))
