"""RITM's iterative-mask HRNet model in plain float32 torch.

SamsungLabs ritm_interactive_segmentation (arXiv:2102.06583):
isegm/model/is_hrnet_model.py (HRNetModel), is_model.py (ISModel:
the input normalisation, the previous-mask channel, the click maps and
maps_transform), ops.py (DistMaps, ScaleLayer) and
modeling/hrnet_ocr.py, ocr.py, basic_blocks.py, resnetv1b.py (HRNet-W18
with its OCR head). Modules carry upstream's names, so one state dict
loads here and into the program's model.

The normalisation layers are nn.BatchNorm2d in eval mode (upstream's
norm_layer at inference); dropout is inactive at inference and left out.
"""
from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


def _up(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    return F.interpolate(x, size=(h, w), mode="bilinear", align_corners=True)


def _conv_bn(cin, cout, k, stride=1, relu=True, bias=False):
    layers = [nn.Conv2d(cin, cout, k, stride, k // 2, bias=bias), nn.BatchNorm2d(cout)]
    return nn.Sequential(*layers, nn.ReLU()) if relu else nn.Sequential(*layers)


class BasicBlock(nn.Module):
    def __init__(self, cin: int, c: int):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, c, 3, 1, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(c)
        self.conv2 = nn.Conv2d(c, c, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(c)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        return F.relu(self.bn2(self.conv2(out)) + x)


class Bottleneck(nn.Module):
    def __init__(self, cin: int, c: int):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, c, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(c)
        self.conv2 = nn.Conv2d(c, c, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(c)
        self.conv3 = nn.Conv2d(c, 4 * c, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(4 * c)
        self.downsample = (nn.Sequential(nn.Conv2d(cin, 4 * c, 1, bias=False),
                                         nn.BatchNorm2d(4 * c))
                           if cin != 4 * c else None)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return F.relu(out + (x if self.downsample is None else self.downsample(x)))


class HighResolutionModule(nn.Module):
    """hrnet_ocr.py HighResolutionModule: a branch of BasicBlocks a width,
    then each output sums every branch brought to its resolution (1x1 conv
    and upsampling from below, stride-2 3x3 convs from above)."""

    def __init__(self, blocks: int, chans: List[int]):
        super().__init__()
        self.branches = nn.ModuleList(
            nn.Sequential(*[BasicBlock(c, c) for _ in range(blocks)]) for c in chans)
        self.fuse_layers = nn.ModuleList()
        for i, ci in enumerate(chans):
            row = []
            for j, cj in enumerate(chans):
                if j > i:
                    row.append(_conv_bn(cj, ci, 1, relu=False))
                elif j == i:
                    row.append(None)
                else:
                    row.append(nn.Sequential(*[
                        _conv_bn(cj, ci if k == i - j - 1 else cj, 3, 2,
                                 relu=k != i - j - 1) for k in range(i - j)]))
            self.fuse_layers.append(nn.ModuleList(row))

    def forward(self, x):
        x = [b(t) for b, t in zip(self.branches, x)]
        out = []
        for i, row in enumerate(self.fuse_layers):
            y = x[0] if i == 0 else row[0](x[0])
            for j in range(1, len(x)):
                if j == i:
                    y = y + x[j]
                elif j > i:
                    y = y + _up(row[j](x[j]), *x[i].shape[-2:])
                else:
                    y = y + row[j](x[j])
            out.append(F.relu(y))
        return out


class SpatialGather(nn.Module):
    """ocr.py SpatialGather_Module (scale 1)."""

    def forward(self, feats, probs):
        b, k = probs.shape[:2]
        probs = F.softmax(probs.view(b, k, -1), dim=2)
        feats = feats.view(b, feats.shape[1], -1).permute(0, 2, 1)
        return torch.matmul(probs, feats).permute(0, 2, 1).unsqueeze(3)


def _conv_bnrelu(cin, cout):
    return [nn.Conv2d(cin, cout, 1, bias=False),
            nn.Sequential(nn.BatchNorm2d(cout), nn.ReLU())]


class ObjectAttentionBlock2D(nn.Module):
    """ocr.py ObjectAttentionBlock2D (scale 1: no pooling)."""

    def __init__(self, cin: int, key: int):
        super().__init__()
        self.key = key
        self.f_pixel = nn.Sequential(*_conv_bnrelu(cin, key), *_conv_bnrelu(key, key))
        self.f_object = nn.Sequential(*_conv_bnrelu(cin, key), *_conv_bnrelu(key, key))
        self.f_down = nn.Sequential(*_conv_bnrelu(cin, key))
        self.f_up = nn.Sequential(*_conv_bnrelu(key, cin))

    def forward(self, x, proxy):
        b = x.shape[0]
        query = self.f_pixel(x).view(b, self.key, -1).permute(0, 2, 1)
        key = self.f_object(proxy).view(b, self.key, -1)
        value = self.f_down(proxy).view(b, self.key, -1).permute(0, 2, 1)
        sim = F.softmax((self.key ** -0.5) * torch.matmul(query, key), dim=-1)
        context = torch.matmul(sim, value).permute(0, 2, 1).contiguous()
        return self.f_up(context.view(b, self.key, *x.shape[2:]))


class SpatialOCR(nn.Module):
    """ocr.py SpatialOCR_Module."""

    def __init__(self, cin: int, key: int, cout: int):
        super().__init__()
        self.object_context_block = ObjectAttentionBlock2D(cin, key)
        self.conv_bn_dropout = nn.Sequential(*_conv_bnrelu(2 * cin, cout))

    def forward(self, feats, proxy):
        context = self.object_context_block(feats, proxy)
        return self.conv_bn_dropout(torch.cat([context, feats], 1))


class HighResolutionNet(nn.Module):
    """hrnet_ocr.py HighResolutionNet with num_classes 1:
    compute_hrnet_feats (the aggregated features, f-BRS's insertion point
    A) and the OCR head on them."""

    def __init__(self, width: int = 18, ocr_width: int = 64, small: bool = False):
        super().__init__()
        blocks = 2 if small else 4
        self.conv1 = nn.Conv2d(3, 64, 3, 2, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        self.conv2 = nn.Conv2d(64, 64, 3, 2, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(64)
        self.layer1 = nn.Sequential(*[Bottleneck(64 if i == 0 else 256, 64)
                                      for i in range(blocks)])
        c2, c3, c4 = ([width * m for m in (1, 2, 4, 8)[:n]] for n in (2, 3, 4))
        self.transition1 = self._transition([256], c2)
        self.stage2 = nn.Sequential(HighResolutionModule(blocks, c2))
        self.transition2 = self._transition(c2, c3)
        self.stage3 = nn.Sequential(*[HighResolutionModule(blocks, c3)
                                      for _ in range(3 if small else 4)])
        self.transition3 = self._transition(c3, c4)
        self.stage4 = nn.Sequential(*[HighResolutionModule(blocks, c4)
                                      for _ in range(2 if small else 3)])
        last, mid = sum(c4), 2 * ocr_width
        self.conv3x3_ocr = _conv_bn(last, mid, 3, bias=True)
        self.ocr_gather_head = SpatialGather()
        self.ocr_distri_head = SpatialOCR(mid, ocr_width, mid)
        self.cls_head = nn.Conv2d(mid, 1, 1)
        self.aux_head = nn.Sequential(nn.Conv2d(last, last, 1), nn.BatchNorm2d(last),
                                      nn.ReLU(), nn.Conv2d(last, 1, 1))

    @staticmethod
    def _transition(pre: List[int], cur: List[int]) -> nn.ModuleList:
        layers = []
        for i, c in enumerate(cur):
            if i < len(pre):
                layers.append(_conv_bn(pre[i], c, 3) if c != pre[i] else None)
            else:
                layers.append(nn.Sequential(*[
                    _conv_bn(pre[-1], c if j == i - len(pre) else pre[-1], 3, 2)
                    for j in range(i + 1 - len(pre))]))
        return nn.ModuleList(layers)

    @staticmethod
    def _branches(transition, ys):
        return [ys[i] if t is None else t(ys[i] if i < len(ys) else ys[-1])
                for i, t in enumerate(transition)]

    def compute_hrnet_feats(self, x, additional_features: Optional[torch.Tensor]):
        x = F.relu(self.bn1(self.conv1(x)))
        if additional_features is not None:
            x = x + additional_features
        x = self.layer1(F.relu(self.bn2(self.conv2(x))))
        ys = self.stage2(self._branches(self.transition1, [x]))
        ys = self.stage3(self._branches(self.transition2, ys))
        ys = self.stage4(self._branches(self.transition3, ys))
        h, w = ys[0].shape[-2:]
        return torch.cat([ys[0]] + [_up(t, h, w) for t in ys[1:]], 1)

    def head(self, feats):
        """The OCR head and cls_head on the aggregated features: logits at
        stride 4 (f-BRS-A/B's get_prediction_logits before its upsample)."""
        out_aux = self.aux_head(feats)
        feats = self.conv3x3_ocr(feats)
        context = self.ocr_gather_head(feats, out_aux)
        return self.cls_head(self.ocr_distri_head(feats, context))


class ScaleLayer(nn.Module):
    """ops.py ScaleLayer (lr_mult 1): x * |scale|."""

    def __init__(self, init_value: float = 0.05):
        super().__init__()
        self.scale = nn.Parameter(torch.full((1,), init_value))

    def forward(self, x):
        return x * torch.abs(self.scale)


def dist_maps(points: torch.Tensor, h: int, w: int, norm_radius: float,
              use_disks: bool) -> torch.Tensor:
    """ops.py DistMaps.get_coord_features (spatial_scale 1): points [B, 2K,
    3], the positive clicks then the negative ones, (-1, -1, -1) padded ->
    [B, 2, H, W]: disks of radius norm_radius, or tanh(2 * distance /
    norm_radius)."""
    b, n, _ = points.shape
    pts = points.reshape(-1, 3)[:, :2].float()
    invalid = pts.max(dim=1)[0] < 0
    rows = torch.arange(h, dtype=torch.float32, device=points.device)
    cols = torch.arange(w, dtype=torch.float32, device=points.device)
    dy = rows[None, :, None] - pts[:, 0, None, None]
    dx = cols[None, None, :] - pts[:, 1, None, None]
    if not use_disks:
        dy, dx = dy / norm_radius, dx / norm_radius
    d = dy * dy + dx * dx
    d[invalid] = 1e6
    d = d.view(b * 2, n // 2, h, w).min(dim=1)[0].view(b, 2, h, w)
    if use_disks:
        return (d <= norm_radius ** 2).float()
    return torch.tanh(2 * torch.sqrt(d))


class HRNetISModel(nn.Module):
    """is_hrnet_model.py HRNetModel over is_model.py ISModel, with
    maps_transform (use_rgb_conv False) and the previous-mask channel."""

    def __init__(self, width=18, ocr_width=64, small=False, with_prev_mask=True,
                 use_disks=True, norm_radius=5, use_rgb_conv=False,
                 use_leaky_relu=True):
        super().__init__()
        if use_rgb_conv or not with_prev_mask:
            raise NotImplementedError("the reference covers the itermask "
                                      "configuration: maps_transform and a "
                                      "previous-mask channel")
        self.use_disks, self.norm_radius = use_disks, norm_radius
        self.feature_extractor = HighResolutionNet(width, ocr_width, small)
        act = nn.LeakyReLU(0.2) if use_leaky_relu else nn.ReLU()
        self.maps_transform = nn.Sequential(nn.Conv2d(3, 16, 1), act,
                                            nn.Conv2d(16, 64, 3, 2, 1), ScaleLayer(0.05))

    def features(self, image, points):
        """image [B, 4, H, W] (RGB in [0, 1] and the previous mask), points
        [B, 2K, 3] -> the aggregated HRNet features [B, 15 * width, H/4, W/4]."""
        rgb, prev = image[:, :3], image[:, 3:]
        mean = rgb.new_tensor(MEAN)[None, :, None, None]
        std = rgb.new_tensor(STD)[None, :, None, None]
        coord = torch.cat([prev, dist_maps(points, *image.shape[-2:], self.norm_radius,
                                           self.use_disks)], 1)
        return self.feature_extractor.compute_hrnet_feats(
            (rgb - mean) / std, self.maps_transform(coord))

    def forward(self, image, points):
        """-> logits [B, 1, H, W], upsampled from stride 4."""
        low = self.feature_extractor.head(self.features(image, points))
        return _up(low, *image.shape[-2:])
