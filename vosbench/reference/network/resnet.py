"""Frozen copy of cutie_tpu_torch/models/resnet.py for the benchmark's plain
reference (vosbench/reference): later changes to the port do not reach it.

ResNet-18/50 trunks (conv1 .. layer3) with extra input channels.

The port's counterpart of cutie_tpu/models/resnet.py (reference
cutie/model/utils/resnet.py). Only the trunk the encoders use is built
(layer4 is never read), with frozen BatchNorm and the reference's plain
7x7/s2 stem conv; the extra input channels carry the mask planes.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from vosbench.reference.network.layers import FrozenBatchNorm


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 3, stride, 1, bias=False)
        self.bn1 = FrozenBatchNorm(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = FrozenBatchNorm(planes)
        self.downsample = None
        if stride != 1 or inplanes != planes:
            self.downsample = nn.Sequential(
                nn.Conv2d(inplanes, planes, 1, stride, bias=False),
                FrozenBatchNorm(planes))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        r = x if self.downsample is None else self.downsample(x)
        return F.relu(out + r)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = FrozenBatchNorm(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = FrozenBatchNorm(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = FrozenBatchNorm(planes * 4)
        self.downsample = None
        if stride != 1 or inplanes != planes * 4:
            self.downsample = nn.Sequential(
                nn.Conv2d(inplanes, planes * 4, 1, stride, bias=False),
                FrozenBatchNorm(planes * 4))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        r = x if self.downsample is None else self.downsample(x)
        return F.relu(out + r)


class ResNetTrunk(nn.Module):
    """conv1 .. layer3 of ResNet-18 or -50. Input [B, 3+extra_dim, H, W];
    returns (f4, f8, f16) at strides 4, 8, 16. `layer1_name` is 'res2' in
    the pixel encoder (reference big_modules.py:39) and 'layer1' elsewhere."""

    def __init__(self, variant: str, extra_dim: int = 0,
                 layer1_name: str = "layer1"):
        super().__init__()
        if variant == "resnet18":
            block, layers = BasicBlock, (2, 2, 2)
        elif variant == "resnet50":
            block, layers = Bottleneck, (3, 4, 6)
        else:
            raise NotImplementedError(variant)
        self.layer1_name = layer1_name
        self.conv1 = nn.Conv2d(3 + extra_dim, 64, 7, 2, 3, bias=False)
        self.bn1 = FrozenBatchNorm(64)
        inplanes = 64
        for li, (planes, blocks) in enumerate(zip((64, 128, 256), layers)):
            stride = 1 if li == 0 else 2
            mods = []
            for bi in range(blocks):
                mods.append(block(inplanes, planes, stride if bi == 0 else 1))
                inplanes = planes * block.expansion
            name = layer1_name if li == 0 else f"layer{li + 1}"
            self.add_module(name, nn.Sequential(*mods))

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        f4 = getattr(self, self.layer1_name)(x)
        f8 = self.layer2(f4)
        f16 = self.layer3(f8)
        return f4, f8, f16
