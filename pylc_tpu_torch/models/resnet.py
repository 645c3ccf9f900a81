"""Dilated ResNet-101 backbone for DeepLabV3+ (NCHW).

Port of ``pylc_tpu/models/resnet.py``.  Module names follow the
reference checkpoints (``layer3.7.conv2``, ``layer1.0.downsample.0``), so
a reference ``.pth`` loads key for key.  ``remat`` rematerializes every
``Bottleneck`` in training (``models.layers.run_blocks``), as the JAX
package's ``nn.remat(Bottleneck)``; the stem is not.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from pylc_tpu_torch.models.layers import max_pool_3x3_s2_p1, run_blocks

MULTI_GRID = (1, 2, 4)  # layer4's dilation multipliers


class Bottleneck(nn.Module):
    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 dilation: int = 1, downsample: Optional[nn.Module] = None,
                 norm: Callable[[int], nn.Module] = nn.BatchNorm2d):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = norm(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride=stride,
                               padding=dilation, dilation=dilation,
                               bias=False)
        self.bn2 = norm(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = norm(planes * 4)
        self.downsample = downsample

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(y + residual)


class ResNet101(nn.Module):
    """Output stride 16: returns (x [B, 2048, H/16, W/16],
    low_level_feat [B, 256, H/4, W/4]).

    ``layers`` sets the block counts of layer1-3 (layer4 is the
    multi-grid unit), so tests can build a shallow ``(1, 1, 1, 1)``."""

    def __init__(self, norm: Callable[[int], nn.Module] = nn.BatchNorm2d,
                 layers: Sequence[int] = (3, 4, 23, 3), remat: bool = False):
        super().__init__()
        self.norm = norm
        self.remat = remat
        self.inplanes = 64
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = norm(64)
        # output stride 16: strides (1, 2, 2, 1), dilations (1, 1, 1, 2)
        self.layer1 = self._layer(64, [1] * layers[0], 1, 1)
        self.layer2 = self._layer(128, [1] * layers[1], 2, 1)
        self.layer3 = self._layer(256, [1] * layers[2], 2, 1)
        self.layer4 = self._layer(512, MULTI_GRID, 1, 2)

    def _layer(self, planes: int, grid: Sequence[int], stride: int,
               dilation: int) -> nn.Sequential:
        downsample = None
        if stride != 1 or self.inplanes != planes * 4:
            downsample = nn.Sequential(
                nn.Conv2d(self.inplanes, planes * 4, 1, stride=stride,
                          bias=False),
                self.norm(planes * 4))
        blocks = [Bottleneck(self.inplanes, planes, stride,
                             grid[0] * dilation, downsample, self.norm)]
        self.inplanes = planes * 4
        blocks += [Bottleneck(self.inplanes, planes, 1, g * dilation,
                              None, self.norm) for g in grid[1:]]
        return nn.Sequential(*blocks)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = F.relu(self.bn1(self.conv1(x)))
        x = max_pool_3x3_s2_p1(x)
        x = run_blocks(self.layer1, x, self.remat)
        low_level_feat = x
        for layer in (self.layer2, self.layer3, self.layer4):
            x = run_blocks(layer, x, self.remat)
        return x, low_level_feat
