"""ASPP head: 1x1 + three atrous 3x3 branches, image pooling, projection.

Port of ``pylc_tpu/models/aspp.py``, with the reference checkpoints'
module names (``aspp1.atrous_conv``, ``global_avg_pool.1``, ``conv1``).
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn as nn
import torch.nn.functional as F


class ASPPBranch(nn.Module):
    def __init__(self, inplanes: int, kernel: int, dilation: int,
                 norm: Callable[[int], nn.Module]):
        super().__init__()
        pad = 0 if kernel == 1 else dilation
        self.atrous_conv = nn.Conv2d(inplanes, 256, kernel, padding=pad,
                                     dilation=dilation, bias=False)
        self.bn = norm(256)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.atrous_conv(x)))


class ASPP(nn.Module):
    """Dilations 6/12/18 at output stride 16, 12/24/36 at 8, on the
    backbone's ``inplanes`` channels (2048 for ResNet and Xception, 320
    for MobileNetV2, 512 for DRN)."""

    def __init__(self, norm: Callable[[int], nn.Module] = nn.BatchNorm2d,
                 inplanes: int = 2048, output_stride: int = 16):
        super().__init__()
        dil = (1, 6, 12, 18) if output_stride == 16 else (1, 12, 24, 36)
        self.aspp1 = ASPPBranch(inplanes, 1, dil[0], norm)
        self.aspp2 = ASPPBranch(inplanes, 3, dil[1], norm)
        self.aspp3 = ASPPBranch(inplanes, 3, dil[2], norm)
        self.aspp4 = ASPPBranch(inplanes, 3, dil[3], norm)
        self.global_avg_pool = nn.Sequential(
            nn.AdaptiveAvgPool2d((1, 1)),
            nn.Conv2d(inplanes, 256, 1, bias=False),
            norm(256),
            nn.ReLU())
        self.conv1 = nn.Conv2d(1280, 256, 1, bias=False)
        self.bn1 = norm(256)
        self.dropout = nn.Dropout(0.5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b4 = self.aspp4(x)
        # align-corners resize of a 1x1 map is a broadcast
        g = self.global_avg_pool(x).expand_as(b4)
        y = torch.cat([self.aspp1(x), self.aspp2(x), self.aspp3(x), b4, g],
                      dim=1)
        return self.dropout(F.relu(self.bn1(self.conv1(y))))
