"""Modified Aligned Xception backbone for DeepLabV3+ (NCHW).

Port of ``pylc_tpu/models/xception.py``: entry flow (3x3/2 conv to 32, 3x3
to 64, blocks to 128/256/728), 16 middle-flow blocks at 728 channels, exit
flow (a block to 1024 and three separable convs to 1536/1536/2048), the
low-level feature after ``block1`` and a ReLU (128 channels at stride 4).

Module names are the reference checkpoints' own, so an Xception ``.pth``
loads key for key: a separable conv is ``conv1`` (depthwise), ``bn``,
``pointwise``; a block's ``rep`` is a Sequential of [ReLU, separable,
norm] units whose leading ReLU is left out when ``start_with_relu`` is
false, so separable j sits at ``rep.{3j}`` in blocks 1-2 and at
``rep.{3j + 1}`` in blocks 3-20.  Every block has three units.

No ReLU here works in place: a block's skip path reads the block's input,
which an in-place ``rep.0`` would have rectified by then.
"""

from __future__ import annotations

from typing import Callable, List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F


class SeparableConv2d(nn.Module):
    """Depthwise 3x3 (padding = dilation, the "fixed" padding of a 3x3
    kernel) -> norm -> pointwise 1x1."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 dilation: int = 1,
                 norm: Callable[[int], nn.Module] = nn.BatchNorm2d):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, inplanes, 3, stride=stride,
                               padding=dilation, dilation=dilation,
                               groups=inplanes, bias=False)
        self.bn = norm(inplanes)
        self.pointwise = nn.Conv2d(inplanes, planes, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.pointwise(self.bn(self.conv1(x)))


class Block(nn.Module):
    def __init__(self, inplanes: int, planes: int, reps: int,
                 stride: int = 1, dilation: int = 1,
                 norm: Callable[[int], nn.Module] = nn.BatchNorm2d,
                 start_with_relu: bool = True, grow_first: bool = True,
                 is_last: bool = False):
        super().__init__()
        rep: List[nn.Module] = []

        def unit(cin: int, cout: int, s: int, d: int):
            rep.extend([nn.ReLU(), SeparableConv2d(cin, cout, s, d, norm),
                        norm(cout)])

        filters = inplanes
        if grow_first:
            unit(inplanes, planes, 1, dilation)
            filters = planes
        for _ in range(reps - 1):
            unit(filters, filters, 1, dilation)
        if not grow_first:
            unit(inplanes, planes, 1, dilation)
        if stride != 1:
            unit(planes, planes, 2, 1)
        elif is_last:
            unit(planes, planes, 1, 1)
        self.rep = nn.Sequential(*(rep if start_with_relu else rep[1:]))

        if planes != inplanes or stride != 1:
            self.skip = nn.Conv2d(inplanes, planes, 1, stride=stride,
                                  bias=False)
            self.skipbn = norm(planes)
        else:
            self.skip = None

    def forward(self, inp: torch.Tensor) -> torch.Tensor:
        x = self.rep(inp)
        skip = inp if self.skip is None else self.skipbn(self.skip(inp))
        return x + skip


class AlignedXception(nn.Module):
    """Output stride 16: returns (x [B, 2048, H/16, W/16], low_level_feat
    [B, 128, H/4, W/4])."""

    def __init__(self, norm: Callable[[int], nn.Module] = nn.BatchNorm2d):
        super().__init__()
        # output stride 16: block3 strides, the middle flow is not
        # dilated, the exit flow's separable convs are, by 2
        entry3_stride, mid_dil, exit_dil = 2, 1, (1, 2)

        # entry flow
        self.conv1 = nn.Conv2d(3, 32, 3, stride=2, padding=1, bias=False)
        self.bn1 = norm(32)
        self.conv2 = nn.Conv2d(32, 64, 3, padding=1, bias=False)
        self.bn2 = norm(64)
        self.block1 = Block(64, 128, 2, stride=2, norm=norm,
                            start_with_relu=False)
        self.block2 = Block(128, 256, 2, stride=2, norm=norm,
                            start_with_relu=False)
        self.block3 = Block(256, 728, 2, stride=entry3_stride, norm=norm,
                            is_last=True)
        # middle flow: block4..block19
        for i in range(4, 20):
            setattr(self, f"block{i}",
                    Block(728, 728, 3, dilation=mid_dil, norm=norm))
        # exit flow
        self.block20 = Block(728, 1024, 2, dilation=exit_dil[0], norm=norm,
                             grow_first=False, is_last=True)
        self.conv3 = SeparableConv2d(1024, 1536, 1, exit_dil[1], norm)
        self.bn3 = norm(1536)
        self.conv4 = SeparableConv2d(1536, 1536, 1, exit_dil[1], norm)
        self.bn4 = norm(1536)
        self.conv5 = SeparableConv2d(1536, 2048, 1, exit_dil[1], norm)
        self.bn5 = norm(2048)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        x = F.relu(self.block1(x))
        low_level_feat = x
        for i in range(2, 21):
            x = getattr(self, f"block{i}")(x)
        x = F.relu(x)
        for i in (3, 4, 5):
            x = F.relu(getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(x)))
        return x, low_level_feat
