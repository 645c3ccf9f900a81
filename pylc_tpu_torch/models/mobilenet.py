"""MobileNetV2 backbone for DeepLabV3+ (NCHW).

Port of ``pylc_tpu/models/mobilenet.py``: inverted-residual blocks (expand
1x1 -> depthwise 3x3 -> linear 1x1) with ReLU6, width 1.0, the paper's
(t, c, n, s) table, and the output-stride plan: once the running stride
reaches ``output_stride``, later stages keep stride 1 and dilate their
depthwise convs by the accumulated rate.

Module names are the torchvision-era checkpoints' (``features.{i}.conv.{j}``;
an expand-1 block is [dw, bn, relu6, pw, bn], the others [pw, bn, relu6, dw,
bn, relu6, pw, bn]), so ``mobilenet_v2-*.pth`` loads into the backbone.

Padding follows the reference: the whole block input is zero-padded by
2 x dilation before the expand conv, and the depthwise conv runs unpadded,
so the pad ring goes through the expand conv and its norm and border
pixels see norm(0), not 0.

``remat`` rematerializes every ``InvertedResidual`` in training
(``models.layers.run_blocks``), as the JAX package's
``nn.remat(InvertedResidual)``; the stem (``features.0``) is not.
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from pylc_tpu_torch.models.layers import run_blocks

# (expand ratio t, out channels c, repeats n, stride s)
SETTINGS: Sequence[Tuple[int, int, int, int]] = (
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
)
LOW_LEVEL_BLOCKS = 4  # features[0:4]: the stem and three blocks, 24 channels


class InvertedResidual(nn.Module):
    def __init__(self, inp: int, oup: int, stride: int, dilation: int,
                 expand: int, norm: Callable[[int], nn.Module]):
        super().__init__()
        hidden = round(inp * expand)
        self.use_res_connect = stride == 1 and inp == oup
        self.pad = dilation  # on each side: 2 x dilation in all
        layers = []
        if expand != 1:
            layers += [nn.Conv2d(inp, hidden, 1, bias=False), norm(hidden),
                       nn.ReLU6()]
        layers += [
            nn.Conv2d(hidden, hidden, 3, stride=stride, padding=0,
                      dilation=dilation, groups=hidden, bias=False),
            norm(hidden), nn.ReLU6(),
            nn.Conv2d(hidden, oup, 1, bias=False), norm(oup)]
        self.conv = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv(F.pad(x, (self.pad,) * 4))
        return x + y if self.use_res_connect else y


class MobileNetV2(nn.Module):
    """Returns (x [B, 320, H/os, W/os], low_level_feat [B, 24, H/4,
    W/4])."""

    def __init__(self, norm: Callable[[int], nn.Module] = nn.BatchNorm2d,
                 output_stride: int = 16, remat: bool = False):
        super().__init__()
        self.remat = remat
        if output_stride not in (8, 16):
            raise NotImplementedError(f"output_stride {output_stride}")
        features = [nn.Sequential(
            nn.Conv2d(3, 32, 3, stride=2, padding=1, bias=False), norm(32),
            nn.ReLU6())]
        inp, stride_now, rate = 32, 2, 1
        for t, c, n, s in SETTINGS:
            if stride_now == output_stride:
                stride, dilation = 1, rate
                rate *= s
            else:
                stride, dilation = s, 1
                stride_now *= s
            for i in range(n):
                features.append(InvertedResidual(
                    inp, c, stride if i == 0 else 1, dilation, t, norm))
                inp = c
        self.features = nn.Sequential(*features)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = self.features[0](x)
        low_level_feat = run_blocks(self.features[1:LOW_LEVEL_BLOCKS], x,
                                    self.remat)
        return run_blocks(self.features[LOW_LEVEL_BLOCKS:], low_level_feat,
                          self.remat), low_level_feat
