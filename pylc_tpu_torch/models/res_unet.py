"""Residual U-Net, with the U-Net's valid-conv geometry.

Port of ``pylc_tpu/models/res_unet.py``: a block is conv-norm-act-conv-norm
plus a shortcut, then the activation; the shortcut is the block's input,
through a 1x1 conv without bias (``shortcut_proj``) where the channel count
changes, center-cropped to the block's output.  No dropout.

Key names are the port's, as in ``models/unet.py``; the decoder's block
carries the weights of flax's ``UNetResBlock_0``.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn as nn
import torch.nn.functional as F

from pylc_tpu_torch.models.layers import center_crop
from pylc_tpu_torch.models.unet import UpSample, unet_forward


class UNetResBlock(nn.Module):
    def __init__(self, inplanes: int, features: int,
                 norm: Callable[[int], nn.Module], act: Callable):
        super().__init__()
        self.conv0 = nn.Conv2d(inplanes, features, 3)
        self.norm0 = norm(features)
        self.conv1 = nn.Conv2d(features, features, 3)
        self.norm1 = norm(features)
        self.shortcut_proj = None if inplanes == features else \
            nn.Conv2d(inplanes, features, 1, bias=False)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.act(self.norm0(self.conv0(x)))
        y = self.norm1(self.conv1(y))
        residual = x if self.shortcut_proj is None else self.shortcut_proj(x)
        residual = center_crop(residual, y.shape[-2], y.shape[-1])
        return self.act(y + residual.to(y.dtype))


class ResUNetUpBlock(UpSample):
    def __init__(self, inplanes: int, features: int, up_mode: str,
                 norm: Callable[[int], nn.Module], act: Callable):
        super().__init__(inplanes, features, up_mode)
        self.block = UNetResBlock(2 * features, features, norm, act)

    def forward(self, x: torch.Tensor, bridge: torch.Tensor) -> torch.Tensor:
        x = super().forward(x)
        bridge = center_crop(bridge, x.shape[-2], x.shape[-1])
        return self.block(torch.cat([x, bridge.to(x.dtype)], dim=1))


class ResUNet(nn.Module):
    """x: [B, in_channels, H, W] normalized input -> [B, n_classes, h, w]
    f32 logits."""

    def __init__(self, n_classes: int = 9, in_channels: int = 3,
                 depth: int = 5, wf: int = 6, up_mode: str = "upsample",
                 norm: Callable[[int], nn.Module] = nn.BatchNorm2d,
                 act: Callable = F.relu):
        super().__init__()
        self.depth = depth
        prev = in_channels
        for i in range(depth):
            setattr(self, f"enc{i}", UNetResBlock(prev, 2 ** (wf + i), norm,
                                                  act))
            prev = 2 ** (wf + i)
        for i, j in enumerate(reversed(range(depth - 1))):
            setattr(self, f"dec{i}", ResUNetUpBlock(prev, 2 ** (wf + j),
                                                    up_mode, norm, act))
            prev = 2 ** (wf + j)
        self.head = nn.Conv2d(prev, n_classes, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return unet_forward(self, x)
