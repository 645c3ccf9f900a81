"""U-Net with valid (unpadded) convolutions: 512 px in, 324 px out.

Port of ``pylc_tpu/models/unet.py``: depth 5, 2**wf filters in the first
block, two unpadded 3x3 convs (with bias) each followed by the norm and the
activation, dropout after the pair, a 2x2 max-pool between encoder blocks,
a decoder that upsamples (``upsample``: align-corners x2, then a 1x1 conv;
``upconv``: a 2x2 transposed conv at stride 2), concatenates the
center-cropped encoder output and runs a block, and a 1x1 head in f32.

The reference has no key names for this model; these are the port's, with
the flax names they carry weights from (``convert.state_dict_from_jax``):

  ``enc{i}`` / ``dec{i}``                       the same
  ``enc{i}.conv{k}`` / ``.norm{k}``             ``Conv_{k}`` / ``BatchNorm_{k}``,
                                                ``GroupNorm_{k}`` or ``LayerNorm_{k}``
  ``dec{i}.up`` (``upconv``)                    ``ConvTranspose_0``
  ``dec{i}.up`` (``upsample``: the 1x1 conv)    ``Conv_0``
  ``dec{i}.block.conv{k}`` / ``.norm{k}``       ``UNetConvBlock_0/Conv_{k}`` ...
  ``head``                                      ``head``
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn as nn
import torch.nn.functional as F

from pylc_tpu_torch.models.layers import (
    center_crop, resize_bilinear_align_corners,
)


class UNetConvBlock(nn.Module):
    def __init__(self, inplanes: int, features: int,
                 norm: Callable[[int], nn.Module], act: Callable,
                 dropout: float = 0.0):
        super().__init__()
        self.conv0 = nn.Conv2d(inplanes, features, 3)
        self.norm0 = norm(features)
        self.conv1 = nn.Conv2d(features, features, 3)
        self.norm1 = norm(features)
        self.act = act
        self.dropout = nn.Dropout(dropout) if dropout else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.act(self.norm0(self.conv0(x)))
        x = self.act(self.norm1(self.conv1(x)))
        return x if self.dropout is None else self.dropout(x)


class UpSample(nn.Module):
    """``up_mode`` "upconv": ``up`` is a 2x2 transposed conv at stride 2;
    "upsample": an align-corners x2 resize, then ``up``, a 1x1 conv."""

    def __init__(self, inplanes: int, features: int, up_mode: str):
        super().__init__()
        self.resize = up_mode != "upconv"
        self.up = nn.Conv2d(inplanes, features, 1) if self.resize else \
            nn.ConvTranspose2d(inplanes, features, 2, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.resize:
            x = resize_bilinear_align_corners(x, x.shape[-2] * 2,
                                              x.shape[-1] * 2)
        return self.up(x)


class UNetUpBlock(UpSample):
    def __init__(self, inplanes: int, features: int, up_mode: str,
                 norm: Callable[[int], nn.Module], act: Callable,
                 dropout: float = 0.0):
        super().__init__(inplanes, features, up_mode)
        self.block = UNetConvBlock(2 * features, features, norm, act,
                                   dropout)

    def forward(self, x: torch.Tensor, bridge: torch.Tensor) -> torch.Tensor:
        x = super().forward(x)
        bridge = center_crop(bridge, x.shape[-2], x.shape[-1])
        return self.block(torch.cat([x, bridge.to(x.dtype)], dim=1))


class UNet(nn.Module):
    """x: [B, in_channels, H, W] normalized input -> [B, n_classes, h, w]
    f32 logits (h = w = 324 for a 512 px input at depth 5)."""

    def __init__(self, n_classes: int = 9, in_channels: int = 3,
                 depth: int = 5, wf: int = 6, up_mode: str = "upsample",
                 dropout: float = 0.5,
                 norm: Callable[[int], nn.Module] = nn.BatchNorm2d,
                 act: Callable = F.relu):
        super().__init__()
        self.depth = depth
        prev = in_channels
        for i in range(depth):
            setattr(self, f"enc{i}", UNetConvBlock(prev, 2 ** (wf + i), norm,
                                                   act, dropout))
            prev = 2 ** (wf + i)
        for i, j in enumerate(reversed(range(depth - 1))):
            setattr(self, f"dec{i}", UNetUpBlock(prev, 2 ** (wf + j),
                                                 up_mode, norm, act,
                                                 dropout))
            prev = 2 ** (wf + j)
        self.head = nn.Conv2d(prev, n_classes, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return unet_forward(self, x)


def unet_forward(net: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """The encoder-decoder walk over ``net.enc{i}``, ``net.dec{i}`` and
    ``net.head``, which the ResUNet shares.  The head runs outside
    autocast, on the activations cast up to its weights' f32, as in
    flax."""
    blocks = []
    for i in range(net.depth):
        x = getattr(net, f"enc{i}")(x)
        if i != net.depth - 1:
            blocks.append(x)
            x = F.max_pool2d(x, 2)
    for i in range(net.depth - 1):
        x = getattr(net, f"dec{i}")(x, blocks[-i - 1])
    x = x.to(net.head.weight.dtype)
    if x.device.type not in ("cuda", "cpu"):  # no autocast there (meta)
        return net.head(x)
    with torch.autocast(x.device.type, enabled=False):
        return net.head(x)
