"""DRN-D-54 (Dilated Residual Network) backbone for DeepLabV3+ (NCHW).

Port of ``pylc_tpu/models/drn.py``: the arch-D plan, layers
[1, 1, 3, 4, 6, 3, 1, 1], channels (16, 32, 64, 128, 256, 512, 512, 512):

  - layer0: 7x7 conv to 16, norm, ReLU (no initial downsample);
  - layer1, layer2: 3x3 conv-norm-ReLU stages (16; 32 at stride 2);
  - layer3..6: bottleneck stages (the ResNet ``Bottleneck``): planes 64 at
    stride 2, 128 at stride 2, 256 dilated by 2, 512 dilated by 4;
  - layer7, layer8: 3x3 conv stages, 512 dilated by 2 and 512.

Natively output stride 8.  Module names are the DRN checkpoints' own
(``layer0.0/.1``; a conv stage's conv j and norm j at ``layer{L}.{3j}`` and
``layer{L}.{3j + 1}``; ``layer{3..6}.{i}.conv1`` ...), so ``drn_d_54-*.pth``
loads into the backbone.  ``remat`` rematerializes every ``Bottleneck``
of layer3..6 in training (``models.layers.run_blocks``), as the JAX
package's ``nn.remat(Bottleneck)``; layer0 and the conv stages are not.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch
import torch.nn as nn

from pylc_tpu_torch.models.layers import run_blocks
from pylc_tpu_torch.models.resnet import Bottleneck


def conv_stage(inplanes: int, channels: int, n: int, stride: int,
               dilation: int, norm: Callable[[int], nn.Module]
               ) -> nn.Sequential:
    """n x (3x3 conv -> norm -> ReLU), the first conv strided."""
    layers = []
    for i in range(n):
        layers += [nn.Conv2d(inplanes, channels, 3,
                             stride=stride if i == 0 else 1,
                             padding=dilation, dilation=dilation,
                             bias=False),
                   norm(channels), nn.ReLU()]
        inplanes = channels
    return nn.Sequential(*layers)


def bottleneck_stage(inplanes: int, planes: int, blocks: int, stride: int,
                     dilation: int, norm: Callable[[int], nn.Module]
                     ) -> nn.Sequential:
    downsample = None
    if stride != 1 or inplanes != planes * 4:
        downsample = nn.Sequential(
            nn.Conv2d(inplanes, planes * 4, 1, stride=stride, bias=False),
            norm(planes * 4))
    layers = [Bottleneck(inplanes, planes, stride, dilation, downsample,
                         norm)]
    layers += [Bottleneck(planes * 4, planes, 1, dilation, None, norm)
               for _ in range(1, blocks)]
    return nn.Sequential(*layers)


class DRN54(nn.Module):
    """Returns (x [B, 512, H/8, W/8], low_level_feat [B, 256, H/4, W/4],
    taken after layer3)."""

    def __init__(self, norm: Callable[[int], nn.Module] = nn.BatchNorm2d,
                 remat: bool = False):
        super().__init__()
        self.remat = remat
        self.layer0 = nn.Sequential(
            nn.Conv2d(3, 16, 7, padding=3, bias=False), norm(16), nn.ReLU())
        self.layer1 = conv_stage(16, 16, 1, 1, 1, norm)
        self.layer2 = conv_stage(16, 32, 1, 2, 1, norm)
        self.layer3 = bottleneck_stage(32, 64, 3, 2, 1, norm)
        self.layer4 = bottleneck_stage(256, 128, 4, 2, 1, norm)
        self.layer5 = bottleneck_stage(512, 256, 6, 1, 2, norm)
        self.layer6 = bottleneck_stage(1024, 512, 3, 1, 4, norm)
        self.layer7 = conv_stage(2048, 512, 1, 1, 2, norm)
        self.layer8 = conv_stage(512, 512, 1, 1, 1, norm)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = self.layer2(self.layer1(self.layer0(x)))
        x = run_blocks(self.layer3, x, self.remat)
        low_level_feat = x
        for layer in (self.layer4, self.layer5, self.layer6):
            x = run_blocks(layer, x, self.remat)
        return self.layer8(self.layer7(x)), low_level_feat
