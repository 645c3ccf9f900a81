"""DeepLabV3+: backbone -> ASPP -> decoder -> align-corners upsample.

Port of ``pylc_tpu/models/deeplab.py`` (ResNet101 backbone only), with
the reference checkpoints' module names (``decoder.last_conv.8`` is the
head).
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from pylc_tpu_torch.models.aspp import ASPP
from pylc_tpu_torch.models.layers import resize_bilinear_align_corners
from pylc_tpu_torch.models.resnet import ResNet101


class DeepLabDecoder(nn.Module):
    def __init__(self, n_classes: int,
                 norm: Callable[[int], nn.Module] = nn.BatchNorm2d):
        super().__init__()
        self.conv1 = nn.Conv2d(256, 48, 1, bias=False)  # ResNet layer1
        self.bn1 = norm(48)
        self.last_conv = nn.Sequential(
            nn.Conv2d(304, 256, 3, padding=1, bias=False),
            norm(256),
            nn.ReLU(),
            nn.Dropout(0.5),
            nn.Conv2d(256, 256, 3, padding=1, bias=False),
            norm(256),
            nn.ReLU(),
            nn.Dropout(0.1),
            nn.Conv2d(256, n_classes, 1))

    def forward(self, x: torch.Tensor, low_level_feat: torch.Tensor
                ) -> torch.Tensor:
        ll = F.relu(self.bn1(self.conv1(low_level_feat)))
        x = resize_bilinear_align_corners(x, ll.shape[-2], ll.shape[-1])
        return self.last_conv(torch.cat([x, ll], dim=1))


class DeepLab(nn.Module):
    """x: [B, 3, H, W] normalized input -> [B, n_classes, H, W] f32 logits."""

    def __init__(self, n_classes: int = 9, backbone: str = "resnet",
                 norm: Callable[[int], nn.Module] = nn.BatchNorm2d,
                 layers: Sequence[int] = (3, 4, 23, 3)):
        super().__init__()
        if backbone != "resnet":
            raise NotImplementedError(
                f"backbone '{backbone}' is not ported yet (ROADMAP Queue 1 "
                "item 13: Xception, MobileNetV2 and DRN)")
        self.backbone = ResNet101(norm, layers=layers)
        self.aspp = ASPP(norm)
        self.decoder = DeepLabDecoder(n_classes, norm)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        H, W = x.shape[-2:]
        feat, ll = self.backbone(x)
        y = self.decoder(self.aspp(feat), ll)
        return resize_bilinear_align_corners(y, H, W).float()
