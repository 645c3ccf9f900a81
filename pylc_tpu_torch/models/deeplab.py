"""DeepLabV3+: backbone -> ASPP -> decoder -> align-corners upsample.

Port of ``pylc_tpu/models/deeplab.py``, with the reference checkpoints'
module names (``decoder.last_conv.8`` is the head).  The backbone is
ResNet101, Aligned Xception, MobileNetV2 or DRN-D-54.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from pylc_tpu_torch.models.aspp import ASPP
from pylc_tpu_torch.models.layers import resize_bilinear_align_corners
from pylc_tpu_torch.models.drn import DRN54
from pylc_tpu_torch.models.mobilenet import MobileNetV2
from pylc_tpu_torch.models.resnet import ResNet101
from pylc_tpu_torch.models.xception import AlignedXception

# backbone -> (channels into the ASPP, channels of the low-level feature)
BACKBONE_CHANNELS = {"resnet": (2048, 256), "xception": (2048, 128),
                     "mobilenet": (320, 24), "drn": (512, 256)}


class DeepLabDecoder(nn.Module):
    def __init__(self, n_classes: int,
                 norm: Callable[[int], nn.Module] = nn.BatchNorm2d,
                 low_level_inplanes: int = 256):
        super().__init__()
        self.conv1 = nn.Conv2d(low_level_inplanes, 48, 1, bias=False)
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
    """x: [B, 3, H, W] normalized input -> [B, n_classes, H, W] f32 logits.
    ``layers`` is the ResNet's block counts."""

    def __init__(self, n_classes: int = 9, backbone: str = "resnet",
                 norm: Callable[[int], nn.Module] = nn.BatchNorm2d,
                 layers: Sequence[int] = (3, 4, 23, 3)):
        super().__init__()
        output_stride = 16
        if backbone == "resnet":
            self.backbone = ResNet101(norm, layers=layers)
        elif backbone == "xception":
            self.backbone = AlignedXception(norm)
        elif backbone == "mobilenet":
            self.backbone = MobileNetV2(norm, output_stride)
        elif backbone == "drn":
            output_stride = 8  # DRN is natively output stride 8
            self.backbone = DRN54(norm)
        else:
            raise ValueError(f"Unknown backbone '{backbone}'")
        inplanes, low_level_inplanes = BACKBONE_CHANNELS[backbone]
        self.aspp = ASPP(norm, inplanes, output_stride)
        self.decoder = DeepLabDecoder(n_classes, norm, low_level_inplanes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        H, W = x.shape[-2:]
        feat, ll = self.backbone(x)
        y = self.decoder(self.aspp(feat), ll)
        return resize_bilinear_align_corners(y, H, W).float()
