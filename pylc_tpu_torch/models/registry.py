"""Architecture dispatch.  Port of ``pylc_tpu/models/registry.py``."""

from __future__ import annotations

import torch.nn as nn

from pylc_tpu_torch.config import Config
from pylc_tpu_torch.models.deeplab import DeepLab
from pylc_tpu_torch.models.layers import get_activation, make_norm
from pylc_tpu_torch.models.res_unet import ResUNet
from pylc_tpu_torch.models.unet import UNet


def build_model(cfg: Config) -> nn.Module:
    """Instantiate the configured architecture (train/eval is the
    module's mode flag, not a build argument as in flax; torch modules
    take their input channels at construction, flax infers them).

    ``cfg.remat_backbone`` rematerializes a DeepLab's backbone blocks
    whenever the model trains (``models/deeplab.py``), as the JAX
    registry's ``remat=train and cfg.remat_backbone``; the U-Nets ignore
    it, as the JAX registry does."""
    act = get_activation(cfg.activ_type)
    norm = make_norm(cfg.norm_type)
    if cfg.arch == "unet":
        return UNet(n_classes=cfg.n_classes,
                    in_channels=model_input_channels(cfg),
                    depth=cfg.unet_depth, wf=cfg.unet_wf,
                    up_mode=cfg.up_mode, dropout=cfg.dropout, norm=norm,
                    act=act)
    if cfg.arch == "resunet":
        return ResUNet(n_classes=cfg.n_classes,
                       in_channels=model_input_channels(cfg),
                       depth=cfg.unet_depth, wf=cfg.unet_wf,
                       up_mode=cfg.up_mode, norm=norm, act=act)
    if cfg.arch == "deeplab":
        return DeepLab(n_classes=cfg.n_classes, backbone=cfg.backbone,
                       norm=norm, remat=bool(cfg.remat_backbone))
    raise ValueError(f"Model '{cfg.arch}' not available. "
                     f"Options: {cfg.arch_options}")


def model_input_channels(cfg: Config) -> int:
    """DeepLab always takes 3 channels (grayscale is stacked x3); the
    U-Nets take the raw channel count."""
    return 3 if cfg.arch == "deeplab" else cfg.ch
