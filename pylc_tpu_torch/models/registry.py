"""Architecture dispatch.  Port of ``pylc_tpu/models/registry.py``."""

from __future__ import annotations

import torch.nn as nn

from pylc_tpu_torch.config import Config
from pylc_tpu_torch.models.deeplab import DeepLab
from pylc_tpu_torch.models.layers import make_norm


def build_model(cfg: Config) -> nn.Module:
    """Instantiate the configured architecture (train/eval is the
    module's mode flag, not a build argument as in flax)."""
    if cfg.arch == "deeplab":
        return DeepLab(n_classes=cfg.n_classes, backbone=cfg.backbone,
                       norm=make_norm(cfg.norm_type))
    if cfg.arch in ("unet", "resunet"):
        raise NotImplementedError(
            f"'{cfg.arch}' is not ported yet (ROADMAP Queue 1 item 13)")
    raise ValueError(f"Model '{cfg.arch}' not available. "
                     f"Options: {cfg.arch_options}")
