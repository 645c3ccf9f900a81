"""Batch preparation and the inference forward.

Port of the inference half of ``pylc_tpu/train_state.py``
(``_prepare_batch`` and ``make_predict``); training is a later slice.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn as nn

from pylc_tpu_torch.config import Config
from pylc_tpu_torch.ops.normalize import normalize_image


def prepare_batch(cfg: Config, img: torch.Tensor) -> torch.Tensor:
    """uint8 [B, H, W, C] -> normalized f32 [B, H, W, C'] (grayscale is
    stacked to three channels for DeepLab)."""
    x = normalize_image(img, cfg.px_mean or cfg.px_rgb_mean,
                        cfg.px_std or cfg.px_rgb_std, cfg.ch,
                        default=cfg.normalize_default)
    if cfg.ch == 1 and cfg.arch == "deeplab":
        x = torch.cat([x, x, x], dim=-1)
    return x


def make_predict(cfg: Config, model: nn.Module
                 ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Eval-mode forward: uint8 [B, H, W, C] on the model's device ->
    f32 logits [B, H, W, K].

    ``compute_dtype == "bfloat16"`` runs the network under bf16 autocast
    (BatchNorm stays f32 there, unlike the JAX model); anything else runs
    in true f32, with TF32 off for cuDNN convolutions and cuBLAS matmuls.
    The NHWC batch enters as a ``channels_last`` NCHW view and the logits
    leave as an NHWC view, so neither permute copies."""
    bf16 = cfg.compute_dtype == "bfloat16"
    torch.backends.cudnn.allow_tf32 = bf16
    torch.backends.cuda.matmul.allow_tf32 = bf16
    model.eval().to(memory_format=torch.channels_last)

    def predict(img: torch.Tensor) -> torch.Tensor:
        x = prepare_batch(cfg, img).permute(0, 3, 1, 2)
        with torch.inference_mode(), torch.autocast(
                img.device.type, dtype=torch.bfloat16, enabled=bf16):
            logits = model(x)
        return logits.float().permute(0, 2, 3, 1)

    return predict
