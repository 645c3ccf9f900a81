"""Shared layers: normalizer, activations, align-corners resize, max-pool.

Port of ``pylc_tpu/models/layers.py``.  Modules here are NCHW (PyTorch's
habit; the serving path keeps them in ``channels_last`` memory).
"""

from __future__ import annotations

from functools import partial
from typing import Callable

import torch
import torch.nn as nn
import torch.nn.functional as F

# flax's gelu defaults to the tanh approximation
ACTIVATIONS = {
    "relu": F.relu,
    "lrelu": partial(F.leaky_relu, negative_slope=0.01),
    "selu": F.selu,
    "gelu": partial(F.gelu, approximate="tanh"),
}


def get_activation(name: str) -> Callable:
    if name not in ACTIVATIONS:
        raise ValueError(f"Unknown activation '{name}'. "
                         f"Options: {sorted(ACTIVATIONS)}")
    return ACTIVATIONS[name]


def make_norm(norm_type: str) -> Callable[[int], nn.Module]:
    """Normalizer constructor (channels -> module).

    BatchNorm with torch's eps 1e-5 and running-stat momentum 0.1 (flax
    momentum 0.9).  ``syncbatch`` is plain BatchNorm on one device."""
    if norm_type in ("batch", "syncbatch"):
        return partial(nn.BatchNorm2d, eps=1e-5, momentum=0.1)
    raise NotImplementedError(
        f"normalizer '{norm_type}' is not ported yet (ROADMAP Queue 1 "
        "item 2: instance and layer norms, with the U-Nets of item 13)")


def resize_bilinear_align_corners(x: torch.Tensor, out_h: int, out_w: int
                                  ) -> torch.Tensor:
    """Bilinear resize of [N, C, H, W] with align_corners=True (source
    coordinate = i * (in - 1) / (out - 1)), computed in f32 and returned
    in the input's dtype, as the JAX version does."""
    y = F.interpolate(x.float(), size=(out_h, out_w), mode="bilinear",
                      align_corners=True)
    return y.to(x.dtype)


def max_pool_3x3_s2_p1(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, kernel_size=3, stride=2, padding=1)
