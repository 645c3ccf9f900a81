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


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose train mode follows flax ``BatchNorm``.

    It normalizes with the biased batch statistics, as torch does, but
    moves ``running_var`` toward the biased batch variance, as flax does
    (torch uses the unbiased one: n/(n-1) larger, 8/7 for the ASPP
    image-pool BN at batch 8, whose n is the batch size).  With one value
    per channel it returns the bias, as flax does, instead of raising.
    Eval mode and the state_dict keys are torch's own."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        n = x.numel() // x.shape[1]
        m = self.momentum
        if n == 1:
            # batch variance 0 and x - mean = 0: the output is the bias,
            # and x keeps a (zero) gradient, as in flax
            with torch.no_grad():
                self.running_mean.mul_(1 - m).add_(
                    x.detach().reshape(-1).float(), alpha=m)
                self.running_var.mul_(1 - m)
                self.num_batches_tracked.add_(1)
            c = (1, -1, 1, 1)
            return ((x - x) * self.weight.view(c)
                    + self.bias.view(c)).to(x.dtype)
        old_var = self.running_var.clone()
        y = super().forward(x)
        # torch set running_var = (1-m) old + m var * n/(n-1); rescale the
        # batch part by (n-1)/n: (1-m) old + m var.  Through .data: the
        # batch_norm node holds running_var (unused by its backward in
        # train mode), and autograd would refuse a visible in-place change
        self.running_var.data.mul_((n - 1) / n).add_(old_var,
                                                     alpha=(1 - m) / n)
        return y


def make_norm(norm_type: str) -> Callable[[int], nn.Module]:
    """Normalizer constructor (channels -> module).

    ``BatchNorm2d`` above, with torch's eps 1e-5 and running-stat momentum
    0.1 (flax momentum 0.9).  ``syncbatch`` is plain BatchNorm on one
    device."""
    if norm_type in ("batch", "syncbatch"):
        return partial(BatchNorm2d, eps=1e-5, momentum=0.1)
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
