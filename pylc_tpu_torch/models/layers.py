"""Shared layers: normalizers, activations, align-corners resize,
center crop, max-pool, and the backbones' block rematerialization.

Port of ``pylc_tpu/models/layers.py``.  Modules here are NCHW (PyTorch's
habit; the serving path keeps them in ``channels_last`` memory).

``run_blocks`` is the counterpart of the JAX package's ``nn.remat`` over a
backbone's blocks: with ``remat`` on, in train mode and with gradients
enabled, each block runs under ``torch.utils.checkpoint`` (non-reentrant),
which keeps only the block's input and recomputes its activations in the
backward.  The recompute runs inside ``recompute_context``, where the
normalizers take the same batch statistics but leave their running ones
alone, so they move once per step, as flax's ``nn.remat`` keeps the first
forward's ``batch_stats``.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager, nullcontext
from functools import partial
from typing import Callable, Iterable

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

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


_RECOMPUTE = threading.local()


def recomputing() -> bool:
    """Whether this thread is inside the backward's recompute of a
    rematerialized block."""
    return getattr(_RECOMPUTE, "on", False)


@contextmanager
def recompute_context():
    """Around the recompute of a checkpointed block (the autograd thread
    that runs the backward enters it)."""
    before = recomputing()
    _RECOMPUTE.on = True
    try:
        yield
    finally:
        _RECOMPUTE.on = before


def _remat_contexts():
    return nullcontext(), recompute_context()


def run_blocks(blocks: Iterable[nn.Module], x: torch.Tensor, remat: bool
               ) -> torch.Tensor:
    """``x`` through ``blocks`` in order, each rematerialized when
    ``remat`` is on, the block is in train mode and gradients are
    enabled; otherwise a plain call (eval and inference are untouched).
    The random generators are not saved for the recompute: no backbone
    block draws a random number (the DeepLab's dropout lies in its
    decoder), and saving and restoring the CPU's and the card's
    generators around every block costs host time in every step."""
    for block in blocks:
        if remat and block.training and torch.is_grad_enabled():
            x = checkpoint(block, x, use_reentrant=False,
                           preserve_rng_state=False,
                           context_fn=_remat_contexts)
        else:
            x = block(x)
    return x


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose train mode follows flax ``BatchNorm``.

    It normalizes with the biased batch statistics, as torch does, but
    moves ``running_var`` toward the biased batch variance, as flax does
    (torch uses the unbiased one: n/(n-1) larger, 8/7 for the ASPP
    image-pool BN at batch 8, whose n is the batch size).  With one value
    per channel it returns the bias, as flax does, instead of raising.
    Eval mode and the state_dict keys are torch's own.  Inside
    ``recompute_context`` it normalizes as in train mode and moves no
    running statistic."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        n = x.numel() // x.shape[1]
        m = self.momentum
        if n == 1:
            # batch variance 0 and x - mean = 0: the output is the bias,
            # and x keeps a (zero) gradient, as in flax
            if not recomputing():
                with torch.no_grad():
                    self.running_mean.mul_(1 - m).add_(
                        x.detach().reshape(-1).float(), alpha=m)
                    self.running_var.mul_(1 - m)
                    self.num_batches_tracked.add_(1)
            c = (1, -1, 1, 1)
            return ((x - x) * self.weight.view(c)
                    + self.bias.view(c)).to(x.dtype)
        if recomputing():
            # the first forward's call, on copies of the running
            # statistics: the same kernel, the buffers left as they are
            return F.batch_norm(x, self.running_mean.clone(),
                                self.running_var.clone(), self.weight,
                                self.bias, True, m, self.eps)
        old_var = self.running_var.clone()
        y = super().forward(x)
        # torch set running_var = (1-m) old + m var * n/(n-1); rescale the
        # batch part by (n-1)/n: (1-m) old + m var.  Through .data: the
        # batch_norm node holds running_var (unused by its backward in
        # train mode), and autograd would refuse a visible in-place change
        self.running_var.data.mul_((n - 1) / n).add_(old_var,
                                                     alpha=(1 - m) / n)
        return y


class InstanceNorm2d(nn.GroupNorm):
    """Per sample and per channel over H x W, with a scale and a bias per
    channel: flax ``GroupNorm(num_groups=None, group_size=1)``, eps 1e-5.

    With one value per channel (the ASPP image-pool branch) the variance
    is 0 and x - mean is 0, so the output is the bias, as in flax;
    ``nn.InstanceNorm2d`` raises there in train mode.  No running
    statistics: train and eval modes compute the same."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__(num_features, num_features, eps=eps, affine=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[2] * x.shape[3] == 1:
            c = (1, -1, 1, 1)
            return ((x - x) * self.weight.view(c)
                    + self.bias.view(c)).to(x.dtype)
        return super().forward(x)


class ChannelLayerNorm(nn.LayerNorm):
    """Over the channels of each pixel of [N, C, H, W], with a [C] scale
    and bias: flax ``LayerNorm`` on NHWC normalizes the last axis, which
    ``nn.LayerNorm`` on NCHW does not.  The NHWC view of a
    ``channels_last`` tensor is contiguous, so neither permute copies
    there."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__(num_features, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


def make_norm(norm_type: str) -> Callable[[int], nn.Module]:
    """Normalizer constructor (channels -> module), eps 1e-5 throughout.

    ``batch``: ``BatchNorm2d`` above, running-stat momentum 0.1 (flax
    momentum 0.9).  When the process group holds more than one rank,
    ``batch`` and ``syncbatch`` both take the global batch's statistics
    (``parallel/syncbn.SyncBatchNorm2d``), as the JAX package's BatchNorm
    does over a batch sharded across chips; with one rank ``syncbatch``
    is ``batch``.  ``instance`` and ``layer``: the two classes above,
    which keep no running statistics."""
    if norm_type in ("batch", "syncbatch"):
        from pylc_tpu_torch.parallel.mesh import world_size
        if world_size() > 1:
            from pylc_tpu_torch.parallel.syncbn import SyncBatchNorm2d
            return partial(SyncBatchNorm2d, eps=1e-5, momentum=0.1)
        return partial(BatchNorm2d, eps=1e-5, momentum=0.1)
    if norm_type == "instance":
        return partial(InstanceNorm2d, eps=1e-5)
    if norm_type == "layer":
        return partial(ChannelLayerNorm, eps=1e-5)
    raise ValueError(f"Unknown normalizer '{norm_type}'.")


def resize_bilinear_align_corners(x: torch.Tensor, out_h: int, out_w: int
                                  ) -> torch.Tensor:
    """Bilinear resize of [N, C, H, W] with align_corners=True (source
    coordinate = i * (in - 1) / (out - 1)), computed in f32 and returned
    in the input's dtype, as the JAX version does."""
    y = F.interpolate(x.float(), size=(out_h, out_w), mode="bilinear",
                      align_corners=True)
    return y.to(x.dtype)


def center_crop(x: torch.Tensor, target_h: int, target_w: int
                ) -> torch.Tensor:
    """Center-crop the spatial dims of [..., H, W] (a view)."""
    h, w = x.shape[-2:]
    dy = (h - target_h) // 2
    dx = (w - target_w) // 2
    return x[..., dy:dy + target_h, dx:dx + target_w]


def max_pool_3x3_s2_p1(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, kernel_size=3, stride=2, padding=1)
