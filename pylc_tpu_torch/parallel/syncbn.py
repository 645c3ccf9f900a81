"""BatchNorm over the global batch of every rank.

Port of ``pylc_tpu/parallel/syncbn.py``.  The reference carried
(sum, sum of squares, count) between replicas through Python thread
pipes; the JAX package psums the same triple.  Here it is one
differentiable all-reduce (``parallel.mesh.all_reduce_sum``), whose
backward sums the ranks' gradients of the moments, so every rank's
gradient is that of the global batch's normalization.

Not ``nn.SyncBatchNorm``: it refuses CPU tensors, so it cannot run
under gloo on the CPU, and it moves the running variance toward the
unbiased variance, where the port follows flax's biased one
(``models/layers.BatchNorm2d``).  The variance is E[x^2] - E[x]^2 over
the global batch, flax's one-pass form.
"""

from __future__ import annotations

from typing import Tuple

import torch

from pylc_tpu_torch.models.layers import BatchNorm2d, recomputing
from pylc_tpu_torch.parallel.mesh import all_reduce_sum, world_size


def cross_replica_moments(x: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-channel (mean, biased variance, count) of an NCHW batch over
    every rank's batch, in f32; without a process group, this rank's."""
    xf = x.float()
    C = x.shape[1]
    n_local = torch.full((1,), float(x.numel() // C), device=x.device)
    stats = torch.cat([xf.sum(dim=(0, 2, 3)), (xf * xf).sum(dim=(0, 2, 3)),
                       n_local])
    if world_size() > 1:
        stats = all_reduce_sum(stats)
    n = stats[2 * C]
    mean = stats[:C] / n
    var = stats[C:2 * C] / n - mean * mean
    return mean, var, n.detach()


def _normalize(x, mean, var, weight, bias, eps):
    c = (1, -1, 1, 1)
    y = (x.float() - mean.view(c)) * torch.rsqrt(var + eps).view(c)
    return (y * weight.view(c) + bias.view(c)).to(x.dtype)


def sync_batch_norm_apply(x: torch.Tensor, weight: torch.Tensor,
                          bias: torch.Tensor, eps: float = 1e-5
                          ) -> torch.Tensor:
    """Train-mode BatchNorm of NCHW ``x`` with the global moments."""
    mean, var, _ = cross_replica_moments(x)
    return _normalize(x, mean, var, weight, bias, eps)


class SyncBatchNorm2d(BatchNorm2d):
    """``BatchNorm2d`` whose train mode takes the moments of the global
    batch when the process group holds more than one rank, and moves the
    running mean and variance toward them (the biased variance over the
    global count, as flax would over the sharded batch).  With one rank,
    and in eval mode, it is ``BatchNorm2d``; its state_dict keys are the
    same.  In the backward's recompute of a rematerialized block
    (``models.layers.recompute_context``) every rank all-reduces the
    moments again, in the same order, and no running statistic moves."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or world_size() == 1:
            return super().forward(x)
        mean, var, _ = cross_replica_moments(x)
        m = self.momentum
        if not recomputing():
            with torch.no_grad():
                self.running_mean.mul_(1 - m).add_(mean.detach(), alpha=m)
                self.running_var.mul_(1 - m).add_(var.detach(), alpha=m)
                self.num_batches_tracked.add_(1)
        return _normalize(x, mean, var, self.weight, self.bias, self.eps)
