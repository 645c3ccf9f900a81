"""Multi-loss: weighted Cross-Entropy + soft Dice + Focal, in plain torch.

Port of ``pylc_tpu/ops/losses.py``.  One log-softmax is shared by all
three terms.  Logits are NCHW ``[B, C, H, W]`` here (the class axis is
dim 1, as for torch's ``CrossEntropyLoss``); the JAX version takes NHWC.

  CE     mean over pixels of -log p[y]; the class-weighted variant divides
         by the sum of per-pixel weights (torch CrossEntropyLoss semantics).
  Dice   per class 1 - (2 I + s) / (U + s), I and U summed over (B, H, W),
         mean over classes.
  Focal  -alpha (1 - p)^gamma log(p + eps) of the target class, mean over
         pixels.

Loss = ce_w * CE + dice_w * Dice + focal_w * Focal.  The eval step uses
this version; the train step takes the fused kernels
(``ops/kernels/fused_loss.py``), as in the JAX package.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch


class LossWeights(NamedTuple):
    ce: float = 0.5
    dice: float = 0.5
    focal: float = 0.5
    weighted: bool = False
    dice_smooth: float = 1.0
    fl_alpha: float = 0.25
    fl_gamma: float = 2.0
    eps: float = 1e-8


def loss_weights(cfg) -> LossWeights:
    """The loss weights a run's config asks for."""
    return LossWeights(ce=cfg.ce_weight, dice=cfg.dice_weight,
                       focal=cfg.focal_weight, weighted=cfg.weighted,
                       dice_smooth=cfg.dice_smooth, fl_alpha=cfg.fl_alpha,
                       fl_gamma=cfg.fl_gamma)


def one_hot(target: torch.Tensor, n_classes: int,
            dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """[B, H, W] integer class map -> [B, C, H, W]; a target outside
    [0, C) is an all-zero row (as ``jax.nn.one_hot``)."""
    classes = torch.arange(n_classes, device=target.device)
    return (target.long()[:, None] == classes[None, :, None, None]).to(dtype)


def multi_loss(logits: torch.Tensor, target: torch.Tensor,
               class_weights: Optional[torch.Tensor] = None,
               w: LossWeights = LossWeights(),
               sample_mask: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """CE + Dice + Focal of ``logits`` [B, C, H, W] against ``target``
    [B, H, W].

    ``class_weights`` [C] weight the CE when ``w.weighted``.
    ``sample_mask`` [B] of 0/1 drops samples from every reduction (equal,
    for [1]*n + [0]*pad, to the loss of the first n samples).

    Returns (total, {"ce", "dice", "focal"})."""
    C = logits.shape[1]
    logp = torch.log_softmax(logits, dim=1)
    p = torch.exp(logp)
    onehot = one_hot(target, C, logits.dtype)

    if sample_mask is not None:
        m = sample_mask.to(logits.dtype)[:, None, None]  # [B, 1, 1]
        n_px = m.sum() * (logits.shape[2] * logits.shape[3])
    else:
        m = n_px = None

    nll = -(onehot * logp).sum(dim=1)
    if w.weighted and class_weights is not None:
        cw = class_weights.to(logits.dtype).view(1, C, 1, 1)
        px_w = (onehot * cw).sum(dim=1)
        if m is not None:
            px_w = px_w * m
        ce = (nll * px_w).sum() / px_w.sum()
    elif m is not None:
        ce = (nll * m).sum() / n_px
    else:
        ce = nll.mean()

    p_d = p if m is None else p * m[:, None]
    oh_d = onehot if m is None else onehot * m[:, None]
    intersection = (p_d * oh_d).sum(dim=(0, 2, 3))
    cardinality = (p_d + oh_d).sum(dim=(0, 2, 3))
    dice = (1.0 - (2.0 * intersection + w.dice_smooth)
            / (cardinality + w.dice_smooth)).mean()

    p_eps = p + w.eps
    focal_map = -w.fl_alpha * torch.pow(1.0 - p_eps, w.fl_gamma) * \
        torch.log(p_eps)
    focal_px = (onehot * focal_map).sum(dim=1)
    focal = focal_px.mean() if m is None else (focal_px * m).sum() / n_px

    total = w.ce * ce + w.dice * dice + w.focal * focal
    return total, {"ce": ce, "dice": dice, "focal": focal}
