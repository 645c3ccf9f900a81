"""Batch preparation, the train and eval steps, optimizers, LR schedules
and the inference forward.

Port of ``pylc_tpu/train_state.py``.  JAX traces one program per step;
here the step is eager PyTorch on the model's device:

  - ``make_lr_schedule``: ``step_lr`` (lr * gamma^epoch), ``cyclic_lr``
    (triangular lr_min -> lr_max, 2000 steps up) and ``anneal``
    (constant), as functions of the step count;
  - ``make_optimizer``: AdamW (decoupled weight decay on every parameter,
    as optax) or SGD with momentum, optionally with the backbone and the
    head in two parameter groups, under a ``LambdaLR`` that gives step k
    the schedule's value at k, as optax's count does;
  - ``make_train_step``: flip, normalize, forward (bf16 autocast when
    ``compute_dtype == "bfloat16"``), the fused multi-loss on kernels
    K2a/K2b (or the plain ``multi_loss`` for ``fused_loss`` "off"),
    backward, the global-norm clip, the optimizer update;
  - ``make_eval_step`` and ``make_predict``: eval-mode forwards.

Metrics come back as 0-d device tensors: nothing in a step waits for the
device.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn as nn

from pylc_tpu_torch.config import Config
from pylc_tpu_torch.models.registry import build_model
from pylc_tpu_torch.ops.kernels.fused_loss import fused_multi_loss
from pylc_tpu_torch.ops.losses import loss_weights, multi_loss
from pylc_tpu_torch.ops.normalize import normalize_image

Metrics = Dict[str, torch.Tensor]


def init_model(cfg: Config, seed: int = 0) -> nn.Module:
    """The configured model on the CPU (its input channels those of
    ``model_input_channels``), with He-normal conv and transposed-conv
    weights (fan-in) drawn from a ``torch.Generator`` seeded with
    ``seed``, zero conv biases, and the normalizers as identity."""
    model = build_model(cfg)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                # fan-in: inputs per output value.  A transposed conv's
                # weight is [in, out / groups, kH, kW], and at stride =
                # kernel each output pixel sums over the inputs only
                fan_in = m.in_channels if isinstance(
                    m, nn.ConvTranspose2d) else m.weight[0].numel()
                m.weight.copy_(torch.randn(m.weight.shape, generator=gen)
                               * (2.0 / fan_in) ** 0.5)
                if m.bias is not None:
                    m.bias.zero_()
    return model


def prepare_batch(cfg: Config, img: torch.Tensor,
                  mask: Optional[torch.Tensor] = None, flip: bool = False
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """uint8 [B, H, W, C] -> normalized f32 [B, H, W, C'] (grayscale
    stacked to three channels for DeepLab), and the mask, which the
    U-Nets get cropped to ``cfg.crop_window``, the window their unpadded
    convs leave (a contiguous copy: kernels K2a/K2b take no strided
    target).  ``flip`` mirrors the whole batch and its mask along the
    width, as the reference flips dim 3 of NCHW."""
    x = img
    if flip:
        x = x.flip(2)
        if mask is not None:
            mask = mask.flip(2)
    x = normalize_image(x, cfg.px_mean or cfg.px_rgb_mean,
                        cfg.px_std or cfg.px_rgb_std, cfg.ch,
                        default=cfg.normalize_default)
    if cfg.ch == 1 and cfg.arch == "deeplab":
        x = torch.cat([x, x, x], dim=-1)
    if mask is not None and cfg.arch in ("unet", "resunet"):
        lo, hi = cfg.crop_window
        mask = mask[:, lo:hi, lo:hi].contiguous()
    return x, mask


def _set_tf32(cfg: Config) -> bool:
    """TF32 on for bf16 runs, off for true f32; returns whether bf16."""
    bf16 = cfg.compute_dtype == "bfloat16"
    torch.backends.cudnn.allow_tf32 = bf16
    torch.backends.cuda.matmul.allow_tf32 = bf16
    return bf16


def _class_weights(cfg: Config, device: torch.device
                   ) -> Optional[torch.Tensor]:
    if cfg.weights is None:
        return None
    return torch.tensor(cfg.weights, dtype=torch.float32, device=device)


def _device(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


# --------------------------------------------------------------------- #
# schedules and optimizers
# --------------------------------------------------------------------- #

def make_lr_schedule(cfg: Config, steps_per_epoch: int
                     ) -> Callable[[int], float]:
    """The learning rate of step k (0-based)."""
    base = cfg.lr
    if cfg.sched_type == "step_lr":
        spe = max(1, steps_per_epoch)
        return lambda k: base * cfg.gamma ** (k // spe)
    if cfg.sched_type == "cyclic_lr":
        up = 2000.0

        def cyclic(k: int) -> float:
            cycle = (1 + k / (2 * up)) // 1
            x = abs(k / up - 2 * cycle + 1)
            return cfg.lr_min + (cfg.lr_max - cfg.lr_min) * max(0.0, 1.0 - x)
        return cyclic
    if cfg.sched_type == "anneal":
        return lambda k: base
    raise ValueError(f"Scheduler '{cfg.sched_type}' is not defined.")


def make_optimizer(cfg: Config, model: nn.Module, steps_per_epoch: int
                   ) -> Tuple[torch.optim.Optimizer,
                              torch.optim.lr_scheduler.LambdaLR]:
    """(optimizer, scheduler).  Each parameter group's ``lr`` is its
    multiplier (1, or ``head_lr_mult`` for everything outside
    ``backbone.*``: the whole of a model without a backbone, as the
    U-Nets), which the ``LambdaLR`` scales by the schedule; step the
    scheduler once after each optimizer step."""
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    if cfg.head_lr_mult != 1.0:
        groups = [
            {"params": [p for n, p in named if n.startswith("backbone.")],
             "lr": 1.0},
            {"params": [p for n, p in named
                        if not n.startswith("backbone.")],
             "lr": cfg.head_lr_mult},
        ]
        groups = [g for g in groups if g["params"]]
    else:
        groups = [{"params": [p for _, p in named], "lr": 1.0}]
    if cfg.optim_type == "adam":
        opt = torch.optim.AdamW(groups, lr=1.0,
                                weight_decay=cfg.weight_decay)
    elif cfg.optim_type == "sgd":
        opt = torch.optim.SGD(groups, lr=1.0, momentum=cfg.momentum)
    else:
        raise ValueError(f"Optimizer '{cfg.optim_type}' is not defined.")
    sched = make_lr_schedule(cfg, steps_per_epoch)
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, sched)


def clip_by_global_norm_(params: List[torch.Tensor], max_norm: float
                         ) -> torch.Tensor:
    """optax's ``clip_by_global_norm`` in place on the gradients: g if
    ||g|| < max_norm, else g * max_norm / ||g|| (no epsilon, unlike
    ``clip_grad_norm_``).  Returns ||g|| as a device tensor."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.nn.utils.get_total_norm(grads)
    scale = torch.where(norm < max_norm, torch.ones_like(norm),
                        max_norm / norm)
    torch._foreach_mul_(grads, scale)
    return norm


# --------------------------------------------------------------------- #
# steps
# --------------------------------------------------------------------- #

def make_train_step(cfg: Config, model: nn.Module,
                    optimizer: torch.optim.Optimizer,
                    scheduler: torch.optim.lr_scheduler.LRScheduler
                    ) -> Callable[..., Metrics]:
    """The train step: ``step(img_u8, mask_u8, generator=None, flip=None)``
    -> metrics {ce, dice, focal, total} as 0-d device tensors.

    ``img_u8`` [B, C, H, W] and ``mask_u8`` [B, H, W] are DB tiles on the
    model's device.  ``fused_loss`` "auto" and "on" take
    ``fused_multi_loss`` (kernels K2a/K2b for CUDA tensors, their plain
    versions for CPU tensors; the kernels take at most 16 classes); "off"
    takes the plain ``multi_loss`` on either device, as in the JAX package.
    The batch flip is drawn from ``generator`` (a CPU ``torch.Generator``,
    so the draw needs no device sync); ``flip=`` overrides the draw.
    Dropout draws from the device's default generator."""
    if cfg.remat_backbone:
        raise NotImplementedError(
            "remat_backbone (activation checkpointing of the backbone) is "
            "not ported: ROADMAP Queue 1 item 11")
    if cfg.fused_loss not in ("auto", "on", "off"):
        raise ValueError(f"fused_loss={cfg.fused_loss!r}: 'auto', 'on' or "
                         "'off'")

    def plain_loss(logits, y, cw, lw):
        return multi_loss(logits.float(), y, class_weights=cw, w=lw)
    loss_fn = plain_loss if cfg.fused_loss == "off" else fused_multi_loss
    bf16 = _set_tf32(cfg)
    device = _device(model)
    lw = loss_weights(cfg)
    cw = _class_weights(cfg, device)
    params = [p for p in model.parameters() if p.requires_grad]
    model.to(memory_format=torch.channels_last)

    def step(img: torch.Tensor, mask: torch.Tensor,
             generator: Optional[torch.Generator] = None,
             flip: Optional[bool] = None) -> Metrics:
        if flip is None:
            flip = bool(torch.rand((), generator=generator) < 0.5)
        model.train()
        x, y = prepare_batch(cfg, img.permute(0, 2, 3, 1), mask, flip)
        with torch.autocast(device.type, dtype=torch.bfloat16, enabled=bf16):
            logits = model(x.permute(0, 3, 1, 2))
        total, aux = loss_fn(logits, y, cw, lw)
        optimizer.zero_grad(set_to_none=True)
        total.backward()
        clip_by_global_norm_(params, cfg.grad_clip)
        optimizer.step()
        scheduler.step()
        metrics = {k: v.detach() for k, v in aux.items()}
        metrics["total"] = total.detach()
        return metrics

    return step


def make_eval_step(cfg: Config, model: nn.Module
                   ) -> Callable[[torch.Tensor, torch.Tensor], Metrics]:
    """The validation step: ``step(img_u8, mask_u8)`` on DB tiles ([B, C,
    H, W] and [B, H, W]) -> metrics {ce, dice, focal, total, n_valid} as
    0-d device tensors, by the plain ``multi_loss``.  Batches are not
    padded (nothing is compiled for a shape), so ``n_valid`` is the batch
    size, the weight a partial batch carries in the validation average."""
    bf16 = _set_tf32(cfg)
    device = _device(model)
    lw = loss_weights(cfg)
    cw = _class_weights(cfg, device)

    def step(img: torch.Tensor, mask: torch.Tensor) -> Metrics:
        model.eval()
        x, y = prepare_batch(cfg, img.permute(0, 2, 3, 1), mask)
        with torch.no_grad():
            with torch.autocast(device.type, dtype=torch.bfloat16,
                                enabled=bf16):
                logits = model(x.permute(0, 3, 1, 2))
            total, aux = multi_loss(logits.float(), y, class_weights=cw,
                                    w=lw)
        metrics = dict(aux, total=total)
        metrics["n_valid"] = torch.tensor(float(img.shape[0]),
                                          device=device)
        return metrics

    return step


def make_predict(cfg: Config, model: nn.Module
                 ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Eval-mode forward: uint8 [B, H, W, C] on the model's device ->
    f32 logits [B, H, W, K].

    ``compute_dtype == "bfloat16"`` runs the network under bf16 autocast
    (BatchNorm stays f32 there, unlike the JAX model); anything else runs
    in true f32, with TF32 off for cuDNN convolutions and cuBLAS matmuls.
    The NHWC batch enters as a ``channels_last`` NCHW view and the logits
    leave as an NHWC view, so neither permute copies."""
    bf16 = _set_tf32(cfg)
    model.eval().to(memory_format=torch.channels_last)

    def predict(img: torch.Tensor) -> torch.Tensor:
        x = prepare_batch(cfg, img)[0].permute(0, 3, 1, 2)
        with torch.inference_mode(), torch.autocast(
                img.device.type, dtype=torch.bfloat16, enabled=bf16):
            logits = model(x)
        return logits.float().permute(0, 2, 3, 1)

    return predict
