"""Fused CE + Dice + Focal multi-loss: CUDA kernels K2a and K2b, their
plain forms, and the autograd function over them.

Port of the TPU kernels of ``pylc_tpu/ops/pallas/fused_loss.py``:
``fused_loss_forward`` (K2a) replaces ``_fwd_kernel``, a streaming pass
that reduces the logits to the 3C + 4 statistics all three losses need;
``fused_loss_backward`` (K2b) replaces ``_bwd_kernel``, the analytic
gradient per pixel from those statistics.  The kernels are
``pylc_tpu_torch/csrc/fused_loss.cu`` (its header gives the math, the
bounds and the design), built by ``_build`` and called through ``ctypes``
on PyTorch's current stream.  K2a has one kernel for every accepted
layout, with the class count at compile time for 9 and 11 classes
(``forward_variant``).  K2b has two kernels, and ``backward_variant`` says
which one a logits tensor gets: one that stages a block's span through
shared memory, for dense ``channels_last`` logits with 9 or 11 classes,
and a direct one for every other accepted layout.

Logits are ``[B, C, H, W]`` f32, either contiguous NCHW or
``channels_last`` (the train step hands over the latter); targets are
``[B, H, W]`` uint8.  The statistics vector ``acc`` is
``[inter (C), sump (C), cnt (C), nll_sum, wsum, focal_sum, count]``.

Each wrapper takes the plain torch version for tensors on the CPU and
launches its kernel for CUDA tensors; there is no other choice between
the two.  ``fused_loss_forward.launches`` and
``fused_loss_backward.launches`` count kernel launches (K2a's partial sums
and its final sum count as one launch).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from pylc_tpu_torch.ops.kernels import _build
from pylc_tpu_torch.ops.losses import LossWeights, one_hot

SOURCE = _build.source_path("fused_loss")
# the bound compiled into the kernels (kMaxC in the source); the Pallas
# kernel takes up to 128 classes
MAX_CLASSES = 16
# class counts with compile-time instantiations of K2a and K2b (both
# schemas')
KNOWN_CLASSES = (9, 11)
# the direct kernels put the image index into the grid's y dimension
MAX_BATCH = 65535


def build(force: bool = False):
    """Compile the kernel library if it is missing or older than its
    source.  Returns (library path, nvcc's ``-Xptxas -v`` report; empty
    when nothing was built)."""
    return _build.build("fused_loss", force)


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = _build.load("fused_loss")
    vp, ci, cf, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
        ctypes.c_longlong
    lib.fused_loss_workspace.argtypes = [cl, cl, ci]
    lib.fused_loss_workspace.restype = cl
    lib.fused_loss_max_classes.argtypes = []
    lib.fused_loss_max_classes.restype = ci
    lib.fused_loss_forward_f32.argtypes = [vp, vp, vp, vp, vp, ci, cl, cl,
                                           cl, cl, cl, ci, cf, cf, cf, vp]
    lib.fused_loss_forward_f32.restype = ci
    lib.fused_loss_forward_variant.argtypes = [ci]
    lib.fused_loss_forward_variant.restype = ci
    lib.fused_loss_backward_f32.argtypes = [vp, vp, vp, vp, vp, vp, ci, cl,
                                            cl, cl, cl, cl, ci, cf, cf, cf,
                                            cf, cf, cf, cf, ci, vp]
    lib.fused_loss_backward_f32.restype = ci
    lib.fused_loss_backward_variant.argtypes = [vp, vp, ci, cl, cl, cl, cl]
    lib.fused_loss_backward_variant.restype = ci
    if lib.fused_loss_max_classes() != MAX_CLASSES:
        raise RuntimeError("fused_loss.cu's kMaxC disagrees with "
                           "MAX_CLASSES")
    return lib


# --------------------------------------------------------------------- #
# plain versions
# --------------------------------------------------------------------- #

def _softmax(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(p, log p) over dim 1, in the kernels' form: p = e / sum e and
    log p = (x - max) - log(sum e)."""
    z = x - x.amax(dim=1, keepdim=True)
    ex = torch.exp(z)
    se = ex.sum(dim=1, keepdim=True)
    return ex / se, z - torch.log(se)


def _pixel_weights(onehot: torch.Tensor,
                   class_weights: Optional[torch.Tensor],
                   w: LossWeights) -> torch.Tensor:
    """w_y per pixel: the target's class weight when weighted (0 for a
    target outside [0, C)), else 1."""
    if not w.weighted:
        return torch.ones_like(onehot[:, 0])
    C = onehot.shape[1]
    cw = torch.ones(C, device=onehot.device) if class_weights is None \
        else class_weights.float()
    return (onehot * cw.view(1, C, 1, 1)).sum(dim=1)


def fused_forward_reference(logits: torch.Tensor, target: torch.Tensor,
                            class_weights: Optional[torch.Tensor],
                            w: LossWeights) -> torch.Tensor:
    """Plain torch form of K2a: [B, C, H, W] logits, [B, H, W] integer
    targets -> the statistics vector acc [3C + 4] f32."""
    x = logits.float()
    p, logp = _softmax(x)
    onehot = one_hot(target, x.shape[1])
    nll = -(onehot * logp).sum(dim=1)
    px_w = _pixel_weights(onehot, class_weights, w)
    p_y = (onehot * p).sum(dim=1) + w.eps
    focal = -w.fl_alpha * torch.pow(1.0 - p_y, w.fl_gamma) * torch.log(p_y)
    dims = (0, 2, 3)
    scalars = torch.stack([(nll * px_w).sum(), px_w.sum(), focal.sum(),
                           torch.tensor(float(nll.numel()),
                                        device=x.device)])
    return torch.cat([(p * onehot).sum(dim=dims), p.sum(dim=dims),
                      onehot.sum(dim=dims), scalars])


def losses_from_acc(acc: torch.Tensor, n_classes: int, w: LossWeights
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                               torch.Tensor]:
    """(total, ce, dice, focal) from the statistics vector; device work
    only, no host sync."""
    C = n_classes
    inter, sum_p, cnt_t = acc[:C], acc[C:2 * C], acc[2 * C:3 * C]
    nll_sum, wsum, focal_sum, count = acc[3 * C:3 * C + 4]
    ce = nll_sum / wsum
    dice = (1.0 - (2.0 * inter + w.dice_smooth)
            / (sum_p + cnt_t + w.dice_smooth)).mean()
    focal = focal_sum / count
    total = w.ce * ce + w.dice * dice + w.focal * focal
    return total, ce, dice, focal


def fused_backward_reference(logits: torch.Tensor, target: torch.Tensor,
                             class_weights: Optional[torch.Tensor],
                             acc: torch.Tensor, cotangent: torch.Tensor,
                             w: LossWeights) -> torch.Tensor:
    """Plain torch form of K2b: d(total)/d(logits) times the cotangent,
    [B, C, H, W] f32."""
    x = logits.float()
    C = x.shape[1]
    p, _ = _softmax(x)
    onehot = one_hot(target, C)
    px_w = _pixel_weights(onehot, class_weights, w)[:, None]
    wsum, count = acc[3 * C + 1], acc[3 * C + 3]
    num = (2.0 * acc[:C] + w.dice_smooth).view(1, C, 1, 1)
    den = (acc[C:2 * C] + acc[2 * C:3 * C] + w.dice_smooth).view(1, C, 1, 1)

    d_ce = (px_w / wsum) * (p - onehot)
    p_y = (onehot * p).sum(dim=1, keepdim=True)
    q = p_y + w.eps
    fprime = -w.fl_alpha * (
        -w.fl_gamma * torch.pow(1.0 - q, w.fl_gamma - 1.0) * torch.log(q)
        + torch.pow(1.0 - q, w.fl_gamma) / q)
    d_focal = (fprime / count) * p_y * (onehot - p)
    g = (num - 2.0 * onehot * den) / (C * (den * den))
    gp = (g * p).sum(dim=1, keepdim=True)
    d_dice = p * (g - gp)
    dx = w.ce * d_ce + w.focal * d_focal + w.dice * d_dice
    return dx * cotangent.float()


# --------------------------------------------------------------------- #
# kernel wrappers
# --------------------------------------------------------------------- #

def _check(logits: torch.Tensor, target: torch.Tensor,
           class_weights: Optional[torch.Tensor], name: str):
    """Validate CUDA operands; returns (C, N, HW, sB, sC, sP, cw)."""
    if logits.dtype != torch.float32 or logits.dim() != 4:
        raise ValueError(f"{name}: logits must be [B, C, H, W] float32, got "
                         f"{tuple(logits.shape)} {logits.dtype}")
    if not (logits.is_contiguous()
            or logits.is_contiguous(memory_format=torch.channels_last)):
        raise ValueError(f"{name}: logits must be contiguous NCHW or "
                         f"channels_last, got strides {logits.stride()}")
    B, C, H, W = logits.shape
    if not 1 <= C <= MAX_CLASSES:
        raise ValueError(f"{name}: {C} classes, the kernel takes at most "
                         f"MAX_CLASSES = {MAX_CLASSES}; train with "
                         "fused_loss='off' (the plain multi_loss) for more")
    if not 1 <= B <= MAX_BATCH or H * W < 1:
        raise ValueError(f"{name}: batch {B} of {H}x{W} pixels, the kernel "
                         f"takes 1 to {MAX_BATCH} images of at least one "
                         "pixel")
    if (target.dtype != torch.uint8 or tuple(target.shape) != (B, H, W)
            or not target.is_contiguous() or target.device != logits.device):
        raise ValueError(f"{name}: target must be a contiguous uint8 "
                         f"[{B}, {H}, {W}] tensor on {logits.device}, got "
                         f"{tuple(target.shape)} {target.dtype} on "
                         f"{target.device}")
    if class_weights is None:
        cw = torch.ones(C, dtype=torch.float32, device=logits.device)
    else:
        cw = class_weights.to(logits.device, torch.float32).contiguous()
        if cw.shape != (C,):
            raise ValueError(f"{name}: class_weights {tuple(cw.shape)}, "
                             f"expected ({C},)")
    return (C, B * H * W, H * W, logits.stride(0), logits.stride(1),
            _pixel_stride(logits), cw)


def _pixel_stride(logits: torch.Tensor) -> int:
    """Stride of the merged (H, W) pixel index of an accepted layout."""
    return logits.stride(3) if logits.shape[3] > 1 else logits.stride(2)


# names of the kernels, by the code ``fused_loss_forward_variant`` and
# ``fused_loss_backward_variant`` return
VARIANTS = {2: "staged<C={C}>", 1: "direct<C={C}>", 0: "direct<runtime C>"}


def forward_variant_code(logits: torch.Tensor) -> int:
    """Which instantiation of K2a's kernel ``logits`` gets, as the
    library's dispatch decides it: 1 a compile-time class count, 0 a
    run-time class count."""
    return 1 if logits.shape[1] in KNOWN_CLASSES else 0


def forward_variant(logits: torch.Tensor) -> str:
    """Name of the K2a kernel that ``logits`` runs on."""
    return VARIANTS[forward_variant_code(logits)].format(C=logits.shape[1])


def backward_variant_code(logits: torch.Tensor, aligned: bool = True) -> int:
    """Which K2b kernel ``logits`` (an accepted layout) gets, as the
    library's dispatch decides it: 2 the staged kernel (a compile-time
    class count, dense channels_last: class stride 1, pixel stride C,
    batch stride H*W*C; logits and dlogits 16-byte aligned), 1 the direct
    kernel with a compile-time class count, 0 the direct kernel with a
    run-time class count."""
    B, C, H, W = logits.shape
    if C not in KNOWN_CLASSES:
        return 0
    flat = (logits.stride(1) == 1 and _pixel_stride(logits) == C
            and logits.stride(0) == H * W * C)
    return 2 if flat and aligned else 1


def backward_variant(logits: torch.Tensor) -> str:
    """Name of the K2b kernel that ``logits`` runs on."""
    code = backward_variant_code(logits, logits.data_ptr() % 16 == 0)
    return VARIANTS[code].format(C=logits.shape[1])


def fused_loss_forward(logits: torch.Tensor, target: torch.Tensor,
                       class_weights: Optional[torch.Tensor],
                       w: LossWeights) -> torch.Tensor:
    """K2a: the statistics vector acc [3C + 4] f32 of ``logits``
    [B, C, H, W] against ``target`` [B, H, W].

    A CPU tensor goes through ``fused_forward_reference``; a CUDA tensor
    through the kernel ``forward_variant`` names, or this raises."""
    if logits.device.type == "cpu":
        return fused_forward_reference(logits, target, class_weights, w)
    if logits.device.type != "cuda":
        raise ValueError(f"fused_loss_forward: no kernel for device "
                         f"{logits.device}")
    C, N, HW, sB, sC, sP, cw = _check(logits, target, class_weights,
                                      "fused_loss_forward")
    lib = _library()
    workspace = torch.empty(lib.fused_loss_workspace(N, HW, C),
                            dtype=torch.float32, device=logits.device)
    acc = torch.empty(3 * C + 4, dtype=torch.float32, device=logits.device)
    with torch.cuda.device(logits.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.fused_loss_forward_f32(
            logits.data_ptr(), target.data_ptr(), cw.data_ptr(),
            workspace.data_ptr(), acc.data_ptr(), C, N, HW, sB, sC, sP,
            int(w.weighted), w.fl_alpha, w.fl_gamma, w.eps, stream)
    if err != 0:
        raise RuntimeError(f"fused_loss_forward kernel launch failed: CUDA "
                           f"error {err}")
    fused_loss_forward.launches += 1
    return acc


def _launch_backward(logits, target, class_weights, acc, cotangent, w,
                     direct: bool) -> torch.Tensor:
    if logits.device.type != "cuda":
        raise ValueError(f"fused_loss_backward: no kernel for device "
                         f"{logits.device}")
    C, N, HW, sB, sC, sP, cw = _check(logits, target, class_weights,
                                      "fused_loss_backward")
    acc = acc.to(logits.device, torch.float32).contiguous()
    ct = cotangent.to(logits.device, torch.float32).reshape(1).contiguous()
    if acc.shape != (3 * C + 4,):
        raise ValueError(f"fused_loss_backward: acc {tuple(acc.shape)}, "
                         f"expected ({3 * C + 4},)")
    dx = torch.empty_like(logits)
    if dx.stride() != logits.stride():
        raise RuntimeError("fused_loss_backward: dlogits did not take the "
                           "logits' strides")
    with torch.cuda.device(logits.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _library().fused_loss_backward_f32(
            logits.data_ptr(), target.data_ptr(), cw.data_ptr(),
            acc.data_ptr(), ct.data_ptr(), dx.data_ptr(), C, N, HW, sB, sC,
            sP, int(w.weighted), w.fl_alpha, w.fl_gamma, w.eps,
            w.dice_smooth, w.ce, w.dice, w.focal, int(direct), stream)
    if err != 0:
        raise RuntimeError(f"fused_loss_backward kernel launch failed: CUDA "
                           f"error {err}")
    return dx


def fused_loss_backward(logits: torch.Tensor, target: torch.Tensor,
                        class_weights: Optional[torch.Tensor],
                        acc: torch.Tensor, cotangent: torch.Tensor,
                        w: LossWeights) -> torch.Tensor:
    """K2b: d(total)/d(logits) x ``cotangent`` (a 0-d tensor), in the
    logits' own layout.

    A CPU tensor goes through ``fused_backward_reference``; a CUDA tensor
    through the kernel ``backward_variant`` names, or this raises."""
    if logits.device.type == "cpu":
        return fused_backward_reference(logits, target, class_weights, acc,
                                        cotangent, w)
    dx = _launch_backward(logits, target, class_weights, acc, cotangent, w,
                          direct=False)
    fused_loss_backward.launches += 1
    return dx


def fused_loss_backward_direct(logits: torch.Tensor, target: torch.Tensor,
                               class_weights: Optional[torch.Tensor],
                               acc: torch.Tensor, cotangent: torch.Tensor,
                               w: LossWeights) -> torch.Tensor:
    """``fused_loss_backward`` on the direct kernel whatever the layout,
    CUDA tensors only: the yardstick the staged kernel is timed against.
    The package's paths do not call it, and it counts no launch."""
    return _launch_backward(logits, target, class_weights, acc, cotangent,
                            w, direct=True)


fused_loss_forward.launches = 0
fused_loss_backward.launches = 0


class FusedMultiLoss(torch.autograd.Function):
    """K2a forward, K2b backward; only the total carries a gradient."""

    @staticmethod
    def forward(ctx, logits, target, class_weights, w):
        acc = fused_loss_forward(logits, target, class_weights, w)
        total, ce, dice, focal = losses_from_acc(acc, logits.shape[1], w)
        ctx.save_for_backward(logits, target, class_weights, acc)
        ctx.w = w
        ctx.mark_non_differentiable(ce, dice, focal)
        return total, ce, dice, focal

    @staticmethod
    def backward(ctx, d_total, *_):
        logits, target, class_weights, acc = ctx.saved_tensors
        dx = fused_loss_backward(logits, target, class_weights, acc,
                                 d_total, ctx.w)
        return dx, None, None, None


def fused_multi_loss(logits: torch.Tensor, target: torch.Tensor,
                     class_weights: Optional[torch.Tensor] = None,
                     w: LossWeights = LossWeights()
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Drop-in for ``multi_loss`` (no sample mask) on kernels K2a/K2b:
    ``logits`` [B, C, H, W] f32, ``target`` [B, H, W] (uint8 on a card).
    Returns (total, {"ce", "dice", "focal"}); the aux values are
    detached."""
    total, ce, dice, focal = FusedMultiLoss.apply(logits, target,
                                                  class_weights, w)
    return total, {"ce": ce, "dice": dice, "focal": focal}
