"""int8 convolution: CUDA kernels Q (``quantize_int8``) and KQ
(``int8_conv2d``) and their plain forms.

They replace no Pallas kernel: the JAX package's int8 inference path
(``pylc_tpu/quant.py::_quantized_conv``) computes each calibrated
convolution with XLA's ``lax.conv_general_dilated(...,
preferred_element_type=int32)`` (``quant.py:133``), and PyTorch has no
int8 x int8 -> int32 convolution.  The kernels are
``pylc_tpu_torch/csrc/int8_conv.cu`` (its header says what bounds them
and what their design does about that), compiled by ``_build`` (nvcc,
``sm_90a``) into ``pylc_tpu_torch/_build/`` on first use and called
through ``ctypes`` on PyTorch's current stream.

  Q   channels_last f32 or bf16 [B, C, H, W] -> int8 NHWC [B, H, W, C],
      ``clamp(round_half_even(x * inv_s), -127, 127)`` with
      ``inv_s = inverse_scale(s_x)``.
  KQ  int8 NHWC [B, H, W, I] and int8 weights [O, kh, kw, I/groups] ->
      NHWC [B, Ho, Wo, O] in f32 or bf16: an int32 sum of products over
      the window (any stride, zero padding, dilation and groups), then
      ``float(acc) * (w_scale[o] * s_x) + bias[o]``, each step rounded on
      its own, cast to the output type.

Both are custom operators (``torch.ops.pylc.quantize_int8``,
``torch.ops.pylc.int8_conv2d``), so that ``torch.export`` records each as
one call in a serving program, as ``pylc::crf_iteration`` is recorded.
Their CPU implementations are the plain torch versions and their CUDA
implementations launch the kernels; there is no other choice between the
two, and no other device.  ``quantize_int8.launches`` and
``int8_conv2d.launches`` count kernel launches inside the CUDA
implementations.  Importing this module registers the operators.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from pylc_tpu_torch.ops.kernels import _build

SOURCE = _build.source_path("int8_conv")

Q_MAX = 127.0
# the largest reduction KQ's int32 accumulator holds exactly:
# 127**2 * K < 2**31 (the C entry refuses larger)
MAX_REDUCTION = 133000
# the C entries' flag for a float32 or bfloat16 operand (Q's input, KQ's
# output)
DTYPE_FLAGS = {torch.float32: 0, torch.bfloat16: 1}
# KQ's forms, by the number csrc's int8_conv2d_form gives them
FORMS = ("tiled", "tiled-bytes", "grouped")


def inverse_scale(s_x: float) -> float:
    """``1 / s_x`` as XLA makes it for the JAX package: both rounded to
    float32, the quotient computed in float32.  XLA on the CPU rewrites
    ``x / s_x`` by the constant ``s_x`` (``quant.py:130-131``) into
    ``x * (1 / s_x)``; at ties the two differ, and JAX's quantized values
    follow the product (checked against JAX 0.9 on the CPU)."""
    return float(np.float32(1.0) / np.float32(s_x))


def output_hw(H: int, W: int, kernel: Sequence[int], stride: Sequence[int],
              padding: Sequence[int], dilation: Sequence[int]):
    """(Ho, Wo) of a convolution with zero padding, as ``F.conv2d``."""
    return tuple((n + 2 * p - d * (k - 1) - 1) // s + 1 for n, k, s, p, d in
                 zip((H, W), kernel, stride, padding, dilation))


def build(force: bool = False):
    """Compile the kernel library if it is missing or older than its
    source.  Returns (library path, nvcc's ``-Xptxas -v`` report; empty
    when nothing was built)."""
    return _build.build("int8_conv", force)


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = _build.load("int8_conv")
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.int8_conv2d.argtypes = [vp, vp, vp, vp, cf, vp, ci] + [ci] * 16 + [vp]
    lib.int8_conv2d.restype = ci
    lib.quantize_int8.argtypes = [vp, ci, vp, ctypes.c_longlong, cf, vp]
    lib.quantize_int8.restype = ci
    lib.int8_conv2d_form.argtypes = [ci, ci, ci]
    lib.int8_conv2d_form.restype = ci
    return lib


# ---------------------------------------------------------------- Q


def quantize_int8_plain(x: torch.Tensor, s_x: float) -> torch.Tensor:
    """Plain torch form of Q: [B, C, H, W] (any layout) -> contiguous int8
    [B, H, W, C].  ``torch.round`` rounds half to even, as ``jnp.round``
    and the kernel's ``__float2int_rn``; the product by the float32
    ``inverse_scale`` rounds once, on the CPU and on the card alike."""
    y = torch.round(x.permute(0, 2, 3, 1).float() * inverse_scale(s_x))
    return torch.clamp(y, -Q_MAX, Q_MAX).to(torch.int8).contiguous()


def _launch_quantize(x: torch.Tensor, s_x: float) -> torch.Tensor:
    if x.device.type != "cuda":
        raise ValueError(f"quantize_int8: no kernel for device {x.device}")
    if x.dtype not in DTYPE_FLAGS:
        raise ValueError(f"quantize_int8: {x.dtype}; the kernel takes "
                         "float32 or bfloat16")
    if x.dim() != 4 or not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("quantize_int8: the kernel takes a channels_last "
                         f"[B, C, H, W] tensor, got {tuple(x.shape)} with "
                         f"strides {x.stride()}")
    B, C, H, W = x.shape
    q = torch.empty((B, H, W, C), dtype=torch.int8, device=x.device)
    with torch.cuda.device(x.device):
        err = _library().quantize_int8(
            x.data_ptr(), DTYPE_FLAGS[x.dtype], q.data_ptr(), x.numel(),
            inverse_scale(s_x), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"quantize_int8 kernel launch failed: CUDA "
                           f"error {err}")
    return q


@torch.library.custom_op("pylc::quantize_int8", mutates_args=(),
                         device_types="cpu")
def _quantize_op(x: torch.Tensor, s_x: float) -> torch.Tensor:
    return quantize_int8_plain(x, s_x)


@_quantize_op.register_kernel("cuda")
def _quantize_cuda(x, s_x):
    q = _launch_quantize(x, s_x)
    quantize_int8.launches += 1
    return q


@_quantize_op.register_fake
def _quantize_fake(x, s_x):
    B, C, H, W = x.shape
    return x.new_empty((B, H, W, C), dtype=torch.int8)


def quantize_int8(x: torch.Tensor, s_x: float) -> torch.Tensor:
    """Q through ``torch.ops.pylc.quantize_int8``: a channels_last
    [B, C, H, W] activation -> int8 [B, H, W, C].  A CPU tensor goes
    through ``quantize_int8_plain``; a CUDA tensor through the kernel, or
    this raises."""
    return _quantize_op(x, float(s_x))


quantize_int8.launches = 0


# ---------------------------------------------------------------- KQ


def int8_conv2d_plain(qx: torch.Tensor, qw: torch.Tensor,
                      w_scale: torch.Tensor, bias: Optional[torch.Tensor],
                      s_x: float, stride: Sequence[int],
                      padding: Sequence[int], dilation: Sequence[int],
                      groups: int, out_dtype: torch.dtype) -> torch.Tensor:
    """Plain torch form of KQ, same operands and result layout.  The
    products and their sums are taken by ``F.conv2d`` in float64: every
    partial sum is an integer of magnitude below 127**2 * K < 2**53, so it
    is exact whatever the order (cuDNN is kept out: its FFT and Winograd
    forms are not exact).  Then the same epilogue as the kernel, one
    rounding per operation."""
    x = qx.permute(0, 3, 1, 2).double()
    w = qw.permute(0, 3, 1, 2).double()
    with torch.backends.cudnn.flags(enabled=False):
        acc = F.conv2d(x, w, None, tuple(stride), tuple(padding),
                       tuple(dilation), groups)
    scale = w_scale * float(np.float32(s_x))
    y = acc.to(torch.int32).float() * scale[:, None, None]
    if bias is not None:
        y = y + bias[:, None, None]
    return y.to(out_dtype).permute(0, 2, 3, 1).contiguous()


def _check_conv(qx, qw, w_scale, bias, groups, out_dtype):
    """Validate KQ's operands; returns (B, H, W, C, O, kh, kw)."""
    for name, t, dtype, dim in (("qx", qx, torch.int8, 4),
                                ("qw", qw, torch.int8, 4),
                                ("w_scale", w_scale, torch.float32, 1),
                                ("bias", bias, torch.float32, 1)):
        if t is None:
            continue
        if t.device != qx.device:
            raise ValueError(f"int8_conv2d: {name} on {t.device}, qx on "
                             f"{qx.device}")
        if t.dtype != dtype or t.dim() != dim or not t.is_contiguous():
            raise ValueError(f"int8_conv2d: {name} must be a contiguous "
                             f"{dim}-d {dtype} tensor, got {t.dtype} "
                             f"{tuple(t.shape)}")
    B, H, W, C = qx.shape
    O, kh, kw, Cg = qw.shape
    if groups < 1 or C % groups or O % groups or Cg * groups != C:
        raise ValueError(f"int8_conv2d: weights {tuple(qw.shape)} and "
                         f"groups={groups} do not fit {C} input channels")
    if w_scale.shape != (O,) or (bias is not None and bias.shape != (O,)):
        raise ValueError("int8_conv2d: w_scale and bias need one entry per "
                         f"output channel ({O})")
    if kh * kw * Cg > MAX_REDUCTION:
        raise ValueError(f"int8_conv2d: a reduction of {kh * kw * Cg} "
                         f"products overflows int32 (at most "
                         f"{MAX_REDUCTION})")
    if out_dtype not in DTYPE_FLAGS:
        raise ValueError(f"int8_conv2d: output {out_dtype}; the kernel "
                         "writes float32 or bfloat16")
    return B, H, W, C, O, kh, kw


def form(qx: torch.Tensor, qw: torch.Tensor, groups: int) -> str:
    """Name of the form KQ runs on these CUDA operands: the library's own
    choice (``int8_conv2d_form``), from I, ``groups`` and whether both
    int8 operands start on 4-byte boundaries."""
    aligned = qx.data_ptr() % 4 == 0 and qw.data_ptr() % 4 == 0
    return FORMS[_library().int8_conv2d_form(qx.shape[-1], groups,
                                             int(aligned))]


def _launch_conv(qx, qw, w_scale, bias, s_x, stride, padding, dilation,
                 groups, out_dtype) -> torch.Tensor:
    if qx.device.type != "cuda":
        raise ValueError(f"int8_conv2d: no kernel for device {qx.device}")
    B, H, W, C, O, kh, kw = _check_conv(qx, qw, w_scale, bias, groups,
                                        out_dtype)
    Ho, Wo = output_hw(H, W, (kh, kw), stride, padding, dilation)
    if Ho < 1 or Wo < 1:
        raise ValueError(f"int8_conv2d: no output pixel ({Ho}x{Wo})")
    y = torch.empty((B, Ho, Wo, O), dtype=out_dtype, device=qx.device)
    with torch.cuda.device(qx.device):
        err = _library().int8_conv2d(
            qx.data_ptr(), qw.data_ptr(), w_scale.data_ptr(),
            None if bias is None else bias.data_ptr(), s_x, y.data_ptr(),
            DTYPE_FLAGS[out_dtype], B, H, W, C, O, kh, kw, stride[0],
            stride[1], padding[0], padding[1], dilation[0], dilation[1],
            groups, Ho, Wo, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"int8_conv2d kernel launch failed: CUDA error "
                           f"{err}")
    return y


@torch.library.custom_op("pylc::int8_conv2d", mutates_args=(),
                         device_types="cpu")
def _conv_op(qx: torch.Tensor, qw: torch.Tensor, w_scale: torch.Tensor,
             bias: Optional[torch.Tensor], s_x: float, stride: List[int],
             padding: List[int], dilation: List[int], groups: int,
             out_dtype: torch.dtype) -> torch.Tensor:
    _check_conv(qx, qw, w_scale, bias, groups, out_dtype)
    return int8_conv2d_plain(qx, qw, w_scale, bias, s_x, stride, padding,
                             dilation, groups, out_dtype)


@_conv_op.register_kernel("cuda")
def _conv_cuda(qx, qw, w_scale, bias, s_x, stride, padding, dilation, groups,
               out_dtype):
    y = _launch_conv(qx, qw, w_scale, bias, s_x, stride, padding, dilation,
                     groups, out_dtype)
    int8_conv2d.launches += 1
    return y


@_conv_op.register_fake
def _conv_fake(qx, qw, w_scale, bias, s_x, stride, padding, dilation, groups,
               out_dtype):
    B, H, W, _ = qx.shape
    O, kh, kw, _ = qw.shape
    Ho, Wo = output_hw(H, W, (kh, kw), stride, padding, dilation)
    return qx.new_empty((B, Ho, Wo, O), dtype=out_dtype)


def int8_conv2d(qx: torch.Tensor, qw: torch.Tensor, w_scale: torch.Tensor,
                bias: Optional[torch.Tensor], s_x: float,
                stride: Sequence[int], padding: Sequence[int],
                dilation: Sequence[int], groups: int,
                out_dtype: torch.dtype) -> torch.Tensor:
    """KQ through ``torch.ops.pylc.int8_conv2d``: int8 NHWC activations
    [B, H, W, I] (from ``quantize_int8`` at the same ``s_x``), int8
    weights [O, kh, kw, I/groups] with their float32 per-channel scales
    [O] and an optional float32 bias [O] -> [B, Ho, Wo, O] in
    ``out_dtype`` (float32 or bfloat16).  A CPU tensor goes through
    ``int8_conv2d_plain``; a CUDA tensor through the kernel ``form``
    names, or this raises."""
    return _conv_op(qx, qw, w_scale, bias, float(s_x),
                    [int(v) for v in stride], [int(v) for v in padding],
                    [int(v) for v in dilation], int(groups), out_dtype)


int8_conv2d.launches = 0
