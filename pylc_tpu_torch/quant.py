"""Post-training int8 quantization (PTQ) of the inference path.

Port of ``pylc_tpu/quant.py``, name for name.  Scheme (symmetric PTQ):

  - weights: per-output-channel int8, scale = absmax / 127 over
    (I, kh, kw), quantized once when the predict is built;
  - activations: per-conv-instance, per-tensor int8, the scale calibrated
    by absmax over real tiles (``calibrate_absmax``);
  - every calibrated ``nn.Conv2d`` computed as int8 x int8 -> int32 on
    kernel KQ after its input went through kernel Q
    (``ops/kernels/int8_conv.py``), dequantized with the product of the
    scales, its bias added in f32, cast to what the float convolution
    would return (bf16 under bf16 autocast).  BatchNorm, ReLU and resizes
    stay as they are.

The model definitions are not touched: ``make_predict_int8`` serves a
copy of the module tree in which each calibrated convolution is an
``Int8Conv2d`` and every other module is the float model's own (shared,
not copied), so one network serves float and int8, as the JAX package's
method interceptor does.  A convolution without a scale runs float, as in
the JAX package (``quant.py:148-152``).  ``isinstance(m, nn.Conv2d)``
catches exactly the convolutions that flax's ``isinstance(m, nn.Conv)``
does: transposed convolutions (the U-Nets' ``upconv``) are neither, and
stay float in both packages.

Scales are keyed by the port's module names (``model.named_modules()``);
``scales_from_jax`` / ``scales_to_jax`` carry a JAX scale dict (keyed by
the flax module path joined with "/") across through
``convert.module_map``.

Flow:
  scales = calibrate_absmax(model, calibration_batches_from_db(db, cfg))
  predict_q = make_predict_int8(cfg, model, scales)
  seg = Segmenter(cfg, predict_q, device)                # drop-in
"""

from __future__ import annotations

import copy
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch
from torch import nn

from pylc_tpu_torch.config import Config
from pylc_tpu_torch.convert import module_map
from pylc_tpu_torch.db.database import TileDB
from pylc_tpu_torch.device import resolve_device
from pylc_tpu_torch.ops.kernels.int8_conv import (Q_MAX, int8_conv2d,
                                                   quantize_int8)
from pylc_tpu_torch.train_state import make_predict, prepare_batch

__all__ = ["Q_MAX", "Int8Conv2d", "calibrate_absmax", "scales_from_jax",
           "scales_to_jax", "quantize_model", "make_predict_int8",
           "calibration_batches_from_db"]

# 1/127 in float32: XLA turns the JAX package's division of the weights'
# absmax by the constant 127 (quant.py:123) into this product
_INV_Q_MAX = float(np.float32(1.0) / np.float32(Q_MAX))


def calibrate_absmax(model: nn.Module, batches: Iterable[torch.Tensor]
                     ) -> Dict[str, float]:
    """Run calibration batches through the model in eval mode, recording
    each ``nn.Conv2d`` instance's input absmax (keyed by module name) and
    keeping the largest over the batches.

    ``batches`` are prepared model inputs, [B, C, H, W] as the model takes
    them (``calibration_batches_from_db``).  A caller that serves under
    bf16 autocast calibrates inside the same ``torch.autocast``: the hooks
    see each convolution's input as the forward makes it."""
    stats: Dict[str, torch.Tensor] = {}

    def hook_for(name):
        def hook(module, args):
            mx = args[0].detach().float().abs().amax()
            stats[name] = torch.maximum(stats[name], mx) \
                if name in stats else mx
        return hook

    handles = [m.register_forward_pre_hook(hook_for(name))
               for name, m in model.named_modules()
               if isinstance(m, nn.Conv2d)]
    was_training = model.training
    model.eval()
    out: Dict[str, float] = {}
    try:
        with torch.no_grad():
            for b in batches:
                stats.clear()
                model(b)
                names = list(stats)
                # one copy to the host per batch for every conv's statistic
                values = torch.stack([stats[n] for n in names]).cpu()
                for name, v in zip(names, values.tolist()):
                    out[name] = max(out.get(name, 0.0), v)
    finally:
        for h in handles:
            h.remove()
        model.train(was_training)
    return out


def _path_names(cfg: Config) -> Dict[str, str]:
    return {"/".join(j): t for t, j in module_map(cfg)}


def scales_from_jax(cfg: Config, scales: Dict[str, float]
                    ) -> Dict[str, float]:
    """A JAX package scale dict (``pylc_tpu.quant.calibrate_absmax``'s,
    keyed by flax module path) -> the port's keys, for the model ``cfg``
    configures."""
    names = _path_names(cfg)
    missing = sorted(set(scales) - set(names))
    if missing:
        raise KeyError(f"no module of the port's {cfg.arch} model for "
                       f"the JAX paths {missing}")
    return {names[k]: float(v) for k, v in scales.items()}


def scales_to_jax(cfg: Config, scales: Dict[str, float]
                  ) -> Dict[str, float]:
    """``scales_from_jax`` backwards."""
    paths = {t: j for j, t in _path_names(cfg).items()}
    missing = sorted(set(scales) - set(paths))
    if missing:
        raise KeyError(f"no flax module of the {cfg.arch} model for the "
                       f"port's modules {missing}")
    return {paths[k]: float(v) for k, v in scales.items()}


class Int8Conv2d(nn.Module):
    """A calibrated ``nn.Conv2d`` on kernels Q and KQ.

    Holds the weights quantized once, with the JAX package's numbers
    (``quant.py:122-125``), flattened to [O, kh*kw*I/groups] (a 4-d int8
    buffer would be turned channels_last by ``make_predict``), their
    float32 scales, the float bias and ``s_x = max(act_scale, 1e-12) /
    127`` (Python double, used as float32 by the kernels), but not the
    float weights."""

    def __init__(self, conv: nn.Conv2d, act_scale: float):
        super().__init__()
        if isinstance(conv.padding, str) or conv.padding_mode != "zeros":
            raise NotImplementedError(
                f"int8 PTQ covers zero-padded convs with explicit padding "
                f"(got padding={conv.padding!r}, "
                f"padding_mode={conv.padding_mode!r})")
        kf = conv.weight.detach().float()                  # [O, I/g, kh, kw]
        w_scale = torch.clamp_min(
            kf.abs().amax(dim=(1, 2, 3)) * _INV_Q_MAX, 1e-12)
        qw = torch.clamp(torch.round(kf / w_scale[:, None, None, None]),
                         -Q_MAX, Q_MAX).to(torch.int8)
        O = qw.shape[0]
        self.register_buffer(
            "qweight", qw.permute(0, 2, 3, 1).reshape(O, -1).contiguous())
        self.register_buffer("w_scale", w_scale)
        self.register_buffer("bias", None if conv.bias is None
                             else conv.bias.detach().float().clone())
        self.weight_shape = (O, *conv.kernel_size, conv.in_channels //
                             conv.groups)
        self.stride = tuple(conv.stride)
        self.padding = tuple(conv.padding)
        self.dilation = tuple(conv.dilation)
        self.groups = conv.groups
        self.s_x = max(float(act_scale), 1e-12) / Q_MAX

    @property
    def weight(self) -> torch.Tensor:
        """The weights this conv applies, dequantized: qweight * w_scale
        in the float conv's layout [O, I/groups, kh, kw] (float32).  Made
        on each read; model code reads it for its dtype (the U-Nets'
        head)."""
        return (self.qweight.view(self.weight_shape).float()
                * self.w_scale[:, None, None, None]).permute(0, 3, 1, 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dev = x.device.type
        out_dtype = torch.get_autocast_dtype(dev) \
            if torch.is_autocast_enabled(dev) else x.dtype
        qx = quantize_int8(x.contiguous(memory_format=torch.channels_last),
                           self.s_x)
        y = int8_conv2d(qx, self.qweight.view(self.weight_shape),
                        self.w_scale, self.bias, self.s_x, self.stride,
                        self.padding, self.dilation, self.groups, out_dtype)
        return y.permute(0, 3, 1, 2)  # a channels_last view

    def extra_repr(self) -> str:
        return (f"weight={self.weight_shape}, stride={self.stride}, "
                f"padding={self.padding}, dilation={self.dilation}, "
                f"groups={self.groups}, s_x={self.s_x:.6g}")


def quantize_model(model: nn.Module, scales: Dict[str, float]) -> nn.Module:
    """A copy of ``model``'s module tree with every ``nn.Conv2d`` that has
    a positive scale replaced by an ``Int8Conv2d``.  Modules whose subtree
    holds no such conv are the model's own objects.  A copied container
    holds the model's parameters and buffers, but in dicts of its own, as
    are its hooks and its ``training`` flag: a hook registered on it, or a
    mode set on it alone, does not reach the model's.  This function
    changes nothing of the model."""

    def walk(module: nn.Module, name: str) -> nn.Module:
        s = scales.get(name)
        if isinstance(module, nn.Conv2d) and s is not None and s > 0.0:
            return Int8Conv2d(module, s)
        children = {k: walk(c, f"{name}.{k}" if name else k)
                    for k, c in module._modules.items() if c is not None}
        if all(children[k] is module._modules[k] for k in children):
            return module
        clone = copy.copy(module)
        # copy.copy shares every dict of the instance: parameters,
        # buffers, hooks
        for key, value in module.__dict__.items():
            if isinstance(value, (dict, set)):
                clone.__dict__[key] = copy.copy(value)
        clone.__dict__["_modules"] = {**module._modules, **children}
        return clone

    known = {name for name, m in model.named_modules()
             if isinstance(m, nn.Conv2d)}
    unknown = sorted(set(scales) - known)
    if unknown:
        raise KeyError(f"scales for modules that are no nn.Conv2d of the "
                       f"model: {unknown}")
    return walk(model, "")


def make_predict_int8(cfg: Config, model: nn.Module,
                      scales: Dict[str, float]
                      ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Drop-in replacement for ``train_state.make_predict`` whose forward
    runs the calibrated convs on kernels Q and KQ: the same input, output,
    autocast and channels_last contract (uint8 [B, H, W, C] -> f32 logits
    [B, H, W, K]).  ``predict.model`` is the int8 module tree (what a
    Segmenter copies to the other devices of a mesh, and what export
    traces) and ``predict.remake`` builds the same predict on a copy of
    it.

    The int8 tree serves the model's own modules outside the calibrated
    convs, so, as ``make_predict(cfg, model)`` does, this puts ``model``
    in eval mode and its parameters in ``channels_last``; a later
    ``model.train()`` reaches the shared modules of the int8 predict
    too."""
    model.eval()
    return make_predict(cfg, quantize_model(model, scales))


def calibration_batches_from_db(db, cfg: Config, n_tiles: int = 32,
                                batch: int = 8,
                                device: Optional[str] = None):
    """Prepared calibration inputs straight from a tile DB (a path, read
    with h5py, or a ``db.database.TileDB``, an in-memory one too): the
    first ``n_tiles`` images, through the same normalize the predict path
    uses, as [b, C, H, W] channels_last batches on ``device`` (default:
    the card)."""
    dev = resolve_device(device or "cuda")
    dbase = db if isinstance(db, TileDB) else TileDB(db)
    imgs, _ = dbase.read_chunk(0, min(n_tiles, dbase.size))  # [N,C,H,W] u8
    imgs = torch.from_numpy(np.ascontiguousarray(
        imgs.transpose(0, 2, 3, 1))).to(dev)                 # NHWC
    out = []
    for i in range(0, len(imgs), batch):
        x, _ = prepare_batch(cfg, imgs[i:i + batch])
        out.append(x.permute(0, 3, 1, 2))
    return out
