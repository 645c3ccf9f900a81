"""Weights across the two packages, and reference ``.pth`` loading.

Port of the DeepLab parts of ``pylc_tpu/convert.py``.  The port's module
names are the reference checkpoints' own, so a reference-schema ``.pth``
({'model': state_dict, 'meta': ...}) loads with ``strict=True``;
``load_reference_pth`` unpickles one whose ``meta`` is the reference's
``config.Parameters``; ``state_dict_from_jax`` is the JAX package's
exporter (``export_deeplab_pth``) without the file;
``load_resnet101_imagenet`` puts a torchvision-format ImageNet ResNet101
into a DeepLab's backbone.
"""

from __future__ import annotations

import sys
import types
from collections import OrderedDict
from functools import partial
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from pylc_tpu_torch.config import Config
from pylc_tpu_torch.models.registry import build_model


class _StubParameters:
    """Attribute bag that stands in for the reference's
    ``config.Parameters``, so that its pickles load without the
    reference's code."""

    def __setstate__(self, state):
        self.__dict__.update(state)


def load_reference_pth(path: str) -> Dict[str, Any]:
    """``torch.load`` a reference ``.pth`` whose ``meta`` is a pickled
    ``config.Parameters``: a stub module named ``config`` holds the class
    while the file loads.  Returns the raw dict; the tensors stay on the
    CPU.  Like any pickle, load only files you trust."""
    stub = types.ModuleType("config")
    stub.Parameters = _StubParameters
    had = sys.modules.get("config")
    sys.modules["config"] = stub
    try:
        return torch.load(path, map_location="cpu", weights_only=False)
    finally:
        if had is not None:
            sys.modules["config"] = had
        else:
            del sys.modules["config"]


def _put_conv(sd: Dict, key: str, p: Mapping):
    sd[key + ".weight"] = torch.tensor(
        np.asarray(p["kernel"]).transpose(3, 2, 0, 1))  # HWIO -> OIHW


def _put_bn(sd: Dict, key: str, p: Mapping, s: Mapping):
    sd[key + ".weight"] = torch.tensor(np.asarray(p["scale"]))
    sd[key + ".bias"] = torch.tensor(np.asarray(p["bias"]))
    sd[key + ".running_mean"] = torch.tensor(np.asarray(s["mean"]))
    sd[key + ".running_var"] = torch.tensor(np.asarray(s["var"]))


def resnet_state_dict(bp: Mapping, bs: Mapping, prefix: str = ""
                      ) -> "OrderedDict[str, torch.Tensor]":
    """JAX ResNet101 trees -> the port's ResNet101 state_dict keys
    (under ``prefix``)."""
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    _put_conv(sd, prefix + "conv1", bp["conv1"])
    _put_bn(sd, prefix + "bn1", bp["bn1"], bs["bn1"])
    for name in sorted(k for k in bp if k.startswith("layer")):
        L, i = name.replace("layer", "").split("_")
        tp = f"{prefix}layer{L}.{i}"
        for k in (1, 2, 3):
            _put_conv(sd, f"{tp}.conv{k}", bp[name][f"conv{k}"])
            _put_bn(sd, f"{tp}.bn{k}", bp[name][f"bn{k}"], bs[name][f"bn{k}"])
        if "downsample_conv" in bp[name]:
            _put_conv(sd, f"{tp}.downsample.0", bp[name]["downsample_conv"])
            _put_bn(sd, f"{tp}.downsample.1", bp[name]["downsample_bn"],
                    bs[name]["downsample_bn"])
    return sd


def state_dict_from_jax(params: Mapping, batch_stats: Mapping
                        ) -> "OrderedDict[str, torch.Tensor]":
    """JAX DeepLab/ResNet101 trees (nested dicts of numpy arrays) -> the
    port's state_dict: HWIO kernels to OIHW, BatchNorm scale/bias/mean/var
    to weight/bias/running_mean/running_var."""
    bp, bs = params["backbone"], batch_stats["backbone"]
    if "layer1_0" not in bp:
        raise NotImplementedError(
            "only the ResNet101 backbone is ported (ROADMAP Queue 1 "
            "item 13)")
    sd = resnet_state_dict(bp, bs, "backbone.")
    put_conv = partial(_put_conv, sd)
    put_bn = partial(_put_bn, sd)

    ap, as_ = params["aspp"], batch_stats["aspp"]
    for i in (1, 2, 3, 4):
        put_conv(f"aspp.aspp{i}.atrous_conv", ap[f"aspp{i}"]["conv"])
        put_bn(f"aspp.aspp{i}.bn", ap[f"aspp{i}"]["bn"], as_[f"aspp{i}"]["bn"])
    put_conv("aspp.global_avg_pool.1", ap["gap_conv"])
    put_bn("aspp.global_avg_pool.2", ap["gap_bn"], as_["gap_bn"])
    put_conv("aspp.conv1", ap["proj"])
    put_bn("aspp.bn1", ap["proj_bn"], as_["proj_bn"])

    dp, ds = params["decoder"], batch_stats["decoder"]
    put_conv("decoder.conv1", dp["ll_conv"])
    put_bn("decoder.bn1", dp["ll_bn"], ds["ll_bn"])
    put_conv("decoder.last_conv.0", dp["conv1"])
    put_bn("decoder.last_conv.1", dp["bn1"], ds["bn1"])
    put_conv("decoder.last_conv.4", dp["conv2"])
    put_bn("decoder.last_conv.5", dp["bn2"], ds["bn2"])
    put_conv("decoder.last_conv.8", dp["head"])
    sd["decoder.last_conv.8.bias"] = torch.tensor(
        np.asarray(dp["head"]["bias"]))
    return sd


def load_resnet101_imagenet(pth_path: str, model: nn.Module) -> nn.Module:
    """Load a torchvision-format ResNet101 state dict (the ImageNet
    ``resnet101-5d3b4d8f.pth``) into ``model.backbone`` in place: the
    ``fc.*`` head is dropped, every other key must match (strict)."""
    data = load_reference_pth(pth_path)
    if not isinstance(data, dict):
        raise ValueError(
            f"{pth_path}: expected a state_dict pickle, got "
            f"{type(data).__name__} — not an ImageNet resnet101 checkpoint.")
    sd = data if "conv1.weight" in data else data.get("state_dict", data)
    sd = {k: v for k, v in sd.items() if not k.startswith("fc.")}
    model.backbone.load_state_dict(sd, strict=True)
    return model


def load_pth_model(model_path: str, base_cfg: Optional[Config] = None
                   ) -> Tuple[Config, nn.Module]:
    """Load a reference-schema DeepLab ``.pth`` -> (cfg, model on the CPU).

    The checkpoint's meta rehydrates the config (arch, ch, schema,
    normalization stats), as ``pylc_tpu.convert.load_pth_model`` does."""
    data = load_reference_pth(model_path)
    if "model" not in data:
        raise ValueError(f"{model_path}: no 'model' state_dict")
    meta_obj = data.get("meta")
    meta: Dict = dict(meta_obj.__dict__) if hasattr(meta_obj, "__dict__") \
        else (meta_obj or {})
    cfg = Config.from_meta(meta, base=base_cfg)
    if cfg.arch != "deeplab":
        raise NotImplementedError(
            f".pth loading is implemented for deeplab (got {cfg.arch})")
    model = build_model(cfg)
    model.load_state_dict(data["model"], strict=True)
    return cfg, model
