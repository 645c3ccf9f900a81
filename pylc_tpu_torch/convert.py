"""Weights across the two packages: ``.pth`` loading, the ImageNet
encoders, and the JAX package's ``.ckpt``.

Port of ``pylc_tpu/convert.py``.  The port's DeepLab module names are the
reference checkpoints' own, so a reference-schema ``.pth`` ({'model':
state_dict, 'meta': ...}) loads with ``strict=True``;
``load_reference_pth`` unpickles one whose ``meta`` is the reference's
``config.Parameters``.

``module_map(cfg)`` is the table between the two packages' weights: for
every module with parameters, the port's state_dict prefix and the path of
the flax module in the JAX package's ``params`` / ``batch_stats`` trees.
``state_dict_from_jax`` and ``jax_trees_from_state_dict`` walk it in the
two directions (HWIO kernels <-> OIHW, a transposed conv's also mirrored;
scale/bias/mean/var <-> weight/bias/running_mean/running_var).  For the
two backbones the reference builds (ResNet101, Xception) the first equals
the JAX package's exporter (``export_deeplab_pth``) without the file.

``optimizer_from_jax`` and ``optimizer_to_jax`` map the optimizer state
both ways: optax's state of the JAX ``make_optimizer`` (as flax's
``to_state_dict`` gives it: nested dicts with numpy leaves, ``{}`` for the
empty states and the masked subtrees) <-> a torch optimizer and its
``LambdaLR`` as ``train_state.make_optimizer`` makes them.  AdamW's
``mu``/``nu`` are ``exp_avg``/``exp_avg_sq`` and its ``count`` the
parameters' ``step``; SGD's ``trace`` is ``momentum_buffer``; the
schedule's ``count`` is ``LambdaLR.last_epoch``.  Each moment takes the
layout moves of its parameter, and the two parameter groups of
``head_lr_mult`` are optax's ``backbone`` and ``head`` labels.

``checkpoint_from_jax`` and ``checkpoint_to_jax`` carry a whole resumable
payload, {epoch, iter, params, batch_stats, opt_state}, on top of them.
``load_ckpt_model`` and ``save_ckpt_model`` read and write the JAX
package's best-model file: flax's msgpack of {params, batch_stats} beside
a ``.meta`` JSON; ``load_ckpt_checkpoint`` and ``save_ckpt_checkpoint``
its resumable ``checkpoint.ckpt``.  Only the file functions need the
``msgpack`` package.
``load_*_imagenet`` put an ImageNet encoder into a DeepLab's backbone.
"""

from __future__ import annotations

import json
import os
import re
import struct
import sys
import types
from collections import OrderedDict
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from pylc_tpu_torch.config import Config
from pylc_tpu_torch.models.mobilenet import SETTINGS as MOBILENET_SETTINGS
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


# --------------------------------------------------------------------- #
# the table: port state_dict prefix <-> flax module path
# --------------------------------------------------------------------- #

ModuleMap = List[Tuple[str, Tuple[str, ...]]]

# flax's automatic names of the normalizer in a U-Net block, by norm_type
FLAX_NORM_NAMES = {"batch": "BatchNorm", "syncbatch": "BatchNorm",
                   "instance": "GroupNorm", "layer": "LayerNorm"}


def _bottleneck_modules(t: str, j: Tuple[str, ...], downsample: bool
                        ) -> ModuleMap:
    mods = [(f"{t}.{m}", j + (m,))
            for m in ("conv1", "bn1", "conv2", "bn2", "conv3", "bn3")]
    if downsample:
        mods += [(f"{t}.downsample.0", j + ("downsample_conv",)),
                 (f"{t}.downsample.1", j + ("downsample_bn",))]
    return mods


def resnet_modules(layers: Sequence[int] = (3, 4, 23, 3)) -> ModuleMap:
    """ResNet101: ``layer{L}.{i}`` <-> ``layer{L}_{i}``, in the exporter's
    order (by the flax name, as text).  ``layers``: the block counts of
    layer1-3; layer4 is the multi-grid unit of 3."""
    mods: ModuleMap = [("conv1", ("conv1",)), ("bn1", ("bn1",))]
    counts = (*layers[:3], 3)
    for name in sorted(f"layer{L + 1}_{i}" for L, n in enumerate(counts)
                       for i in range(n)):
        L, i = name.replace("layer", "").split("_")
        mods += _bottleneck_modules(f"layer{L}.{i}", (name,), i == "0")
    return mods


def _separable_modules(t: str, j: Tuple[str, ...]) -> ModuleMap:
    return [(f"{t}.conv1", j + ("depthwise",)), (f"{t}.bn", j + ("bn",)),
            (f"{t}.pointwise", j + ("pointwise",))]


def xception_modules() -> ModuleMap:
    """Aligned Xception: separable j of a block sits at ``rep.{3j}`` in
    blocks 1-2 (no leading ReLU) and at ``rep.{3j + 1}`` in blocks 3-20,
    its norm one index later; the middle blocks 4-19 have no skip conv."""
    mods: ModuleMap = [("conv1", ("conv1",)), ("bn1", ("bn1",)),
                       ("conv2", ("conv2",)), ("bn2", ("bn2",))]
    for n in range(1, 21):
        base = 0 if n <= 2 else 1
        for j in range(3):
            i = 3 * j + base
            mods += _separable_modules(f"block{n}.rep.{i}",
                                       (f"block{n}", f"sep{j}"))
            mods.append((f"block{n}.rep.{i + 1}", (f"block{n}", f"sepbn{j}")))
        if not 4 <= n <= 19:
            mods += [(f"block{n}.skip", (f"block{n}", "skip")),
                     (f"block{n}.skipbn", (f"block{n}", "skipbn"))]
    for i in (3, 4, 5):
        mods += _separable_modules(f"conv{i}", (f"conv{i}",))
        mods.append((f"bn{i}", (f"bn{i}",)))
    return mods


def mobilenet_modules() -> ModuleMap:
    """MobileNetV2: ``features.{i}.conv.{k}`` <-> ``block{i}``'s named
    layers; an expand-1 block is [dw, bn, relu6, pw, bn], the others
    [pw, bn, relu6, dw, bn, relu6, pw, bn]."""
    mods: ModuleMap = [("features.0.0", ("stem_conv",)),
                       ("features.0.1", ("stem_bn",))]
    i = 1
    for t, _, n, _ in MOBILENET_SETTINGS:
        names = ("dw_conv", "dw_bn", None, "project_conv", "project_bn")
        if t != 1:
            names = ("expand_conv", "expand_bn", None) + names
        for _ in range(n):
            mods += [(f"features.{i}.conv.{k}", (f"block{i}", name))
                     for k, name in enumerate(names) if name]
            i += 1
    return mods


def drn_modules() -> ModuleMap:
    """DRN-D-54: ``layer0.0/.1``; conv stages ``layer{L}.0/.1`` <->
    ``layer{L}/conv0, bn0``; bottleneck stages as the ResNet's."""
    mods: ModuleMap = [("layer0.0", ("layer0_conv",)),
                       ("layer0.1", ("layer0_bn",))]
    for L in (1, 2, 7, 8):
        mods += [(f"layer{L}.0", (f"layer{L}", "conv0")),
                 (f"layer{L}.1", (f"layer{L}", "bn0"))]
    for L, n in ((3, 3), (4, 4), (5, 6), (6, 3)):
        for i in range(n):
            mods += _bottleneck_modules(f"layer{L}.{i}", (f"layer{L}_{i}",),
                                        i == 0)
    return mods


BACKBONE_MODULES = {"resnet": resnet_modules, "xception": xception_modules,
                    "mobilenet": mobilenet_modules, "drn": drn_modules}

DEEPLAB_HEAD_MODULES: ModuleMap = [
    *[(f"aspp.aspp{i}.{t}", ("aspp", f"aspp{i}", j))
      for i in (1, 2, 3, 4) for t, j in (("atrous_conv", "conv"),
                                         ("bn", "bn"))],
    ("aspp.global_avg_pool.1", ("aspp", "gap_conv")),
    ("aspp.global_avg_pool.2", ("aspp", "gap_bn")),
    ("aspp.conv1", ("aspp", "proj")),
    ("aspp.bn1", ("aspp", "proj_bn")),
    ("decoder.conv1", ("decoder", "ll_conv")),
    ("decoder.bn1", ("decoder", "ll_bn")),
    ("decoder.last_conv.0", ("decoder", "conv1")),
    ("decoder.last_conv.1", ("decoder", "bn1")),
    ("decoder.last_conv.4", ("decoder", "conv2")),
    ("decoder.last_conv.5", ("decoder", "bn2")),
    ("decoder.last_conv.8", ("decoder", "head")),
]


def unet_modules(cfg: Config) -> ModuleMap:
    """U-Net and ResUNet: the port's names (``models/unet.py``) <-> flax's
    automatic ones (``Conv_{k}``, ``BatchNorm_{k}`` / ``GroupNorm_{k}`` /
    ``LayerNorm_{k}`` by ``norm_type``, ``ConvTranspose_0`` or ``Conv_0``
    for the decoder's ``up``, ``UNetConvBlock_0`` / ``UNetResBlock_0``)."""
    norm = FLAX_NORM_NAMES[cfg.norm_type]
    res = cfg.arch == "resunet"

    def block(t: str, j: Tuple[str, ...], inplanes: int, features: int):
        mods = []
        for k in (0, 1):
            mods += [(f"{t}.conv{k}", j + (f"Conv_{k}",)),
                     (f"{t}.norm{k}", j + (f"{norm}_{k}",))]
        if res and inplanes != features:
            mods.append((f"{t}.shortcut_proj", j + ("shortcut_proj",)))
        return mods

    mods: ModuleMap = []
    prev = cfg.ch
    for i in range(cfg.unet_depth):
        mods += block(f"enc{i}", (f"enc{i}",), prev, 2 ** (cfg.unet_wf + i))
        prev = 2 ** (cfg.unet_wf + i)
    up = "ConvTranspose_0" if cfg.up_mode == "upconv" else "Conv_0"
    inner = "UNetResBlock_0" if res else "UNetConvBlock_0"
    for i, j in enumerate(reversed(range(cfg.unet_depth - 1))):
        features = 2 ** (cfg.unet_wf + j)
        mods.append((f"dec{i}.up", (f"dec{i}", up)))
        mods += block(f"dec{i}.block", (f"dec{i}", inner), 2 * features,
                      features)
    mods.append(("head", ("head",)))
    return mods


def module_map(cfg: Config) -> ModuleMap:
    """[(the port's state_dict prefix, the flax module's path)] for every
    module with parameters of the model ``cfg`` configures."""
    if cfg.arch in ("unet", "resunet"):
        return unet_modules(cfg)
    if cfg.arch != "deeplab":
        raise ValueError(f"Model '{cfg.arch}' not available. "
                         f"Options: {cfg.arch_options}")
    if cfg.backbone not in BACKBONE_MODULES:
        raise ValueError(f"Unknown backbone '{cfg.backbone}'")
    return [("backbone." + t, ("backbone",) + j)
            for t, j in BACKBONE_MODULES[cfg.backbone]()] \
        + DEEPLAB_HEAD_MODULES


def _at(tree: Mapping, path: Tuple[str, ...]) -> Mapping:
    """The subtree at ``path``, or {} (a model without BatchNorm has no
    ``batch_stats``)."""
    for name in path:
        tree = tree.get(name, {}) if isinstance(tree, Mapping) else {}
    return tree


def _is_transposed(path: Tuple[str, ...]) -> bool:
    return path[-1].startswith("ConvTranspose")


def _tensor(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a))


def _kernel_from_jax(k: np.ndarray, path: Tuple[str, ...]) -> np.ndarray:
    """A flax kernel (HWIO) -> the torch weight's layout."""
    if _is_transposed(path):
        # flax's ConvTranspose does not flip its kernel
        # (transpose_kernel=False); torch's ConvTranspose2d is a
        # convolution's gradient and does: HWIO -> [I, O, H, W] with both
        # spatial axes mirrored
        return np.ascontiguousarray(k[::-1, ::-1].transpose(2, 3, 0, 1))
    return k.transpose(3, 2, 0, 1)  # HWIO -> OIHW, depthwise too


def _kernel_to_jax(w: np.ndarray, path: Tuple[str, ...]) -> np.ndarray:
    """``_kernel_from_jax`` backwards."""
    if _is_transposed(path):
        return w.transpose(2, 3, 0, 1)[::-1, ::-1]
    return w.transpose(2, 3, 1, 0)  # OIHW -> HWIO


def _state_dict(mods: ModuleMap, params: Mapping, stats: Mapping
                ) -> "OrderedDict[str, torch.Tensor]":
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    for t, j in mods:
        p = _at(params, j)
        if not p:
            raise KeyError(f"no parameters at {'/'.join(j)} (for {t})")
        if "kernel" in p:
            sd[t + ".weight"] = _tensor(_kernel_from_jax(
                np.asarray(p["kernel"]), j))
            if "bias" in p:
                sd[t + ".bias"] = _tensor(p["bias"])
            continue
        sd[t + ".weight"] = _tensor(p["scale"])
        sd[t + ".bias"] = _tensor(p["bias"])
        s = _at(stats, j)
        if s:
            sd[t + ".running_mean"] = _tensor(s["mean"])
            sd[t + ".running_var"] = _tensor(s["var"])
    return sd


def resnet_state_dict(bp: Mapping, bs: Mapping, prefix: str = ""
                      ) -> "OrderedDict[str, torch.Tensor]":
    """JAX ResNet101 trees -> the port's ResNet101 state_dict keys
    (under ``prefix``); the block counts are the trees' own."""
    layers = [sum(1 for k in bp if k.startswith(f"layer{L}_"))
              for L in (1, 2, 3)]
    return _state_dict([(prefix + t, j) for t, j in resnet_modules(layers)],
                       bp, bs)


def state_dict_from_jax(params: Mapping, batch_stats: Mapping,
                        cfg: Optional[Config] = None
                        ) -> "OrderedDict[str, torch.Tensor]":
    """The JAX package's trees of the model ``cfg`` configures (nested
    dicts of numpy arrays; default: DeepLab/ResNet101) -> the port's
    state_dict.  ``batch_stats`` is empty for instance and layer norms."""
    return _state_dict(module_map(cfg or Config()), params, batch_stats)


def jax_trees_from_state_dict(sd: Mapping[str, torch.Tensor], cfg: Config
                              ) -> Tuple[Dict, Dict]:
    """The port's state_dict -> the JAX package's (params, batch_stats)
    as nested dicts of numpy arrays: ``state_dict_from_jax`` backwards.
    Every key but BatchNorm's ``num_batches_tracked`` must find its
    place."""
    params: Dict = {}
    stats: Dict = {}
    used = set()

    def take(key: str) -> np.ndarray:
        used.add(key)
        return sd[key].detach().cpu().float().numpy()

    def put(tree: Dict, path: Tuple[str, ...], leaf: str, value: np.ndarray):
        for name in path:
            tree = tree.setdefault(name, {})
        tree[leaf] = np.array(value, order="C")  # a copy: no view of sd

    for t, j in module_map(cfg):
        w = take(t + ".weight")
        if w.ndim == 4:
            put(params, j, "kernel", _kernel_to_jax(w, j))
            if t + ".bias" in sd:
                put(params, j, "bias", take(t + ".bias"))
            continue
        put(params, j, "scale", w)
        put(params, j, "bias", take(t + ".bias"))
        if t + ".running_mean" in sd:
            put(stats, j, "mean", take(t + ".running_mean"))
            put(stats, j, "var", take(t + ".running_var"))
    left = [k for k in sd if k not in used
            and not k.endswith("num_batches_tracked")]
    if left:
        raise KeyError(f"state_dict keys with no place in the "
                       f"{cfg.arch} trees: {left[:5]}")
    return params, stats


# --------------------------------------------------------------------- #
# the optimizer state
# --------------------------------------------------------------------- #

# optax's moment trees -> the torch optimizer's per-parameter state
OPT_MOMENTS = {"adam": (("mu", "exp_avg"), ("nu", "exp_avg_sq")),
               "sgd": (("trace", "momentum_buffer"),)}
OPT_LABELS = ("backbone", "head")  # optax.multi_transform's, by top key


def _param_places(model: nn.Module, cfg: Config
                  ) -> List[Tuple[str, Tuple[str, ...], str]]:
    """(parameter name, flax module path, leaf) for every parameter of
    ``model``, in ``module_map``'s order; a ``weight`` is a ``kernel``
    (4-D) or a normalizer's ``scale``."""
    named = dict(model.named_parameters())
    places = []
    for t, j in module_map(cfg):
        w = named[t + ".weight"]
        places.append((t + ".weight", j, "kernel" if w.ndim == 4 else "scale"))
        if t + ".bias" in named:
            places.append((t + ".bias", j, "bias"))
    left = set(named) - {n for n, _, _ in places}
    if left:
        raise KeyError(f"parameters with no place in the {cfg.arch} trees: "
                       f"{sorted(left)[:5]}")
    return places


def _label(top: str) -> str:
    """The JAX ``make_optimizer``'s label of a params subtree."""
    return "backbone" if top == "backbone" else "head"


def _chains(opt_state: Mapping, cfg: Config) -> Dict[str, Mapping]:
    """{label: the state of that label's optimizer chain}; one label,
    'head', without ``head_lr_mult``'s split.  A chain is adam's {0:
    {count, mu, nu}, 1: {}, 2: {count}} or sgd's {0: {trace}, 1:
    {count}} (scale_by_adam or trace, weight decay, the schedule)."""
    if cfg.optim_type not in OPT_MOMENTS:
        raise ValueError(f"Optimizer '{cfg.optim_type}' is not defined.")
    try:
        chain = opt_state["1"]
        chains = {"head": chain} if cfg.head_lr_mult == 1.0 else {
            g: chain["inner_states"][g]["inner_state"] for g in OPT_LABELS}
        for c in chains.values():
            _counts(c, cfg.optim_type)
            for jk, _ in OPT_MOMENTS[cfg.optim_type]:
                c["0"][jk]
    except (KeyError, TypeError) as e:
        raise ValueError(
            f"the optimizer state is not that of optim_type="
            f"{cfg.optim_type!r}, head_lr_mult={cfg.head_lr_mult} "
            f"(missing {e})") from e
    return chains


def _counts(chain: Mapping, optim_type: str) -> Tuple[Optional[int], int]:
    """(AdamW's update count or None for SGD, the schedule's count)."""
    if optim_type == "adam":
        return int(chain["0"]["count"]), int(chain["2"]["count"])
    return None, int(chain["1"]["count"])


def optimizer_from_jax(opt_state: Mapping, cfg: Config, model: nn.Module,
                       optimizer: torch.optim.Optimizer,
                       scheduler: torch.optim.lr_scheduler.LambdaLR) -> int:
    """Load optax's state of ``make_optimizer(cfg)`` (numpy leaves) into
    ``optimizer`` and ``scheduler``, made by ``train_state.make_optimizer``
    for ``model``, in place: every parameter's moments, AdamW's step, and
    the schedule's position (each group's lr its value there).  Returns
    the schedule's count, the number of updates so far."""
    chains = _chains(opt_state, cfg)
    updates = {_counts(c, cfg.optim_type)[1] for c in chains.values()}
    if len(updates) != 1:
        raise ValueError(f"the labels' schedule counts differ: {updates}")
    count = updates.pop()
    index = {id(p): i for i, p in enumerate(
        p for g in optimizer.param_groups for p in g["params"])}
    named = dict(model.named_parameters())
    state: Dict[int, Dict[str, torch.Tensor]] = {}
    for name, path, leaf in _param_places(model, cfg):
        chain = chains["head" if cfg.head_lr_mult == 1.0
                       else _label(path[0])]
        p = named[name]
        st = {}
        for jk, tk in OPT_MOMENTS[cfg.optim_type]:
            a = np.asarray(_at(chain["0"][jk], path)[leaf])
            # in the parameter's memory format, as torch's own state
            st[tk] = torch.empty_like(p, device="cpu").copy_(_tensor(
                _kernel_from_jax(a, path) if leaf == "kernel" else a))
        adam_count = _counts(chain, cfg.optim_type)[0]
        if adam_count is not None:
            st["step"] = torch.tensor(float(adam_count))
        state[index[id(p)]] = st
    osd = optimizer.state_dict()
    ssd = scheduler.state_dict()
    lrs = [base * fn(count) for base, fn in zip(scheduler.base_lrs,
                                                scheduler.lr_lambdas)]
    for group, lr in zip(osd["param_groups"], lrs):
        group["lr"] = lr
    osd["state"] = state
    ssd.update(last_epoch=count, _step_count=count + 1, _last_lr=lrs)
    optimizer.load_state_dict(osd)
    scheduler.load_state_dict(ssd)
    return count


def optimizer_to_jax(cfg: Config, model: nn.Module,
                     optimizer: torch.optim.Optimizer,
                     scheduler: torch.optim.lr_scheduler.LambdaLR) -> Dict:
    """``optimizer_from_jax`` backwards: the state optax's
    ``make_optimizer(cfg).init`` builds, filled from ``optimizer`` and
    ``scheduler`` (moments as float32 numpy arrays, counts as int32
    0-d arrays, ``{}`` for the empty states and the other label's
    subtrees).  A parameter with no state yet (no update) has zero
    moments; a label with no parameter (the backbone of a model without
    one) takes the schedule's count, as optax counts every label's
    updates."""
    count = int(scheduler.last_epoch)
    places = _param_places(model, cfg)
    named = dict(model.named_parameters())
    labels = ("head",) if cfg.head_lr_mult == 1.0 else OPT_LABELS
    tops = list(dict.fromkeys(path[0] for _, path, _ in places))
    trees = {g: {jk: {t: {} for t in tops}
                 for jk, _ in OPT_MOMENTS[cfg.optim_type]} for g in labels}
    steps: Dict[str, set] = {g: set() for g in labels}
    for name, path, leaf in places:
        g = labels[0] if len(labels) == 1 else _label(path[0])
        p = named[name]
        st = optimizer.state.get(p, {})
        for jk, tk in OPT_MOMENTS[cfg.optim_type]:
            t = st.get(tk)
            a = np.zeros(tuple(p.shape), np.float32) if t is None else \
                t.detach().cpu().float().numpy()
            if leaf == "kernel":
                a = _kernel_to_jax(a, path)
            node = trees[g][jk]
            for key in path:
                node = node.setdefault(key, {})
            node[leaf] = np.array(a, order="C")  # no view of the state
        if "step" in st:
            steps[g].add(int(st["step"]))
    for g, seen in steps.items():
        if len(seen) > 1:
            raise ValueError(f"the {g} parameters' AdamW steps differ: "
                             f"{sorted(seen)}")

    def i32(n: int) -> np.ndarray:
        return np.asarray(n, np.int32)

    def chain(g: str) -> Dict:
        if cfg.optim_type == "sgd":
            return {"0": {"trace": trees[g]["trace"]},
                    "1": {"count": i32(count)}}
        has_params = any(trees[g]["mu"][t] for t in tops)
        adam = min(steps[g], default=0 if has_params else count)
        return {"0": {"count": i32(adam), "mu": trees[g]["mu"],
                      "nu": trees[g]["nu"]},
                "1": {}, "2": {"count": i32(count)}}

    if cfg.head_lr_mult == 1.0:
        return {"0": {}, "1": chain("head")}
    return {"0": {}, "1": {"inner_states": {
        g: {"inner_state": chain(g)} for g in OPT_LABELS}}}


# --------------------------------------------------------------------- #
# ImageNet encoders
# --------------------------------------------------------------------- #

def _encoder_state_dict(pth_path: str) -> Dict[str, torch.Tensor]:
    """The state_dict in an encoder pickle (bare, or under
    'state_dict'); {} for anything else, which the callers refuse."""
    data = load_reference_pth(pth_path)
    if not isinstance(data, dict):
        return {}
    sd = data.get("state_dict", data)
    return sd if isinstance(sd, dict) else {}


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


def expand_zoo_xception_state_dict(sd: Mapping[str, torch.Tensor]
                                   ) -> Dict[str, torch.Tensor]:
    """Model-zoo ``xception-b5690688`` keys -> Aligned Xception keys: the
    zoo's middle block11 also fills blocks 12-19, block12 becomes the exit
    block20, bn3 also fills bn4, conv4/bn4 become conv5/bn5, and 2-D
    pointwise weights grow to [O, I, 1, 1]."""
    out: Dict[str, torch.Tensor] = {}
    for k, v in sd.items():
        if k.startswith("fc."):
            continue
        if "pointwise" in k and v.ndim == 2:
            v = v.unsqueeze(-1).unsqueeze(-1)
        if k.startswith("block11"):
            out[k] = v
            for n in range(12, 20):
                out[k.replace("block11", f"block{n}")] = v
        elif k.startswith("block12"):
            out[k.replace("block12", "block20")] = v
        elif k.startswith("bn3"):
            out[k] = v
            out[k.replace("bn3", "bn4")] = v
        elif k.startswith("conv4"):
            out[k.replace("conv4", "conv5")] = v
        elif k.startswith("bn4"):
            out[k.replace("bn4", "bn5")] = v
        else:
            out[k] = v
    return out


def _renumber_xception_reps(sd: Mapping[str, torch.Tensor]
                            ) -> Dict[str, torch.Tensor]:
    """Within each block, the j-th separable conv found under ``rep`` (in
    index order) goes to the aligned block's separable j and the j-th
    norm to its norm j, as the JAX loader counts them."""
    pat = re.compile(r"block(\d+)\.rep\.(\d+)\.(.*)")
    by_block: Dict[int, Dict[int, Dict[str, torch.Tensor]]] = {}
    out: Dict[str, torch.Tensor] = {}
    for k, v in sd.items():
        m = pat.fullmatch(k)
        if m:
            by_block.setdefault(int(m.group(1)), {}).setdefault(
                int(m.group(2)), {})[m.group(3)] = v
        else:
            out[k] = v
    for n, reps in by_block.items():
        base = 0 if n <= 2 else 1
        n_sep = n_bn = 0
        for i in sorted(reps):
            if "pointwise.weight" in reps[i]:
                at = 3 * n_sep + base
                n_sep += 1
            elif "running_mean" in reps[i]:
                at = 3 * n_bn + base + 1
                n_bn += 1
            else:
                continue
            for leaf, v in reps[i].items():
                out[f"block{n}.rep.{at}.{leaf}"] = v
    return out


def load_xception_imagenet(pth_path: str, model: nn.Module,
                           verbose: bool = False) -> nn.Module:
    """Overlay a zoo-format ``xception-b5690688.pth`` onto
    ``model.backbone`` in place.

    The zoo checkpoint covers only part of the aligned architecture (its
    separable convs have no inner norm, the aligned conv4 has no source),
    so the overlay is partial: tensors that are present and of the
    target's shape are copied, the rest keep their initialization.  Raises
    if no weight at all maps: a wrong file must not train from scratch
    silently."""
    sd = _encoder_state_dict(pth_path)
    sd = _renumber_xception_reps(expand_zoo_xception_state_dict(sd))
    target = model.backbone.state_dict()
    n_weights = n_stats = 0
    with torch.no_grad():
        for k, v in sd.items():
            if k.endswith("num_batches_tracked"):
                continue
            if k not in target or tuple(target[k].shape) != tuple(v.shape):
                if verbose:
                    print(f"  skip {k} (shape {tuple(v.shape)})")
                continue
            target[k].copy_(v)
            if k.endswith(("running_mean", "running_var")):
                n_stats += 1
            else:
                n_weights += 1
    if n_weights == 0:
        raise ValueError(
            f"{pth_path}: no xception backbone weights mapped — not a "
            "zoo xception state_dict?")
    if verbose:
        print(f"  xception pretrained: {n_weights} weight + {n_stats} "
              "statistic tensors")
    return model


def _load_named_encoder(pth_path: str, model: nn.Module, mods: ModuleMap,
                        what: str) -> nn.Module:
    """Copy the encoder's tensors for every module of ``mods`` into
    ``model.backbone``; a missing key or a wrong shape raises.  Keys
    outside ``mods`` (a classifier head) are not read."""
    sd = _encoder_state_dict(pth_path)
    target = model.backbone.state_dict()
    with torch.no_grad():
        for t, _ in mods:
            for k in (k for k in target if k.startswith(t + ".")
                      and not k.endswith("num_batches_tracked")):
                if k not in sd:
                    raise ValueError(f"{pth_path}: missing key '{k}' — not "
                                     f"a {what} state_dict?")
                if tuple(sd[k].shape) != tuple(target[k].shape):
                    raise ValueError(
                        f"Shape mismatch at {k}: {tuple(target[k].shape)} "
                        f"vs {tuple(sd[k].shape)}")
                target[k].copy_(sd[k])
    return model


def load_mobilenet_imagenet(pth_path: str, model: nn.Module) -> nn.Module:
    """Load an ImageNet MobileNetV2 (``mobilenet_v2-6a65762b.pth``, keys
    ``features.{i}.conv.{k}``) into ``model.backbone`` in place; the
    ``classifier.*`` head is not read."""
    return _load_named_encoder(pth_path, model, mobilenet_modules(),
                               "MobileNetV2")


def load_drn_imagenet(pth_path: str, model: nn.Module) -> nn.Module:
    """Load an ImageNet DRN-D-54 (``drn_d_54-0e0534ff.pth``) into
    ``model.backbone`` in place; the ``fc.*`` head is not read."""
    return _load_named_encoder(pth_path, model, drn_modules(), "DRN-D")


IMAGENET_LOADERS = {"resnet": load_resnet101_imagenet,
                    "xception": load_xception_imagenet,
                    "mobilenet": load_mobilenet_imagenet,
                    "drn": load_drn_imagenet}


# --------------------------------------------------------------------- #
# model files
# --------------------------------------------------------------------- #

def load_pth_model(model_path: str, base_cfg: Optional[Config] = None
                   ) -> Tuple[Config, nn.Module]:
    """Load a ``.pth`` ({'model': state_dict, 'meta': ...}) -> (cfg, model
    on the CPU): a reference-schema DeepLab (ResNet101 or Xception), or a
    best model the port's trainer wrote, of any architecture, under the
    port's own names.

    The checkpoint's meta rehydrates the config (arch, backbone, ch,
    schema, normalization stats), as ``pylc_tpu.convert.load_pth_model``
    does; what the meta does not carry (``norm_type``, ``up_mode``, the
    U-Net's depth) comes from ``base_cfg``."""
    data = load_reference_pth(model_path)
    if "model" not in data:
        raise ValueError(f"{model_path}: no 'model' state_dict")
    meta_obj = data.get("meta")
    meta: Dict = dict(meta_obj.__dict__) if hasattr(meta_obj, "__dict__") \
        else (meta_obj or {})
    cfg = Config.from_meta(meta, base=base_cfg)
    model = build_model(cfg)
    model.load_state_dict(data["model"], strict=True)
    return cfg, model


CKPT_ARRAY_EXT = 1  # flax's msgpack extension type of an ndarray


def require_msgpack():
    """The ``msgpack`` module, or an ImportError that names it."""
    try:
        import msgpack
    except ImportError as e:
        raise ImportError(
            "reading or writing the JAX package's .ckpt needs the "
            "'msgpack' package, which is not installed") from e
    return msgpack


def _read_ckpt_trees(path: str, keys: Sequence[str] = ("params",)
                     ) -> Dict[str, Any]:
    """flax's ``serialization.to_bytes`` without flax: plain msgpack whose
    arrays are extension type 1, each msgpack of (shape, dtype name,
    bytes).  The top level must hold ``keys``."""
    msgpack = require_msgpack()

    def ext_hook(code, data):
        if code != CKPT_ARRAY_EXT:
            raise ValueError(f"{path}: msgpack extension type {code}; only "
                             "arrays are expected in a model file")
        shape, dtype, buf = msgpack.unpackb(data, raw=False)
        return np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape)

    with open(path, "rb") as f:
        blob = f.read()
    try:
        tree = msgpack.unpackb(blob, ext_hook=ext_hook, raw=False,
                               strict_map_key=False)
    except Exception as e:
        raise ValueError(f"{path}: not a msgpack model file ({e})") from e
    missing = [k for k in keys if not isinstance(tree, dict) or k not in tree]
    if missing:
        what = "checkpoint" if "opt_state" in keys else "best-model"
        raise ValueError(f"{path}: no {missing[0]!r} tree: not a {what} "
                         ".ckpt")
    return tree


def _sized(codes: Tuple[int, int, int], n: int) -> bytes:
    """A msgpack header of length ``n``: ``codes`` are the markers of its
    8-, 16- and 32-bit length forms (bin: 0xc4-0xc6, ext: 0xc7-0xc9)."""
    for code, fmt, top in zip(codes, (">B", ">H", ">I"),
                              (0xff, 0xffff, 0xffffffff)):
        if n <= top:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"{n} bytes do not fit one msgpack object")


def _write_ckpt(path: str, payload: Mapping, cfg: Config):
    """``payload`` as flax's msgpack (numpy arrays as extension type 1,
    each the msgpack of (shape, dtype name, bytes)), streamed into the
    file piece by piece with each array's bytes written from the array
    itself, and ``cfg``'s meta beside it, each written atomically.  The
    payload is nested dicts of str keys, numpy arrays and Python ints."""
    packer = require_msgpack().Packer(use_bin_type=True)

    def write(f, x):
        if isinstance(x, dict):
            f.write(packer.pack_map_header(len(x)))
            for k, v in x.items():
                f.write(packer.pack(str(k)))
                write(f, v)
        elif isinstance(x, np.ndarray):
            x = np.asarray(x, order="C")  # keeps a 0-d array 0-d
            head = (packer.pack_array_header(3) + packer.pack(list(x.shape))
                    + packer.pack(x.dtype.name)
                    + _sized((0xc4, 0xc5, 0xc6), x.nbytes))
            f.write(_sized((0xc7, 0xc8, 0xc9), len(head) + x.nbytes)
                    + bytes([CKPT_ARRAY_EXT]) + head)
            f.write(x.reshape(-1).view(np.uint8))
        elif type(x) is int:
            f.write(packer.pack(x))
        else:
            raise TypeError(f"cannot pack {type(x).__name__}")

    with open(path + ".tmp", "wb") as f:
        write(f, payload)
    os.replace(path + ".tmp", path)
    with open(path + ".meta.tmp", "w") as f:
        f.write(cfg.to_meta_json())
    os.replace(path + ".meta.tmp", path + ".meta")


def _read_meta(path: str) -> Optional[Dict]:
    if not os.path.exists(path + ".meta"):
        return None
    with open(path + ".meta") as f:
        return json.load(f)


def load_ckpt_model(path: str, base_cfg: Optional[Config] = None
                    ) -> Tuple[Config, nn.Module]:
    """Load the JAX package's best-model ``.ckpt`` ({params, batch_stats}
    beside a ``.meta`` JSON) -> (cfg, model on the CPU).

    The meta rehydrates the config over ``base_cfg``, which supplies what
    the meta does not carry (``norm_type``, ``up_mode``, ``activ_type``,
    the U-Net's depth and width).  A resumable ``checkpoint.ckpt``, with
    the optimizer state, goes through ``load_ckpt_checkpoint``."""
    cfg = base_cfg or Config()
    meta = _read_meta(path)
    if meta is not None:
        cfg = Config.from_meta(meta, base=cfg)
    tree = _read_ckpt_trees(path)
    model = build_model(cfg)
    model.load_state_dict(
        state_dict_from_jax(tree["params"], tree.get("batch_stats") or {},
                            cfg), strict=True)
    return cfg, model


def save_ckpt_model(model: nn.Module, cfg: Config, path: str) -> str:
    """Write ``model`` as a best-model ``.ckpt`` with its ``.meta``, which
    ``pylc_tpu.checkpoint.load_model_file`` and the JAX package's ``test``
    read.  No optimizer state (``save_ckpt_checkpoint`` writes one)."""
    require_msgpack()  # before the trees: without it nothing is written
    params, stats = jax_trees_from_state_dict(model.state_dict(), cfg)
    _write_ckpt(path, {"params": params, "batch_stats": stats}, cfg)
    return path


def checkpoint_from_jax(payload: Mapping, cfg: Config, model: nn.Module,
                        optimizer: torch.optim.Optimizer,
                        scheduler: torch.optim.lr_scheduler.LambdaLR
                        ) -> Tuple[int, int]:
    """The JAX package's resumable payload ({epoch, iter, params,
    batch_stats, opt_state} as numpy trees: ``pylc_tpu.checkpoint``'s)
    into ``model``, ``optimizer`` and ``scheduler`` (built for ``cfg`` by
    ``init_model`` and ``make_optimizer``) in place, on whatever device
    they are.  BatchNorm's ``num_batches_tracked``, which flax does not
    keep, becomes ``iter``.  Returns (epoch, iter)."""
    iteration = int(payload["iter"])
    sd = state_dict_from_jax(payload["params"],
                             payload.get("batch_stats") or {}, cfg)
    for k in model.state_dict():
        if k.endswith("num_batches_tracked"):
            sd[k] = torch.tensor(iteration)
    model.load_state_dict(sd, strict=True)
    count = optimizer_from_jax(payload["opt_state"], cfg, model, optimizer,
                               scheduler)
    if count != iteration:
        raise ValueError(f"iter {iteration}, but the optimizer state counts "
                         f"{count} updates")
    return int(payload["epoch"]), iteration


def checkpoint_to_jax(cfg: Config, model: nn.Module,
                      optimizer: torch.optim.Optimizer,
                      scheduler: torch.optim.lr_scheduler.LambdaLR,
                      epoch: int, iteration: int) -> Dict[str, Any]:
    """``checkpoint_from_jax`` backwards: the payload the JAX package's
    ``Checkpoint.save`` writes."""
    params, stats = jax_trees_from_state_dict(model.state_dict(), cfg)
    return {"epoch": int(epoch), "iter": int(iteration), "params": params,
            "batch_stats": stats,
            "opt_state": optimizer_to_jax(cfg, model, optimizer, scheduler)}


def load_ckpt_checkpoint(path: str, cfg: Config, model: nn.Module,
                         optimizer: torch.optim.Optimizer,
                         scheduler: torch.optim.lr_scheduler.LambdaLR
                         ) -> Dict[str, Any]:
    """Restore the JAX package's resumable ``checkpoint.ckpt`` into
    ``model``, ``optimizer`` and ``scheduler`` (``checkpoint_from_jax``).
    Returns {'epoch', 'iter', 'meta'}; the meta is the file's and is not
    applied (the JAX trainer's resume does not apply it either)."""
    tree = _read_ckpt_trees(path, ("epoch", "iter", "params", "opt_state"))
    try:
        epoch, iteration = checkpoint_from_jax(tree, cfg, model, optimizer,
                                               scheduler)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from e
    return {"epoch": epoch, "iter": iteration, "meta": _read_meta(path)}


def save_ckpt_checkpoint(path: str, cfg: Config, model: nn.Module,
                         optimizer: torch.optim.Optimizer,
                         scheduler: torch.optim.lr_scheduler.LambdaLR,
                         epoch: int, iteration: int) -> str:
    """Write a resumable ``checkpoint.ckpt`` with its ``.meta`` in the
    JAX package's layout, which ``pylc_tpu.checkpoint.Checkpoint.load``
    restores into a state of ``cfg`` and its trainer resumes."""
    require_msgpack()
    _write_ckpt(path, checkpoint_to_jax(cfg, model, optimizer, scheduler,
                                        epoch, iteration), cfg)
    return path
