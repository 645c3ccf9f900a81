"""Parity of the port's model zoo with the JAX package, in f32 on the CPU:
DeepLabV3+ on Xception, MobileNetV2 and DRN-D-54, the U-Net and the
ResUNet in both ``up_mode``s, and the instance and layer normalizers.

Per case the JAX weights are built once for the module (``init_state``),
every normalizer's scale, bias and statistics are redrawn from a numpy
seed (at their initial 1/0/0/1 a swapped pair would not show), and the
numpy trees reach the port through ``state_dict_from_jax``.  DeepLabs run
at full depth on 64 px tiles; the U-Nets at depth 3, width 2**3 and 64 px
(-> 24 px), where every max-pool sees an even size."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from pylc_tpu import convert as jconvert
from pylc_tpu.config import Config as JaxConfig
from pylc_tpu.models.registry import build_model as jax_build_model
from pylc_tpu.train_state import init_state
from pylc_tpu.train_state import make_train_step as jax_make_train_step
from pylc_tpu_torch import convert
from pylc_tpu_torch.config import Config
from pylc_tpu_torch.models.registry import build_model, model_input_channels
from pylc_tpu_torch.train_state import (
    init_model, make_optimizer, make_train_step, prepare_batch)

torch.set_num_threads(1)

TILE = 64
UNET = dict(arch="unet", unet_depth=3, unet_wf=3, input_size=TILE,
            output_size=24)
CASES = {
    "xception": dict(backbone="xception"),
    "mobilenet": dict(backbone="mobilenet"),
    "drn": dict(backbone="drn"),
    "mobilenet_instance": dict(backbone="mobilenet", norm_type="instance"),
    "mobilenet_layer_ch1": dict(backbone="mobilenet", norm_type="layer",
                                ch=1),
    "unet": dict(UNET),
    "unet_upconv": dict(UNET, up_mode="upconv"),
    "unet_instance_gelu_ch1": dict(UNET, norm_type="instance",
                                   activ_type="gelu", ch=1),
    "unet_layer_selu": dict(UNET, norm_type="layer", activ_type="selu"),
    "resunet": dict(UNET, arch="resunet"),
    "resunet_upconv_lrelu": dict(UNET, arch="resunet", up_mode="upconv",
                                 activ_type="lrelu"),
    "resunet_layer": dict(UNET, arch="resunet", norm_type="layer"),
    "resunet_instance_schema_b": dict(UNET, arch="resunet",
                                      norm_type="instance", n_classes=11),
}
NORM_RANGES = {"scale": (0.5, 1.5), "mean": (-0.5, 0.5), "var": (0.5, 1.5)}


def _cfgs(name):
    kw = dict(CASES[name], tile_size=TILE, compute_dtype="float32")
    return JaxConfig().replace(**kw), Config().replace(**kw)


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


def _redraw_norms(tree, rng, conv_bias=True):
    """Every normalizer's scale, bias and statistics from ``rng``, and
    with ``conv_bias`` a conv's bias too (flax starts it at 0)."""
    for k, v in tree.items():
        if isinstance(v, dict):
            _redraw_norms(v, rng, conv_bias)
        elif k in NORM_RANGES or (k == "bias"
                                  and (conv_bias or "kernel" not in tree)):
            lo, hi = NORM_RANGES.get(k, (-0.2, 0.2))
            tree[k] = rng.uniform(lo, hi, v.shape).astype(np.float32)
    return tree


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def _assert_logits_close(got, want):
    """The tolerance of tests/test_torch_models.py."""
    assert got.shape == want.shape
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=1e-3,
                               atol=max(5e-4, 1e-5 * scale))
    agree = np.mean(got.argmax(-1) == want.argmax(-1))
    assert agree >= 0.999, f"argmax agreement {agree}"


@pytest.fixture(scope="module", params=sorted(CASES))
def zoo(request):
    """(name, JAX cfg, port cfg, params, batch_stats, the port's model in
    eval mode) of one case."""
    jcfg, cfg = _cfgs(request.param)
    state, _ = init_state(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(sorted(CASES).index(request.param))
    params = _redraw_norms(_np_tree(state.params), rng)
    stats = _redraw_norms(_np_tree(state.batch_stats), rng)
    model = build_model(cfg)
    model.load_state_dict(convert.state_dict_from_jax(params, stats, cfg),
                          strict=True)
    return request.param, jcfg, cfg, params, stats, model.eval()


def test_state_dict_covers_the_model(zoo):
    """Every tensor of the port's model but BatchNorm's step counters
    comes from the JAX trees, and every leaf of the trees is used."""
    _, _, cfg, params, stats, model = zoo
    sd = convert.state_dict_from_jax(params, stats, cfg)
    want = [k for k in model.state_dict()
            if not k.endswith("num_batches_tracked")]
    assert sorted(sd) == sorted(want)
    n_leaves = sum(1 for _ in _leaves(params)) + sum(1 for _ in
                                                     _leaves(stats))
    assert len(sd) == n_leaves
    if cfg.norm_type in ("instance", "layer"):
        assert not stats and not any("running" in k for k in sd)


def test_eval_logits_match_jax(zoo):
    _, jcfg, cfg, params, stats, model = zoo
    C = model_input_channels(cfg)
    x = np.random.default_rng(1).standard_normal(
        (2, TILE, TILE, C)).astype(np.float32)
    want = np.asarray(jax_build_model(jcfg, train=False).apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(x),
        train=False))
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert got.dtype == torch.float32
    out = 24 if cfg.arch != "deeplab" else TILE
    assert got.shape == (2, cfg.n_classes, out, out)
    _assert_logits_close(got.permute(0, 2, 3, 1).numpy(), want)


def test_state_dict_goes_back_to_the_jax_trees(zoo):
    """``jax_trees_from_state_dict`` undoes ``state_dict_from_jax`` bit
    for bit, from the model's own state_dict (step counters and all)."""
    _, _, cfg, params, stats, model = zoo
    got_p, got_s = convert.jax_trees_from_state_dict(model.state_dict(), cfg)
    for got, want in ((got_p, params), (got_s, stats)):
        got, want = dict(_leaves(got)), dict(_leaves(want))
        assert sorted(got) == sorted(want)
        for path in want:
            assert got[path].dtype == want[path].dtype, path
            np.testing.assert_array_equal(got[path], want[path],
                                          err_msg="/".join(path))


def test_xception_state_dict_matches_exporter(tmp_path):
    """Key for key and bit for bit the reference-schema file the JAX
    exporter writes, which then loads with ``strict=True``."""
    jcfg, cfg = _cfgs("xception")
    state, _ = init_state(jcfg, jax.random.PRNGKey(3))
    path = jconvert.export_deeplab_pth(state, jcfg, str(tmp_path / "x.pth"),
                                       backbone="xception")
    want = torch.load(path, weights_only=False)["model"]
    got = convert.state_dict_from_jax(_np_tree(state.params),
                                      _np_tree(state.batch_stats), cfg)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k
    cfg2, model = convert.load_pth_model(path)
    assert (cfg2.arch, cfg2.backbone, cfg2.tile_size) == ("deeplab",
                                                          "xception", TILE)
    assert torch.equal(model.state_dict()["backbone.block20.skip.weight"],
                       want["backbone.block20.skip.weight"])


@pytest.mark.parametrize("arch,up_mode", [("unet", "upsample"),
                                          ("unet", "upconv"),
                                          ("resunet", "upsample"),
                                          ("resunet", "upconv")])
def test_unet_geometry_512_to_324(arch, up_mode):
    """The full-size model on the meta device: no convolution runs."""
    cfg = Config().replace(arch=arch, up_mode=up_mode)
    with torch.device("meta"):
        model = build_model(cfg)
        out = model(torch.empty(1, 3, 512, 512))
    assert out.shape == (1, 9, 324, 324)
    assert cfg.crop_window == (94, 418)


@pytest.mark.parametrize("backbone,feat,low", [
    ("xception", (2048, 32, 32), (128, 128, 128)),
    ("mobilenet", (320, 32, 32), (24, 128, 128)),
    ("drn", (512, 64, 64), (256, 128, 128))])
def test_backbone_geometry_at_512(backbone, feat, low):
    cfg = Config().replace(backbone=backbone)
    with torch.device("meta"):
        model = build_model(cfg)
        x = torch.empty(1, 3, 512, 512)
        got_feat, got_low = model.backbone(x)
        assert model(x).shape == (1, 9, 512, 512)
    assert got_feat.shape[1:] == feat and got_low.shape[1:] == low
    dil = model.aspp.aspp4.atrous_conv.dilation
    assert dil == ((36, 36) if backbone == "drn" else (18, 18))


def test_mobilenet_takes_output_stride_8():
    """The running stride stops at 8 and later stages dilate by the
    accumulated rate, as ``pylc_tpu/models/mobilenet.py`` plans it."""
    from pylc_tpu_torch.models.mobilenet import MobileNetV2
    with torch.device("meta"):
        net = MobileNetV2(output_stride=8)
        feat, low = net(torch.empty(1, 3, 512, 512))
    assert feat.shape == (1, 320, 64, 64) and low.shape == (1, 24, 128, 128)
    # the first block of the 64, 96, 160 and 320 channel stages
    got = [net.features[i].conv[3].dilation[0] for i in (7, 11, 14, 17)]
    assert got == [1, 2, 2, 4]
    assert all(net.features[i].conv[3].stride == (1, 1)
               for i in (7, 11, 14, 17))
    with pytest.raises(NotImplementedError):
        MobileNetV2(output_stride=32)


def test_unknown_names_raise_as_in_jax():
    for kw, match in (({"backbone": "vgg"}, "Unknown backbone"),
                      ({"arch": "segnet"}, "not available"),
                      ({"norm_type": "group"}, "Unknown normalizer"),
                      ({"activ_type": "swish"}, "Unknown activation")):
        with pytest.raises(ValueError, match=match):
            jax_build_model(JaxConfig().replace(**kw), train=False).init(
                jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
                train=False)
        with pytest.raises(ValueError, match=match):
            build_model(Config().replace(**kw))


@pytest.mark.parametrize("argv,built", [
    (["--arch", "unet", "--up_mode", "upconv", "--normalize", "instance"],
     ("UNet", "ConvTranspose2d", "InstanceNorm2d")),
    (["--arch", "resunet", "--normalize", "layer", "--activation", "gelu"],
     ("ResUNet", "Conv2d", "ChannelLayerNorm")),
    (["--backbone", "drn"], ("DeepLab", "DRN54", "BatchNorm2d")),
    (["--backbone", "xception", "--normalize", "syncbatch"],
     ("DeepLab", "AlignedXception", "BatchNorm2d")),
])
def test_cli_flags_reach_the_model(argv, built):
    """``train --arch --backbone --normalize --activation --up_mode`` ->
    the config -> the module that is built."""
    from pylc_tpu_torch.cli import _cfg_from_args, get_parser
    cfg = _cfg_from_args(get_parser().parse_args(
        ["train", "--db", "x.h5", *argv]))
    with torch.device("meta"):
        model = build_model(cfg)
    if cfg.arch == "deeplab":
        got = (model.backbone, model.aspp.bn1)
    else:
        got = (model.dec0.up, model.enc0.norm0)
        if "gelu" in argv:
            assert model.enc0.act is build_model.__globals__[
                "get_activation"]("gelu")
    assert (type(model).__name__, *(type(m).__name__ for m in got)) == built


# --------------------------------------------------------------------- #
# ImageNet encoders
# --------------------------------------------------------------------- #

def _seeded_like(sd, rng, drop=()):
    return {k: torch.from_numpy(rng.standard_normal(tuple(v.shape)).astype(
        np.float32)) for k, v in sd.items()
        if not k.endswith("num_batches_tracked")
        and not any(d in k for d in drop)}


def _zoo_xception_state_dict(rng):
    """A model-zoo Xception state dict of seeded values: blocks 1-12 with
    no norm inside a separable conv, 2-D pointwise weights, conv3/bn3,
    conv4/bn4 (the aligned conv5/bn5), an ``fc`` head, and one tensor of
    a shape the aligned model does not have."""
    from pylc_tpu_torch.models.xception import AlignedXception
    aligned = _seeded_like(AlignedXception().state_dict(), rng)
    sd = {}
    for k, v in aligned.items():
        if ".bn." in k or k.startswith(("conv4", "bn4")):
            continue
        block = k.split(".")[0]
        if block.startswith("block"):
            n = int(block[5:])
            if 12 <= n <= 19:
                continue
            k = k.replace("block20.", "block12.")
        k = k.replace("conv5.", "conv4.").replace("bn5.", "bn4.")
        sd[k] = v[:, :, 0, 0].clone() if "pointwise" in k else v
    sd["fc.weight"] = torch.zeros(1000, 2048)
    sd["block2.skip.weight"] = torch.zeros(256, 64, 1, 1)  # aligned: 128 in
    return sd


ENCODERS = {
    "xception": ("load_xception_imagenet", _zoo_xception_state_dict),
    "mobilenet": ("load_mobilenet_imagenet", lambda rng: dict(
        _seeded_like(build_model(Config().replace(
            backbone="mobilenet")).backbone.state_dict(), rng),
        **{"classifier.1.weight": torch.zeros(1000, 1280)})),
    "drn": ("load_drn_imagenet", lambda rng: dict(
        _seeded_like(build_model(Config().replace(
            backbone="drn")).backbone.state_dict(), rng),
        **{"fc.weight": torch.zeros(1000, 512, 1, 1)})),
}


@pytest.mark.parametrize("backbone,wrapped", [
    ("xception", False), ("mobilenet", True), ("drn", False)],
    ids=["xception-bare", "mobilenet-under_state_dict", "drn-bare"])
def test_imagenet_loader_matches_jax(backbone, wrapped, tmp_path):
    """A seeded encoder file of the right names and shapes through both
    packages' loaders, from the same DeepLab weights: the same model."""
    loader, make = ENCODERS[backbone]
    jcfg, cfg = _cfgs(backbone)
    sd = make(np.random.default_rng(5))
    pth = str(tmp_path / "encoder.pth")
    torch.save({"state_dict": sd} if wrapped else sd, pth)
    state, _ = init_state(jcfg, jax.random.PRNGKey(2))
    model = build_model(cfg)
    model.load_state_dict(convert.state_dict_from_jax(
        _np_tree(state.params), _np_tree(state.batch_stats), cfg))
    before = {k: v.clone() for k, v in model.state_dict().items()}

    new_state = getattr(jconvert, loader)(pth, state)
    assert getattr(convert, loader)(pth, model) is model
    want = convert.state_dict_from_jax(_np_tree(new_state.params),
                                       _np_tree(new_state.batch_stats), cfg)
    got = model.state_dict()
    changed = 0
    for k in want:
        assert torch.equal(got[k], want[k]), k
        changed += not torch.equal(got[k], before[k])
        if not k.startswith("backbone."):
            assert torch.equal(got[k], before[k]), k
    assert changed > 100
    if backbone == "xception":
        # no source in the zoo file: a separable conv's inner norm, conv4
        for k in ("backbone.block1.rep.0.bn.weight",
                  "backbone.conv4.pointwise.weight",
                  "backbone.block2.skip.weight"):
            assert torch.equal(got[k], before[k]), k
        assert torch.equal(got["backbone.block17.rep.4.pointwise.weight"],
                           got["backbone.block11.rep.4.pointwise.weight"])


@pytest.mark.parametrize("backbone,match", [
    ("xception", "no xception backbone"),
    ("mobilenet", "not a MobileNetV2"), ("drn", "not a DRN-D")])
@pytest.mark.parametrize("junk", ["dict", "module"])
def test_imagenet_loader_refuses_another_file(backbone, match, junk,
                                              tmp_path):
    """A wrong file fails loudly in both packages, not a silent training
    from scratch."""
    loader = ENCODERS[backbone][0]
    pth = str(tmp_path / "junk.pth")
    torch.save({"not_a_weight": torch.zeros(3)} if junk == "dict"
               else torch.nn.Linear(1, 1), pth)
    cfg = Config().replace(backbone=backbone)
    with torch.device("meta"):
        model = build_model(cfg)
    with pytest.raises(ValueError, match=match):
        getattr(convert, loader)(pth, model)
    if backbone == "mobilenet":  # the JAX side: one full init is enough
        jcfg, _ = _cfgs(backbone)
        state, _ = init_state(jcfg, jax.random.PRNGKey(0))
        with pytest.raises(ValueError, match=match):
            getattr(jconvert, loader)(pth, state)


def test_encoder_with_a_missing_tensor_is_refused(tmp_path):
    cfg = Config().replace(backbone="drn")
    model = build_model(cfg)
    sd = _seeded_like(model.backbone.state_dict(), np.random.default_rng(0),
                      drop=("layer5.3.bn2.running_var",))
    pth = str(tmp_path / "drn.pth")
    torch.save(sd, pth)
    with pytest.raises(ValueError, match="layer5.3.bn2.running_var"):
        convert.load_drn_imagenet(pth, model)


# --------------------------------------------------------------------- #
# training
# --------------------------------------------------------------------- #

def test_prepare_batch_crops_the_mask_for_unets():
    from pylc_tpu.train_state import _prepare_batch
    jcfg, cfg = _cfgs("unet_instance_gelu_ch1")
    rng = np.random.default_rng(6)
    img = rng.integers(0, 256, (2, TILE, TILE, 1), dtype=np.uint8)
    mask = rng.integers(0, 9, (2, TILE, TILE), dtype=np.uint8)
    for flip in (False, True):
        want_x, want_m = _prepare_batch(jcfg, jnp.asarray(img),
                                        jnp.asarray(mask), jnp.asarray(flip))
        x, m = prepare_batch(cfg, torch.from_numpy(img),
                             torch.from_numpy(mask), flip)
        assert x.shape == (2, TILE, TILE, 1)  # no stacking for a U-Net
        assert m.shape == (2, 24, 24) and m.is_contiguous()
        np.testing.assert_allclose(x.numpy(), np.asarray(want_x), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_array_equal(m.numpy(), np.asarray(want_m))


def test_init_model_draws_every_conv_and_takes_cfg_channels():
    cfg = Config().replace(**dict(UNET, up_mode="upconv", ch=1))
    a, b, c = (init_model(cfg, seed=s) for s in (0, 0, 1))
    assert a.enc0.conv0.in_channels == 1
    up = a.dec0.up
    assert isinstance(up, torch.nn.ConvTranspose2d)
    assert torch.equal(up.weight, b.dec0.up.weight)
    assert not torch.equal(up.weight, c.dec0.up.weight)
    # He-normal at fan-in = input channels: each output pixel of a 2x2
    # transposed conv at stride 2 sums over them alone
    assert abs(float(up.weight.detach().std()) / (2.0 / up.in_channels) ** 0.5
               - 1) < 0.1
    assert float(up.bias.abs().max()) == 0.0


def test_head_lr_mult_takes_the_whole_of_a_model_without_backbone():
    cfg = Config().replace(**UNET, head_lr_mult=10.0)
    model = build_model(cfg)
    opt, _ = make_optimizer(cfg, model, 4)
    assert len(opt.param_groups) == 1
    assert len(opt.param_groups[0]["params"]) == len(list(
        model.parameters()))
    assert opt.param_groups[0]["lr"] == pytest.approx(10.0 * cfg.lr)
    deeplab = Config().replace(backbone="mobilenet", head_lr_mult=10.0)
    opt, _ = make_optimizer(deeplab, build_model(deeplab), 4)
    assert [g["lr"] for g in opt.param_groups] == pytest.approx(
        [deeplab.lr, 10.0 * deeplab.lr])


def _no_dropout(next_fun, args, kwargs, context):
    if isinstance(context.module, fnn.Dropout) and \
            context.method_name == "__call__":
        return args[0]
    return next_fun(*args, **kwargs)


class _InF64(torch.nn.Module):
    def __init__(self, model):
        super().__init__()
        self.model = model.double()

    def forward(self, x):
        return self.model(x.double())


def _moments(model, opt):
    return {n: opt.state[p]["exp_avg"].clone()
            for n, p in model.named_parameters()}


@pytest.mark.parametrize("name", ["unet_upconv", "resunet", "mobilenet"])
def test_train_step_matches_jax(name):
    """One AdamW step from the same weights, by the method of
    tests/test_torch_train.py: the metrics at rtol 1e-4; the clipped
    gradient, read from AdamW's first moment (0.1 g in both packages),
    per tensor within 1e-4 of JAX's norm plus four times the distance
    between the port in f32 and the port in f64.  Dropout is off on both
    sides; the flip is the one the JAX key draws.  The conv biases stay at
    flax's 0: a bias before a train-mode BatchNorm puts the mean far above
    the deviation, where flax's one-pass variance loses the digits that
    its gradient needs (1% of the gradient at a bias of 0.2)."""
    jcfg, cfg = _cfgs(name)
    kw = dict(batch_size=2, fused_loss="on", tile_size=32)
    if cfg.arch != "deeplab":
        kw.update(tile_size=TILE)
    jcfg, cfg = jcfg.replace(**kw), cfg.replace(**kw)
    T = cfg.tile_size
    state, jmodel = init_state(jcfg, jax.random.PRNGKey(0), 2)
    rng = np.random.default_rng(8)
    params = _redraw_norms(_np_tree(state.params), rng, conv_bias=False)
    stats = _np_tree(state.batch_stats)
    state = state.replace(params=jax.tree_util.tree_map(jnp.array, params))

    def port(dtype):
        model = build_model(cfg)
        model.load_state_dict(convert.state_dict_from_jax(params, stats,
                                                          cfg), strict=True)
        for m in model.modules():
            if isinstance(m, torch.nn.Dropout):
                m.p = 0.0
        stepped = model if dtype is torch.float32 else _InF64(model)
        opt, sched = make_optimizer(cfg, model, 2)
        return model, opt, make_train_step(cfg, stepped, opt, sched)

    img = rng.integers(0, 256, (2, 3, T, T)).astype(np.uint8)
    mask = rng.integers(0, cfg.n_classes, (2, T, T)).astype(np.uint8)
    key = jax.random.PRNGKey(3)
    flip = bool(jax.random.bernoulli(jax.random.split(key)[0]))
    with fnn.intercept_methods(_no_dropout):
        jstate, jm = jax_make_train_step(jcfg, jmodel)(
            state, jnp.asarray(img), jnp.asarray(mask), key)
    model, opt, step = port(torch.float32)
    m = step(torch.from_numpy(img), torch.from_numpy(mask), flip=flip)
    model64, opt64, step64 = port(torch.float64)
    step64(torch.from_numpy(img), torch.from_numpy(mask), flip=flip)

    for k in ("ce", "dice", "focal", "total"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-4,
                                   err_msg=k)
    mu = [s for s in jax.tree_util.tree_leaves(
        jstate.opt_state, is_leaf=lambda x: hasattr(x, "mu"))
        if hasattr(s, "mu")][0].mu
    want = convert.state_dict_from_jax(_np_tree(mu), {}, cfg)
    got, f64 = _moments(model, opt), _moments(model64, opt64)
    assert sorted(got) == sorted(want)
    for k in got:
        err = float((got[k].double() - want[k].double()).norm())
        floor = float((got[k].double() - f64[k]).norm())
        scale = float(want[k].double().norm())
        assert err <= 1e-4 * scale + 4.0 * floor, (k, err, scale, floor)
