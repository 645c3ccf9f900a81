"""Parity of the port's DeepLabV3+/ResNet101, weight converter and
predict with the JAX package, in f32 on the CPU.

The JAX weights are built once for the module (``init_state`` at 64 px
tiles) and reach the port through ``state_dict_from_jax``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pylc_tpu.config import Config
from pylc_tpu.convert import export_deeplab_pth
from pylc_tpu.models.layers import make_norm
from pylc_tpu.models.resnet import ResNet101 as JaxResNet101
from pylc_tpu.ops.normalize import normalize_image as jax_normalize
from pylc_tpu.train_state import init_state, make_predict as jax_make_predict
from pylc_tpu.models.registry import build_model as jax_build_model
from pylc_tpu_torch.convert import (load_pth_model, resnet_state_dict,
                                    state_dict_from_jax)
from pylc_tpu_torch.models.registry import build_model
from pylc_tpu_torch.models.resnet import ResNet101
from pylc_tpu_torch.ops.normalize import normalize_image
from pylc_tpu_torch.train_state import make_predict

torch.set_num_threads(1)

TILE = 64


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_logits_close(got, want):
    """The tolerance of tests/test_golden_parity.py: conv backends sum
    in different orders, so compare at a scale-relative atol; argmax
    may flip only at near-ties."""
    assert got.shape == want.shape
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=1e-3,
                               atol=max(5e-4, 1e-5 * scale))
    agree = np.mean(got.argmax(-1) == want.argmax(-1))
    assert agree >= 0.999, f"argmax agreement {agree}"


@pytest.fixture(scope="module")
def jax_deeplab():
    cfg = Config().replace(tile_size=TILE, compute_dtype="float32")
    state, _ = init_state(cfg, jax.random.PRNGKey(0))
    return cfg, state


@pytest.fixture(scope="module")
def torch_deeplab(jax_deeplab):
    cfg, state = jax_deeplab
    model = build_model(cfg)
    model.load_state_dict(state_dict_from_jax(_np_tree(state.params),
                                              _np_tree(state.batch_stats)),
                          strict=True)
    return model.eval()


def test_state_dict_matches_exporter(jax_deeplab, tmp_path):
    cfg, state = jax_deeplab
    path = export_deeplab_pth(state, cfg, str(tmp_path / "m.pth"))
    want = torch.load(path, weights_only=False)["model"]
    got = state_dict_from_jax(_np_tree(state.params),
                              _np_tree(state.batch_stats))
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


def test_exported_pth_loads_strict(jax_deeplab, tmp_path):
    """A reference-schema .pth from the JAX exporter loads into the port
    with strict=True, and its meta comes back as the config."""
    cfg, state = jax_deeplab
    path = export_deeplab_pth(state, cfg, str(tmp_path / "m.pth"))
    cfg2, model = load_pth_model(path)
    assert (cfg2.tile_size, cfg2.n_classes, cfg2.arch) == (TILE, 9, "deeplab")
    sd = model.state_dict()
    assert torch.equal(sd["decoder.last_conv.8.bias"],
                       torch.tensor(np.asarray(
                           state.params["decoder"]["head"]["bias"])))


def test_resnet_backbone_matches_jax():
    """Shallow ResNet101 (layers 1,1,1,1; layer4 keeps its multi-grid
    unit) with random weights and randomized BatchNorm parameters and
    statistics."""
    rng = np.random.default_rng(0)
    jm = JaxResNet101(16, make_norm("batch", train=False), layers=(1, 1, 1, 1))
    x = rng.standard_normal((2, TILE, TILE, 3)).astype(np.float32)
    variables = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))
    ranges = {"scale": (0.5, 1.5), "bias": (-0.2, 0.2), "mean": (-0.5, 0.5),
              "var": (0.5, 1.5)}

    def randomize_bn(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                randomize_bn(v)
            elif k in ranges:
                tree[k] = rng.uniform(*ranges[k], v.shape).astype(np.float32)
        return tree

    params = randomize_bn(_np_tree(variables["params"]))
    stats = randomize_bn(_np_tree(variables["batch_stats"]))
    feat, ll = jm.apply({"params": params, "batch_stats": stats},
                        jnp.asarray(x))

    tm = ResNet101(layers=(1, 1, 1, 1)).eval()
    tm.load_state_dict(resnet_state_dict(params, stats), strict=True)
    with torch.no_grad():
        tfeat, tll = tm(torch.from_numpy(x).permute(0, 3, 1, 2))
    for got, want in ((tfeat, feat), (tll, ll)):
        got = got.permute(0, 2, 3, 1).numpy()
        want = np.asarray(want)
        assert got.shape == want.shape
        scale = np.abs(want).max()
        np.testing.assert_allclose(got, want, rtol=1e-3,
                                   atol=max(5e-4, 1e-5 * scale))


def test_deeplab_matches_jax(jax_deeplab, torch_deeplab):
    """Full-depth DeepLabV3+/ResNet101 at 64 px, same weights."""
    cfg, state = jax_deeplab
    x = np.random.default_rng(1).standard_normal(
        (2, TILE, TILE, 3)).astype(np.float32)
    jm = jax_build_model(cfg, train=False)
    want = np.asarray(jm.apply({"params": state.params,
                                "batch_stats": state.batch_stats},
                               jnp.asarray(x), train=False))
    with torch.no_grad():
        got = torch_deeplab(torch.from_numpy(x).permute(0, 3, 1, 2))
    _assert_logits_close(got.permute(0, 2, 3, 1).numpy(), want)


def test_predict_matches_jax(jax_deeplab, torch_deeplab):
    """uint8 NHWC tiles -> logits, normalization included."""
    cfg, state = jax_deeplab
    img = np.random.default_rng(2).integers(
        0, 256, (3, TILE, TILE, 3), dtype=np.uint8)
    want = np.asarray(jax_make_predict(cfg, jax_build_model(cfg))(
        state, jnp.asarray(img)))
    got = make_predict(cfg, torch_deeplab)(torch.from_numpy(img))
    assert not torch.backends.cudnn.allow_tf32  # f32 runs in true f32
    assert got.dtype == torch.float32
    _assert_logits_close(got.numpy(), want)


@pytest.mark.parametrize("ch,default,stats", [
    (3, False, ([132.47, 144.47, 149.45], [24.85, 22.04, 18.77])),
    (3, True, ([100.0, 110.0, 120.0], [20.0, 21.0, 22.0])),
    (1, False, ([120.0], [30.0])),
    (1, True, ([120.0], [30.0])),  # the quirk: no /255
])
def test_normalize_matches_jax(ch, default, stats):
    img = np.random.default_rng(3).integers(
        0, 256, (2, 5, 6, ch), dtype=np.uint8)
    want = np.asarray(jax_normalize(jnp.asarray(img), *stats, ch,
                                    default=default))
    got = normalize_image(torch.from_numpy(img), *stats, ch,
                          default=default).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_unported_architectures_raise():
    """Every architecture and backbone of the JAX registry builds; a name
    it does not have raises its error."""
    from pylc_tpu_torch.config import Config as PortConfig
    cfg = PortConfig()
    with torch.device("meta"):
        for arch in cfg.arch_options:
            assert build_model(cfg.replace(arch=arch)) is not None
        for backbone in ("resnet", "xception", "mobilenet", "drn"):
            assert build_model(cfg.replace(backbone=backbone)) is not None
    with pytest.raises(ValueError, match="not available"):
        build_model(cfg.replace(arch="segnet"))
    with pytest.raises(ValueError, match="Unknown backbone"):
        build_model(cfg.replace(backbone="vgg"))


@pytest.mark.parametrize("ch,default", [(3, False), (1, False), (1, True)])
def test_prepare_batch_matches_jax(ch, default):
    """Normalization per the checkpoint's meta, grayscale stacked x3."""
    from pylc_tpu.train_state import _prepare_batch
    from pylc_tpu_torch.train_state import prepare_batch
    cfg = Config().replace(ch=ch, normalize_default=default,
                           px_mean=[125.0] * ch, px_std=[25.0] * ch)
    img = np.random.default_rng(4).integers(
        0, 256, (2, 4, 5, ch), dtype=np.uint8)
    want, _ = _prepare_batch(cfg, jnp.asarray(img), None, None)
    got, no_mask = prepare_batch(cfg, torch.from_numpy(img))
    assert no_mask is None
    assert got.shape == (2, 4, 5, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
