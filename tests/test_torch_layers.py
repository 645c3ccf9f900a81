"""Parity of the port's shared layers with pylc_tpu/models/layers.py.

Inputs come from a numpy seed and go through both packages in f32 on
the CPU."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from pylc_tpu.models import layers as jl
from pylc_tpu_torch.models import layers as tl

torch.set_num_threads(1)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


@pytest.mark.parametrize("shape,out", [
    ((2, 8, 12, 3), (32, 48)),    # x4 up, the DeepLab decoder's step
    ((1, 9, 7, 5), (17, 30)),     # ragged up
    ((1, 16, 20, 2), (5, 7)),     # down
    ((1, 1, 6, 4), (3, 11)),      # a one-row input
    ((1, 5, 5, 2), (1, 1)),       # to one pixel
])
def test_resize_matches_jax(shape, out):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    want = np.asarray(jl.resize_bilinear_align_corners(jnp.asarray(x), *out))
    got = _nhwc(tl.resize_bilinear_align_corners(_nchw(x), *out))
    # f32 lerp against the JAX matmul form: a few ulps of the largest
    # input, the scale of the rounding in the matmul's sums
    atol = 8 * np.finfo(np.float32).eps * np.abs(x).max()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol)


def test_resize_keeps_dtype_and_computes_in_f32():
    x = torch.randn(1, 3, 4, 4, generator=torch.Generator().manual_seed(0))
    got = tl.resize_bilinear_align_corners(x.bfloat16(), 8, 8)
    assert got.dtype == torch.bfloat16
    want = tl.resize_bilinear_align_corners(x.bfloat16().float(), 8, 8)
    assert torch.equal(got, want.bfloat16())


@pytest.mark.parametrize("hw", [(16, 16), (15, 9)])
def test_max_pool_matches_jax(hw):
    x = np.random.default_rng(1).standard_normal(
        (2, *hw, 4)).astype(np.float32)
    want = np.asarray(jl.max_pool_3x3_s2_p1(jnp.asarray(x)))
    got = _nhwc(tl.max_pool_3x3_s2_p1(_nchw(x)))
    np.testing.assert_array_equal(got, want)  # a max is exact


def test_batchnorm_eval_matches_jax():
    rng = np.random.default_rng(2)
    C = 6
    x = rng.standard_normal((2, 5, 7, C)).astype(np.float32) * 3 + 1
    scale, bias = (rng.standard_normal(C).astype(np.float32) for _ in "ab")
    mean = rng.standard_normal(C).astype(np.float32)
    var = rng.random(C).astype(np.float32) + 0.5
    norm = jl.make_norm("batch", train=False)
    want = np.asarray(norm().apply(
        {"params": {"scale": scale, "bias": bias},
         "batch_stats": {"mean": mean, "var": var}}, jnp.asarray(x)))
    bn = tl.make_norm("batch")(C).eval()
    assert (bn.eps, bn.momentum) == (1e-5, 0.1)
    bn.load_state_dict({"weight": torch.tensor(scale),
                        "bias": torch.tensor(bias),
                        "running_mean": torch.tensor(mean),
                        "running_var": torch.tensor(var)}, strict=False)
    with torch.no_grad():
        got = _nhwc(bn(_nchw(x)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_batchnorm_running_mean_momentum_matches_jax():
    """One train-mode step moves the running mean and variance by the
    same 0.1 of the batch statistics in both packages (flax momentum 0.9
    = torch 0.1), the variance being the biased one, as flax takes it."""
    x = np.random.default_rng(3).standard_normal(
        (4, 3, 3, 2)).astype(np.float32) + 2
    norm = partial(fnn.BatchNorm, use_running_average=False, momentum=0.9,
                   epsilon=1e-5)
    variables = norm().init(jax.random.PRNGKey(0), jnp.asarray(x))
    _, upd = norm().apply(variables, jnp.asarray(x), mutable=["batch_stats"])
    bn = tl.make_norm("syncbatch")(2).train()
    bn(_nchw(x))
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(upd["batch_stats"]["mean"]),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(upd["batch_stats"]["var"]),
                               rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("shape", [(1, 1, 1, 5), (3, 2, 2, 5)])
def test_batchnorm_train_output_and_gradients_match_jax(shape):
    """Train-mode output, running stats and gradients against flax, down
    to one value per channel, where flax returns the bias (torch's own
    BatchNorm2d raises there)."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal(shape).astype(np.float32) * 2 + 1
    C = shape[-1]
    scale, bias = (rng.standard_normal(C).astype(np.float32) for _ in "ab")
    mean = rng.standard_normal(C).astype(np.float32)
    var = rng.random(C).astype(np.float32) + 0.5
    norm = partial(fnn.BatchNorm, use_running_average=False, momentum=0.9,
                   epsilon=1e-5)
    params = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}

    def jfwd(p, xx):
        y, upd = norm().apply({"params": p, "batch_stats": {
            "mean": mean, "var": var}}, xx, mutable=["batch_stats"])
        return jnp.sum(y * jnp.arange(y.size).reshape(y.shape)), (y, upd)

    (_, (want, upd)), (gp, gx) = jax.value_and_grad(
        jfwd, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    bn = tl.make_norm("batch")(C).train()
    bn.load_state_dict({"weight": torch.tensor(scale),
                        "bias": torch.tensor(bias),
                        "running_mean": torch.tensor(mean),
                        "running_var": torch.tensor(var)}, strict=False)
    xt = _nchw(x).requires_grad_(True)
    y = bn(xt)
    (_nchw(np.arange(y.numel(), dtype=np.float32).reshape(shape))
     * y).sum().backward()
    np.testing.assert_allclose(_nhwc(y), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    for name, key in (("running_mean", "mean"), ("running_var", "var")):
        np.testing.assert_allclose(getattr(bn, name).numpy(),
                                   np.asarray(upd["batch_stats"][key]),
                                   rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(_nhwc(xt.grad), np.asarray(gx), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(bn.weight.grad.numpy(),
                               np.asarray(gp["scale"]), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(bn.bias.grad.numpy(), np.asarray(gp["bias"]),
                               rtol=1e-5)


@pytest.mark.parametrize("name", sorted(jl.ACTIVATIONS))
def test_activation_matches_jax(name):
    x = np.linspace(-4, 4, 101, dtype=np.float32)
    want = np.asarray(jl.get_activation(name)(jnp.asarray(x)))
    got = tl.get_activation(name)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_unported_norms_raise():
    """A normalizer neither package has raises the JAX package's error."""
    for name in ("group", "none"):
        with pytest.raises(ValueError, match="Unknown normalizer"):
            jl.make_norm(name, train=False)
        with pytest.raises(ValueError, match="Unknown normalizer"):
            tl.make_norm(name)


def _norm_case(name, shape, seed):
    """(x, scale, bias, flax module, the port's module with the same
    scale and bias)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32) * 3 + 1
    C = shape[-1]
    scale, bias = (rng.standard_normal(C).astype(np.float32) for _ in "ab")
    norm = tl.make_norm(name)(C)
    assert norm.eps == 1e-5 and sorted(norm.state_dict()) == ["bias",
                                                              "weight"]
    norm.load_state_dict({"weight": torch.tensor(scale),
                          "bias": torch.tensor(bias)}, strict=True)
    return x, scale, bias, jl.make_norm(name, train=True)(), norm


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name,shape", [
    ("instance", (2, 5, 7, 6)), ("instance", (1, 1, 1, 4)),
    ("instance", (3, 1, 1, 4)),   # the ASPP image-pool branch: one value
    ("instance", (1, 2, 1, 3)),
    ("layer", (2, 5, 7, 6)), ("layer", (1, 1, 1, 4)), ("layer", (2, 3, 2, 1)),
])
def test_instance_and_layer_norm_match_jax(name, shape, train):
    """Output and gradients against flax ``GroupNorm(group_size=1)`` and
    ``LayerNorm``, neither of which keeps statistics: instance over H x W
    per sample and channel, layer over the channels of each pixel, both
    with a scale and a bias per channel."""
    x, scale, bias, jnorm, norm = _norm_case(name, shape, 5)
    params = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
    mix = np.random.default_rng(6).standard_normal(shape).astype(np.float32)

    def jfwd(p, xx):
        y = jnorm.apply({"params": p}, xx)
        return jnp.sum(y * mix), y

    (_, want), (gp, gx) = jax.value_and_grad(jfwd, argnums=(0, 1),
                                             has_aux=True)(params,
                                                           jnp.asarray(x))
    norm.train(train)
    xt = _nchw(x).requires_grad_(True)
    y = norm(xt)
    (y * _nchw(mix)).sum().backward()
    np.testing.assert_allclose(_nhwc(y), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(_nhwc(xt.grad), np.asarray(gx), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(norm.weight.grad.numpy(),
                               np.asarray(gp["scale"]), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(norm.bias.grad.numpy(),
                               np.asarray(gp["bias"]), rtol=1e-5, atol=1e-5)


def test_layer_norm_takes_channels_last_without_a_copy():
    norm = tl.make_norm("layer")(8)
    x = torch.randn(2, 8, 5, 6, generator=torch.Generator().manual_seed(0)
                    ).contiguous(memory_format=torch.channels_last)
    y = norm(x)
    assert y.shape == x.shape
    assert y.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(y.detach().numpy(),
                               norm(x.contiguous()).detach().numpy(),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("shape,target", [
    ((2, 10, 12, 3), (4, 6)), ((1, 9, 9, 2), (4, 5)),   # odd margins
    ((1, 6, 6, 1), (6, 6)), ((1, 136, 136, 2), (104, 104)),
])
def test_center_crop_matches_jax(shape, target):
    x = np.random.default_rng(7).standard_normal(shape).astype(np.float32)
    want = np.asarray(jl.center_crop(jnp.asarray(x), *target))
    got = _nhwc(tl.center_crop(_nchw(x), *target))
    np.testing.assert_array_equal(got, want)
