"""The port's int8 post-training quantization (``pylc_tpu_torch/quant.py``
on kernels Q and KQ, ``ops/kernels/int8_conv.py``) against the JAX
package's (``pylc_tpu/quant.py``) on the CPU, where the kernels' plain
versions run.

Inputs and weights come from seeds (numpy, flax's init for the TinyNet,
the port's ``init_model`` for the deep networks) and cross between the
packages through the ``.ckpt`` bridge (``convert.jax_trees_from_state_dict``);
scales cross through
``quant.scales_from_jax`` / ``scales_to_jax``.  Everything runs in f32:
under bf16 autocast the port keeps BatchNorm in f32 where the JAX model
runs it in bf16, so the two would quantize different values.

Tolerances.  Both packages quantize with the same float32 operations
(the activation's ``x * (1/s_x)`` that XLA makes of ``x / s_x``, the
weights' ``absmax * (1/127)`` and ``w / w_scale``), and the int32 sums are
exact, so one conv on one input agrees bit for bit (TinyNet).  Through a
deep network the float parts (BatchNorm, resizes, the f32 convolutions
the U-Net's transposed convs stay) round in other orders in the two
packages; an input that lands within an ulp of a rounding tie can then
quantize one step apart, and that step travels on.  So each conv of a
deep network is held bit for bit to JAX's on the input JAX gave it, and
the logits of the whole network within the quantization error's size
(test_int8_logits_match_jax)."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import flax.linen as fnn

from pylc_tpu import quant as jquant
from pylc_tpu.config import Config as JaxConfig
from pylc_tpu.db.database import TileDB as JaxTileDB
from pylc_tpu.models.registry import build_model as jax_build_model
from pylc_tpu.train_state import _prepare_batch as jax_prepare_batch
from pylc_tpu_torch import quant
from pylc_tpu_torch.config import Config
from pylc_tpu_torch.convert import jax_trees_from_state_dict
from pylc_tpu_torch.db.database import TileDB
from pylc_tpu_torch.export import (ServingModel, export_segmenter,
                                   save_artifact)
from pylc_tpu_torch.infer import Segmenter
from pylc_tpu_torch.models.registry import build_model
from pylc_tpu_torch.ops.kernels.int8_conv import (int8_conv2d,
                                                   int8_conv2d_plain,
                                                   quantize_int8,
                                                   quantize_int8_plain)
from pylc_tpu_torch.parallel.mesh import Mesh
from pylc_tpu_torch.train_state import (init_model, make_predict,
                                        prepare_batch)

torch.set_num_threads(1)

TILE = 32
UNET = dict(arch="unet", unet_depth=3, unet_wf=3, input_size=64,
            output_size=24, up_mode="upconv")
RESIDUAL_GAMMA = 0.03  # every bottleneck's bn3 scale, as test_torch_train
# TinyNet: one quantization step of the last conv's output is
# s_x * w_scale[o]; the two packages are held to STEPS of them
STEPS = 2
# a conv's output against JAX's on the same input: ulps of its largest
# value (see test_every_int8_conv_matches_jax_on_its_input)
EPILOGUE_ULPS = 2
# class maps of the port's int8 logits against JAX's (see
# test_int8_logits_match_jax)
ARGMAX_AGREEMENT = 0.99


class JaxTinyNet(fnn.Module):
    """tests/test_quant.py's TinyNet: conv -> relu -> strided conv -> relu
    -> dilated conv, SAME padding."""

    @fnn.compact
    def __call__(self, x, train=False):
        x = fnn.Conv(8, (3, 3), name="c1")(x)
        x = fnn.relu(x)
        x = fnn.Conv(16, (3, 3), strides=(2, 2), name="c2")(x)
        x = fnn.relu(x)
        x = fnn.Conv(4, (3, 3), kernel_dilation=(2, 2), use_bias=False,
                     name="c3")(x)
        return x


class TinyNet(torch.nn.Module):
    """JaxTinyNet in torch; flax's SAME at stride 2 on 16 px pads (0, 1)."""

    def __init__(self):
        super().__init__()
        self.c1 = torch.nn.Conv2d(3, 8, 3, padding=1)
        self.c2 = torch.nn.Conv2d(8, 16, 3, stride=2)
        self.c3 = torch.nn.Conv2d(16, 4, 3, padding=2, dilation=2,
                                  bias=False)

    def forward(self, x):
        x = F.relu(self.c1(x))
        x = F.relu(self.c2(F.pad(x, (0, 1, 0, 1))))
        return self.c3(x)


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


@pytest.fixture(scope="module")
def tiny():
    """(JAX net, its variables, the port's net, an NHWC input): the same
    seeded weights, biases drawn from a seed (flax starts them at 0)."""
    net = JaxTinyNet()
    x = np.random.default_rng(1).standard_normal(
        (2, 16, 16, 3)).astype(np.float32)
    params = _np_tree(net.init(jax.random.PRNGKey(0), jnp.asarray(x))
                      ["params"])
    rng = np.random.default_rng(2)
    for name in ("c1", "c2"):
        params[name]["bias"] = rng.uniform(
            -0.2, 0.2, params[name]["bias"].shape).astype(np.float32)
    port = TinyNet().eval()
    with torch.no_grad():
        for name in ("c1", "c2", "c3"):
            conv = getattr(port, name)
            conv.weight.copy_(torch.from_numpy(
                params[name]["kernel"].transpose(3, 2, 0, 1)))
            if "bias" in params[name]:
                conv.bias.copy_(torch.from_numpy(params[name]["bias"]))
    return net, {"params": params}, port, x


def test_calibration_records_every_conv(tiny):
    _, _, port, x = tiny
    scales = quant.calibrate_absmax(port, [_nchw(x), _nchw(x * 2.0)])
    assert set(scales) == {"c1", "c2", "c3"}
    # absmax over batches: the 2x batch must win
    assert scales["c1"] == pytest.approx(float(np.abs(x * 2).max()))
    assert all(v > 0 for v in scales.values())
    assert port.training is False and not port.c1._forward_pre_hooks


def test_quantized_forward_close_to_float(tiny):
    _, _, port, x = tiny
    scales = quant.calibrate_absmax(port, [_nchw(x)])
    qnet = quant.quantize_model(port, scales)
    with torch.no_grad():
        ref, got = port(_nchw(x)), qnet(_nchw(x))
    assert got.shape == ref.shape and got.dtype == ref.dtype
    assert got.is_contiguous(memory_format=torch.channels_last)
    # int8 symmetric quant: ~1% relative error per conv, 3 convs deep
    err = float((got - ref).abs().max() / (ref.abs().max() + 1e-9))
    assert err < 0.05, f"relative error {err:.4f}"
    assert float((got - ref).abs().max()) > 0  # a quantized computation
    # the model itself is left as it was
    assert all(type(getattr(port, n)) is torch.nn.Conv2d
               for n in ("c1", "c2", "c3"))


def test_uncalibrated_convs_run_float(tiny):
    _, _, port, x = tiny
    scales = quant.calibrate_absmax(port, [_nchw(x)])
    scales.pop("c2")  # pretend c2 was never seen
    qnet = quant.quantize_model(port, scales)
    assert qnet.c2 is port.c2
    assert isinstance(qnet.c1, quant.Int8Conv2d)
    with torch.no_grad():
        got = qnet(_nchw(x))
    assert torch.isfinite(got).all()


def test_quantized_tree_keeps_its_own_dicts(tiny):
    """quantize_model's copied containers hold hooks, buffers and their
    mode in dicts of their own; make_predict_int8 puts the whole model in
    eval mode (its modules serve the int8 predict), never half of it."""
    _, _, port, x = tiny
    model = copy.deepcopy(port)
    scales = quant.calibrate_absmax(model, [_nchw(x)])
    scales.pop("c3")  # c3 stays the model's own module
    model.train()
    qnet = quant.quantize_model(model, scales)
    assert qnet is not model and qnet.c3 is model.c3
    fired = []
    qnet.register_forward_hook(lambda *a: fired.append("copy"))
    qnet.register_buffer("extra", torch.zeros(1))
    qnet.training = False
    with torch.no_grad():
        model(_nchw(x))
    assert fired == [] and not model._forward_hooks
    assert "extra" not in model._buffers and model.training
    predict = quant.make_predict_int8(Config(), model, scales)
    assert not any(m.training for m in model.modules())
    assert not any(m.training for m in predict.model.modules())


def test_tinynet_matches_jax(tiny):
    """Same input, same scales: int8 weights equal, weight scales within
    rtol 1e-6, outputs within STEPS quantization steps of JAX's int8 (bit
    equal is expected) and 20x closer to it than to the float conv."""
    net, variables, port, x = tiny
    scales = jquant.calibrate_absmax(net, variables, [jnp.asarray(x)])
    assert quant.calibrate_absmax(port, [_nchw(x)]) == pytest.approx(
        scales, rel=1e-6)
    qnet = quant.quantize_model(port, scales)
    for name in ("c1", "c2", "c3"):
        kf = jnp.asarray(variables["params"][name]["kernel"])
        w_scale = jnp.maximum(jnp.max(jnp.abs(kf), axis=(0, 1, 2)) /
                              jquant.Q_MAX, 1e-12)
        qw = jax.jit(lambda k, s: jnp.clip(jnp.round(k / s), -127, 127)
                     .astype(jnp.int8))(kf, w_scale)
        mod = getattr(qnet, name)
        np.testing.assert_allclose(mod.w_scale.numpy(),
                                   np.asarray(w_scale), rtol=1e-6)
        np.testing.assert_array_equal(
            mod.qweight.view(mod.weight_shape).numpy(),
            np.asarray(qw).transpose(3, 0, 1, 2))
    with fnn.intercept_methods(jquant.int8_interceptor(scales)):
        want = np.asarray(net.apply(variables, jnp.asarray(x)))
    ref = np.asarray(net.apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = _nhwc(qnet(_nchw(x)))
    step = qnet.c3.w_scale.numpy() * qnet.c3.s_x
    err = np.abs(got - want)
    assert (err <= STEPS * step).all(), f"{(err / step).max()} steps"
    assert err.max() * 20 <= np.abs(want - ref).max()


def test_quantize_plain_follows_jax_at_ties():
    """Values on and next to the rounding ties of q * s_x: Q's plain
    version gives JAX's quantized values (XLA multiplies by 1/s_x)."""
    rng = np.random.default_rng(3)
    for act in rng.uniform(0.05, 300.0, 24):
        s_x = max(float(act), 1e-12) / jquant.Q_MAX
        k = rng.integers(-140, 140, 4096).astype(np.float32)
        x = ((k + 0.5) * np.float32(s_x)).astype(np.float32)
        x = np.concatenate([x, np.nextafter(x, np.float32(np.inf)),
                            np.nextafter(x, np.float32(-np.inf))])
        want = jax.jit(lambda v: jnp.clip(jnp.round(v / s_x), -127, 127)
                       .astype(jnp.int8))(jnp.asarray(x))
        got = quantize_int8_plain(torch.from_numpy(x).view(1, -1, 1, 1), s_x)
        np.testing.assert_array_equal(got.view(-1).numpy(),
                                      np.asarray(want))
        # the operator takes the plain version on the CPU
        assert torch.equal(quantize_int8(
            torch.from_numpy(x).view(1, -1, 1, 1), s_x), got)


@pytest.mark.parametrize("shape", [
    # (B, H, W, I, O, k, stride, padding, dilation)
    (2, 9, 11, 64, 24, 3, 2, 1, 1),      # a strided 3x3, odd sizes
    (3, 7, 5, 36, 40, 1, 1, 0, 1),       # a 1x1
    (1, 12, 12, 8, 16, 3, 1, 6, 6),      # ASPP-style dilation
])
def test_int8_conv2d_plain_equals_int_mm(shape):
    """KQ's plain version against ``torch._int_mm`` on an im2col (int32
    exact): the accumulator, then the epilogue written out by hand."""
    B, H, W, I, O, k, s, p, d = shape
    rng = np.random.default_rng(sum(shape))
    qx = torch.from_numpy(rng.integers(-127, 128, (B, H, W, I)).astype(
        np.int8))
    qw = torch.from_numpy(rng.integers(-127, 128, (O, k, k, I)).astype(
        np.int8))
    w_scale = torch.from_numpy(rng.uniform(1e-4, 1e-2, O).astype(np.float32))
    bias = torch.from_numpy(rng.uniform(-1, 1, O).astype(np.float32))
    s_x = 0.0371
    got = int8_conv2d_plain(qx, qw, w_scale, bias, s_x, (s, s), (p, p),
                            (d, d), 1, torch.float32)
    cols = F.unfold(qx.permute(0, 3, 1, 2).float(), k, d, p, s)  # [B,kkI,L]
    Ho, Wo = got.shape[1:3]
    a = cols.reshape(B, I, k * k, -1).permute(0, 3, 2, 1).reshape(
        B * Ho * Wo, k * k * I)
    m = max(17, -(-a.shape[0] // 8) * 8)  # _int_mm: rows > 16, K % 8 == 0
    kp = -(-a.shape[1] // 8) * 8
    a8 = torch.zeros((m, kp), dtype=torch.int8)
    a8[:a.shape[0], :a.shape[1]] = a.round().to(torch.int8)
    b8 = torch.zeros((kp, -(-O // 8) * 8), dtype=torch.int8)
    b8[:k * k * I, :O] = qw.reshape(O, -1).t()
    acc = torch._int_mm(a8, b8)[:B * Ho * Wo, :O]
    want = acc.float() * (w_scale * np.float32(s_x)) + bias
    assert torch.equal(got.reshape(-1, O), want)
    assert torch.equal(int8_conv2d(qx, qw, w_scale, bias, s_x, (s, s),
                                   (p, p), (d, d), 1, torch.float32), got)


def test_int8_conv2d_plain_depthwise():
    """groups = I (the depthwise 3x3 of MobileNetV2 and Xception), bf16
    output: against the sums written out in int64 numpy."""
    rng = np.random.default_rng(4)
    B, H, W, I, s, p = 2, 7, 9, 12, 2, 1
    qx = rng.integers(-127, 128, (B, H, W, I)).astype(np.int8)
    qw = rng.integers(-127, 128, (I, 3, 3, 1)).astype(np.int8)
    w_scale = rng.uniform(1e-4, 1e-2, I).astype(np.float32)
    got = int8_conv2d_plain(torch.from_numpy(qx), torch.from_numpy(qw),
                            torch.from_numpy(w_scale), None, 0.02, (s, s),
                            (p, p), (1, 1), I, torch.bfloat16)
    xp = np.pad(qx.astype(np.int64), ((0, 0), (p, p), (p, p), (0, 0)))
    Ho, Wo = got.shape[1:3]
    acc = np.zeros((B, Ho, Wo, I), np.int64)
    for ky in range(3):
        for kx in range(3):
            acc += xp[:, ky:ky + s * Ho:s, kx:kx + s * Wo:s] * \
                qw[:, ky, kx, 0].astype(np.int64)
    want = torch.from_numpy(acc.astype(np.float32)) * torch.from_numpy(
        w_scale * np.float32(0.02))
    assert torch.equal(got, want.to(torch.bfloat16))


def test_conv_geometry_of_a_fake_pass():
    """time_kernels' bounds come from a pass on fake tensors: on the
    MobileNetV2 DeepLab (depthwise convs) it sees every conv of a real
    forward under bf16 autocast, with its input's shape and dtype, and
    int8_bound counts one conv's work as written out here."""
    from pylc_tpu_torch.tools.time_kernels import (PEAK_BYTES_PER_S,
                                                   PEAK_INT8_OPS_PER_S,
                                                   conv_geometry, int8_bound)
    cfg = Config().replace(arch="deeplab", backbone="mobilenet",
                           tile_size=64)
    model = init_model(cfg, seed=0).eval().to(
        memory_format=torch.channels_last)
    seen = []
    handles = [m.register_forward_pre_hook(
        lambda m, a: seen.append((list(a[0].shape), a[0].dtype, m)))
        for m in model.modules() if isinstance(m, torch.nn.Conv2d)]
    x = torch.zeros((2, 3, 64, 64)).contiguous(
        memory_format=torch.channels_last)
    with torch.no_grad(), torch.autocast("cpu", dtype=torch.bfloat16):
        model(x)
    for h in handles:
        h.remove()
    rows = conv_geometry(model, (2, 3, 64, 64))
    assert sum(r["count"] for r in rows) == len(seen)
    assert any(r["groups"] > 1 for r in rows)
    first = {}
    for shape, dtype, m in seen:
        O, Cg, kh, kw = m.weight.shape
        key = (tuple(shape), str(dtype).split(".")[-1], (O, kh, kw, Cg),
               m.stride, m.padding, m.dilation, m.groups)
        first[key] = first.get(key, 0) + 1
    assert {(tuple(r["x"]), r["x_dtype"], tuple(r["w"]), tuple(r["stride"]),
             tuple(r["padding"]), tuple(r["dilation"]), r["groups"]):
            r["count"] for r in rows} == first
    # a 3x3 stride-2 conv, 8 -> 16 channels on 2 x 9 x 9, bf16 in and out
    b = int8_bound((2, 8, 9, 9), 2, (16, 3, 3, 8), (5, 5), 2, True)
    macs = 2 * 5 * 5 * 16 * 3 * 3 * 8
    assert b["macs"] == macs
    assert b["kq_ops_ms"] == pytest.approx(2 * macs / PEAK_INT8_OPS_PER_S
                                           * 1e3, rel=1e-12)
    assert b["kq_bytes_ms"] == pytest.approx(
        (2 * 8 * 9 * 9 + 16 * 72 + 2 * 4 * 16 + 2 * 5 * 5 * 16 * 2)
        / PEAK_BYTES_PER_S * 1e3, rel=1e-12)
    assert b["kq_bound_ms"] == max(b["kq_ops_ms"], b["kq_bytes_ms"])


NETS = {
    # tests/test_quant.py's drop-in case: depthwise convs
    "mobilenet": (dict(arch="deeplab", backbone="mobilenet", tile_size=64),
                  0.9),
    # bn3 x 0.03, as tests/test_torch_train.py conditions it
    "resnet101": (dict(tile_size=TILE), ARGMAX_AGREEMENT),
    # depth 3, width 2**3, 64 px -> 24 px, a transposed-conv decoder
    "unet": (dict(UNET, tile_size=64), ARGMAX_AGREEMENT),
}


@pytest.fixture(scope="module", params=sorted(NETS))
def net(request):
    """One network in both packages, f32, and the JAX package's int8 run
    on it: {cfg, model (the port's, eval), tiles, jscales (JAX's
    calibration on the tiles), want (JAX's int8 logits), io ({flax path:
    (conv input, int8 conv output)} of that run), agreement (the argmax
    agreement asked of the port)}.  The weights are the port's seeded
    He-normal initialization with conv biases drawn from a numpy seed,
    carried to the JAX package by ``convert.jax_trees_from_state_dict``."""
    kw, agreement = NETS[request.param]
    jcfg = JaxConfig().replace(compute_dtype="float32", **kw)
    cfg = Config().replace(compute_dtype="float32", **kw)
    model = init_model(cfg, seed=sorted(NETS).index(request.param))
    rng = np.random.default_rng(8)
    with torch.no_grad():
        for name, m in model.named_modules():
            if isinstance(m, torch.nn.Conv2d) and m.bias is not None:
                m.bias.copy_(torch.from_numpy(rng.uniform(
                    -0.1, 0.1, m.bias.shape).astype(np.float32)))
            if name.endswith(".bn3"):
                m.weight.mul_(RESIDUAL_GAMMA)
    params, stats = jax_trees_from_state_dict(model.state_dict(), cfg)
    size = cfg.tile_size
    tiles = np.random.default_rng(3).integers(0, 255, (2, size, size, 3)
                                              ).astype(np.uint8)
    model_eval = jax_build_model(jcfg, train=False)
    x, _ = jax_prepare_batch(jcfg, jnp.asarray(tiles), None, None)
    variables = {"params": jax.tree_util.tree_map(jnp.asarray, params),
                 "batch_stats": jax.tree_util.tree_map(jnp.asarray, stats)}
    jscales = jquant.calibrate_absmax(model_eval, variables, [x],
                                      train=False)
    quantized = jquant.int8_interceptor(jscales)

    def int8_run(variables, x):  # the weights an argument: no folding
        io = {}

        def record(next_fun, args, kwargs, context):
            out = quantized(next_fun, args, kwargs, context)
            m = context.module
            if isinstance(m, fnn.Conv) and context.method_name == "__call__":
                io["/".join(m.path)] = (args[0], out)
            return out

        with fnn.intercept_methods(record):
            return model_eval.apply(variables, x, train=False), io

    want, io = jax.device_get(jax.jit(int8_run)(variables, x))
    return dict(name=request.param, cfg=cfg, model=model.eval(),
                tiles=tiles, jscales=jscales, want=np.asarray(want), io=io,
                agreement=agreement)


def test_scales_carry_both_ways(net):
    """JAX's calibration through scales_from_jax has the port's key set
    and values (rtol 1e-5: f32 activations in another order), and
    scales_to_jax takes it back; transposed convs (the U-Net's decoder)
    have no scale on either side."""
    cfg, model, jscales = net["cfg"], net["model"], net["jscales"]
    scales = quant.scales_from_jax(cfg, jscales)
    if net["name"] == "mobilenet":  # an in-memory DB, as on the card
        calib = quant.calibration_batches_from_db(
            TileDB(data={"img": net["tiles"].transpose(0, 3, 1, 2),
                         "mask": np.zeros((2, 64, 64), np.uint8),
                         "meta": {}}), cfg, batch=2, device="cpu")
    else:
        calib = [prepare_batch(cfg, torch.from_numpy(net["tiles"]))[0]
                 .permute(0, 3, 1, 2)]
    own = quant.calibrate_absmax(model, calib)
    assert set(own) == set(scales) and len(scales) > 10
    for k in own:
        assert own[k] == pytest.approx(scales[k], rel=1e-5), k
    assert quant.scales_to_jax(cfg, scales) == jscales
    transposed = [n for n, m in model.named_modules()
                  if isinstance(m, torch.nn.ConvTranspose2d)]
    assert (cfg.arch == "unet") == bool(transposed)
    assert not set(transposed) & set(own)
    assert not any("ConvTranspose" in k for k in jscales)
    with pytest.raises(KeyError):
        quant.scales_from_jax(cfg, {"no/such/conv": 1.0})


def test_every_int8_conv_matches_jax_on_its_input(net):
    """Each calibrated conv of the int8 predict, fed the input that conv
    got in the JAX package's int8 run, returns JAX's output up to the
    epilogue's last rounding: the same quantized weights and activations
    and exact int32 sums (depthwise convs included).  The port rounds
    ``float(acc) * scale`` and ``+ bias`` one at a time (so does KQ); XLA
    on the CPU contracts the two into one FMA in some fusions (here) and
    not in others (the TinyNet's, bit-equal), which moves a value by at
    most an ulp of the product and one of the sum (EPILOGUE_ULPS).  A
    quantized input one step off would move it by a quantization step,
    thousands of those ulps."""
    cfg = net["cfg"]
    predict_q = quant.make_predict_int8(
        cfg, net["model"], quant.scales_from_jax(cfg, net["jscales"]))
    paths = {t: j for j, t in quant._path_names(cfg).items()}
    convs = {n: m for n, m in predict_q.model.named_modules()
             if isinstance(m, quant.Int8Conv2d)}
    assert {paths[n] for n in convs} == set(net["jscales"]) == set(net["io"])
    assert any(m.groups > 1 for m in convs.values()) == \
        (net["name"] == "mobilenet")
    with torch.no_grad():
        for name, conv in convs.items():
            x, want = net["io"][paths[name]]
            bias = 0.0 if conv.bias is None else float(conv.bias.abs().max())
            atol = EPILOGUE_ULPS * np.finfo(np.float32).eps * (
                float(np.abs(want).max()) + bias)
            np.testing.assert_allclose(_nhwc(conv(_nchw(np.array(x)))), want,
                                       rtol=0, atol=atol, err_msg=name)


def test_int8_logits_match_jax(net):
    """make_predict_int8 serves each model exactly where make_predict
    does; its logits track the float path (tests/test_quant.py's limits)
    and JAX's int8 logits.  An activation within an ulp of a rounding tie
    (the float parts round in other orders in the two packages) quantizes
    one step apart, which moves the next conv by an input step times a
    weight, the size of the quantization error itself: the logits are held
    within the JAX int8 run's own distance from float (max abs), and the
    class maps to the model's agreement (the JAX test's 0.9 for the
    MobileNetV2, whose random-init logits are near-ties, 0.99 otherwise)."""
    cfg, model, tiles = net["cfg"], net["model"], net["tiles"]
    predict_q = quant.make_predict_int8(
        cfg, model, quant.scales_from_jax(cfg, net["jscales"]))
    if cfg.arch == "unet":  # the decoder's transposed convs stay float
        assert any(isinstance(m, torch.nn.ConvTranspose2d)
                   for m in predict_q.model.modules())
    ref = make_predict(cfg, model)(torch.from_numpy(tiles)).numpy()
    got = predict_q(torch.from_numpy(tiles)).numpy()
    assert got.shape == ref.shape and got.dtype == np.float32
    err = float(np.abs(got - ref).max() / (np.abs(ref).max() + 1e-9))
    assert err < 0.15, f"relative error {err:.4f}"
    assert float(np.mean(got.argmax(-1) == ref.argmax(-1))) > 0.9
    want = net["want"]
    assert got.shape == want.shape
    # JAX's float logits are the port's within f32 ulps (tests/
    # test_torch_models.py): the port's stand for them
    assert np.abs(got - want).max() <= np.abs(want - ref).max()
    agree = float(np.mean(got.argmax(-1) == want.argmax(-1)))
    assert agree >= net["agreement"], f"argmax agreement {agree}"
    # the float predict on the same model is untouched
    np.testing.assert_array_equal(
        make_predict(cfg, model)(torch.from_numpy(tiles)).numpy(), ref)


@pytest.mark.parametrize("source", ["path", "memory"])
def test_calibration_batches_from_db(tmp_path, source):
    rng = np.random.default_rng(5)
    imgs = rng.integers(0, 255, (12, 3, 32, 32)).astype(np.uint8)
    masks = rng.integers(0, 9, (12, 32, 32)).astype(np.uint8)
    jcfg = JaxConfig().replace(ch=3, tile_size=32, n_tiles=12)
    cfg = Config().replace(ch=3, tile_size=32, n_tiles=12)
    path = str(tmp_path / "q.h5")
    JaxTileDB.save(path, imgs, masks, jcfg)
    db = path if source == "path" else \
        TileDB(data={"img": imgs, "mask": masks, "meta": {}})
    batches = quant.calibration_batches_from_db(db, cfg, n_tiles=10,
                                                batch=4, device="cpu")
    assert [b.shape[0] for b in batches] == [4, 4, 2]
    assert all(b.shape[1:] == (3, 32, 32) for b in batches)
    assert all(b.is_contiguous(memory_format=torch.channels_last)
               for b in batches)
    # the same normalize as the JAX package's
    want = jquant.calibration_batches_from_db(path, jcfg, n_tiles=10,
                                              batch=4)
    for b, w in zip(batches, want):
        np.testing.assert_allclose(_nhwc(b), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)
    assert float(batches[0].abs().max()) < 50.0


@pytest.fixture(scope="module")
def unet_int8():
    """A small U-Net's int8 Segmenter pieces: (cfg, float model, scales,
    photo)."""
    cfg = Config().replace(compute_dtype="float32", tile_size=64, **UNET)
    torch.manual_seed(0)
    model = build_model(cfg).eval()
    photo = np.random.default_rng(7).integers(0, 255, (128, 128, 3)
                                              ).astype(np.uint8)
    tiles = torch.from_numpy(photo[None, :64, :64].copy())
    calib = prepare_batch(cfg, tiles)[0].permute(0, 3, 1, 2)
    return cfg, model, quant.calibrate_absmax(model, [calib]), photo


class _ReplicaMesh(Mesh):
    """A mesh whose second distinct device is the CPU again, so that the
    Segmenter builds a replica predict for it, and every tile on the CPU
    goes through that replica."""

    @property
    def distinct(self):
        return [self.devices[0], self.devices[0]]


def test_mesh_segmenter_serves_int8(unet_int8):
    """An int8 Segmenter on a mesh of CPU entries gives one device's class
    map, and the predict it rebuilds for another device of the mesh
    (``predict.remake`` on a copy of ``predict.model``) is the int8 one."""
    cfg, model, scales, photo = unet_int8
    cpu = torch.device("cpu")
    predict_q = quant.make_predict_int8(cfg, model, scales)
    one = Segmenter(cfg, predict_q, cpu, batch_size=2).segment_array(photo)
    for mesh in (Mesh([cpu, cpu]), _ReplicaMesh([cpu, cpu])):
        seg = Segmenter(cfg, predict_q, cpu, batch_size=2, mesh=mesh)
        got = seg.segment_array(photo)
        np.testing.assert_array_equal(got["class_map"], one["class_map"])
        # the bands stitch their tiles in another order (f32 ulps)
        torch.testing.assert_close(got["probs"], one["probs"], rtol=0,
                                   atol=1e-6)
    replica = seg._predicts[cpu]
    assert replica is not predict_q and replica.model is not predict_q.model
    assert any(isinstance(m, quant.Int8Conv2d)
               for m in replica.model.modules())
    tiles = torch.from_numpy(photo[None, :64, :64].copy())
    assert torch.equal(replica(tiles), predict_q(tiles))
    assert not torch.equal(make_predict(cfg, model)(tiles), predict_q(tiles))


def _call_targets(program):
    """Every call's target in an exported program, nested graphs (the
    autocast region) included."""
    return [n.target for gm in program.graph_module.modules()
            if isinstance(gm, torch.fx.GraphModule)
            for n in gm.graph.nodes if n.op == "call_function"]


def test_export_int8_segmenter(unet_int8, tmp_path):
    """An int8 Segmenter exports with pylc::quantize_int8 and
    pylc::int8_conv2d in the program, once per calibrated conv and forward
    batch, and the artifact's class map is the live Segmenter's."""
    cfg, model, scales, photo = unet_int8
    seg = Segmenter(cfg, quant.make_predict_int8(cfg, model, scales),
                    torch.device("cpu"), batch_size=4)
    program = export_segmenter(seg, 128, 128)
    targets = _call_targets(program)
    n_convs = sum(isinstance(m, quant.Int8Conv2d)
                  for m in seg.predict.model.modules())
    n_batches = 3  # 9 tiles of 64 px at stride 32, 4 a batch
    assert n_convs == len(scales)
    assert targets.count(torch.ops.pylc.int8_conv2d.default) == \
        targets.count(torch.ops.pylc.quantize_int8.default) == \
        n_convs * n_batches
    live = seg.segment_array(photo)["class_map"]
    with torch.inference_mode():
        np.testing.assert_array_equal(
            program.module()(torch.from_numpy(photo)).numpy(), live)
    path = str(tmp_path / "int8.pylct")
    save_artifact(path, seg, 128, 128)
    np.testing.assert_array_equal(
        ServingModel.load(path, "cpu").segment(photo)["class_map"], live)


def test_remake_builds_the_same_predict(unet_int8):
    """predict.remake on a copy of predict.model gives the same logits,
    for the float and the int8 predict."""
    cfg, model, scales, photo = unet_int8
    tiles = torch.from_numpy(photo[None, :64, :64].copy())
    for predict in (make_predict(cfg, model),
                    quant.make_predict_int8(cfg, model, scales)):
        again = predict.remake(copy.deepcopy(predict.model))
        assert torch.equal(again(tiles), predict(tiles))
