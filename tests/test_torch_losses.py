"""The port's losses against the JAX package's, in f32 on the CPU.

``multi_loss`` (plain torch) against JAX ``multi_loss``, and
``fused_multi_loss`` (on the CPU: the plain versions of kernels K2a and
K2b) against JAX ``fused_multi_loss`` (the Pallas kernels in interpret
mode).  Inputs come from a numpy seed; the port takes NCHW logits, JAX
NHWC.  Values agree at rtol 1e-5; gradients (torch autograd against
``jax.grad``) at rtol 2e-4, atol 1e-7, the tolerance of
tests/test_pallas_loss.py: the sums run in another order."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pylc_tpu.ops.losses import LossWeights as JaxLossWeights
from pylc_tpu.ops.losses import multi_loss as jax_multi_loss
from pylc_tpu.ops.pallas import fused_loss as jax_fl
from pylc_tpu.ops.pallas.fused_loss import fused_multi_loss as jax_fused
from pylc_tpu_torch.ops.kernels import fused_loss as fl
from pylc_tpu_torch.ops.losses import LossWeights, multi_loss

torch.set_num_threads(1)

VALUE_RTOL = 1e-5
GRAD_TOL = dict(rtol=2e-4, atol=1e-7)


def _inputs(seed, B, H, W, C, out_of_range=False):
    """Logits, uint8 targets and class weights.  ``out_of_range`` sets a
    tenth of the targets to 255: no class.  (The Pallas kernel pads the
    classes to a multiple of 8 with -1e30 logits, so a target in
    [C, that multiple) would hit a padded class there: ROADMAP Queue 3.)"""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, H, W, C)).astype(np.float32) * 2
    t = rng.integers(0, C, size=(B, H, W)).astype(np.uint8)
    if out_of_range:
        t[rng.random(t.shape) < 0.1] = 255
    cw = (rng.random(C) + 0.2).astype(np.float32)
    return x, t, cw


def _torch_x(x_nhwc, channels_last=False):
    t = torch.from_numpy(x_nhwc.copy()).permute(0, 3, 1, 2)
    t = t.contiguous(memory_format=torch.channels_last if channels_last
                     else torch.contiguous_format)
    return t.requires_grad_(True)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _f(v):
    return float(v.detach()) if torch.is_tensor(v) else float(v)


def _check(total, aux, jtotal, jaux):
    np.testing.assert_allclose(_f(total), _f(jtotal), rtol=VALUE_RTOL)
    for k in ("ce", "dice", "focal"):
        np.testing.assert_allclose(_f(aux[k]), _f(jaux[k]),
                                   rtol=VALUE_RTOL, err_msg=k)


def test_loss_weights_match_jax():
    assert LossWeights()._asdict() == JaxLossWeights()._asdict()


@pytest.mark.parametrize("case", ["plain", "weighted", "sample_mask",
                                  "eleven_classes"])
def test_multi_loss_matches_jax(case):
    C = 11 if case == "eleven_classes" else 9
    x, t, cw = _inputs(0, 3, 12, 10, C)
    w = LossWeights(weighted=case == "weighted")
    jw = JaxLossWeights(weighted=case == "weighted")
    sm = np.array([1, 1, 0], np.float32) if case == "sample_mask" else None

    def jloss(xx):
        return jax_multi_loss(xx, jnp.asarray(t), jnp.asarray(cw), jw,
                              None if sm is None else jnp.asarray(sm))

    (jtotal, jaux), jgrad = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(x))
    xt = _torch_x(x)
    total, aux = multi_loss(xt, torch.from_numpy(t), torch.from_numpy(cw),
                            w, None if sm is None else torch.from_numpy(sm))
    total.backward()
    _check(total, aux, jtotal, jaux)
    np.testing.assert_allclose(_nhwc(xt.grad), np.asarray(jgrad), **GRAD_TOL)


@pytest.mark.parametrize("shape,weighted,out_of_range", [
    ((2, 16, 16, 9), False, False),
    ((2, 16, 16, 9), True, False),
    ((1, 37, 29, 11), True, False),    # no block of either kernel divides N
    ((1, 37, 29, 11), False, True),    # targets >= C
    ((1, 37, 29, 11), True, True),
    # more classes than the card's register-held kernels take: the wide
    # kernels' plain versions against the Pallas kernels
    ((1, 21, 19, 20), True, False),
    ((1, 21, 19, 20), False, True),
    ((1, 9, 7, 128), True, True),      # the Pallas loss's largest C
])
def test_fused_multi_loss_matches_jax(shape, weighted, out_of_range):
    B, H, W, C = shape
    x, t, cw = _inputs(1, B, H, W, C, out_of_range)
    assert (t >= C).any() == out_of_range
    w = LossWeights(weighted=weighted)
    jw = JaxLossWeights(weighted=weighted)

    def jloss(xx):
        return jax_fused(xx, jnp.asarray(t.astype(np.int32)),
                         jnp.asarray(cw), jw)

    (jtotal, jaux), jgrad = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(x))
    xt = _torch_x(x)
    launches = (fl.fused_loss_forward.launches,
                fl.fused_loss_backward.launches)
    total, aux = fl.fused_multi_loss(xt, torch.from_numpy(t),
                                     torch.from_numpy(cw), w)
    total.backward()
    # the CPU path runs the plain versions and launches nothing
    assert (fl.fused_loss_forward.launches,
            fl.fused_loss_backward.launches) == launches
    assert not any(v.requires_grad for v in aux.values())
    _check(total, aux, jtotal, jaux)
    np.testing.assert_allclose(_nhwc(xt.grad), np.asarray(jgrad), **GRAD_TOL)


def test_fused_multi_loss_matches_plain_multi_loss():
    x, t, cw = _inputs(2, 2, 20, 24, 9)
    w = LossWeights(weighted=True)
    a, b = _torch_x(x), _torch_x(x)
    ta, aux_a = multi_loss(a, torch.from_numpy(t), torch.from_numpy(cw), w)
    tb, aux_b = fl.fused_multi_loss(b, torch.from_numpy(t),
                                    torch.from_numpy(cw), w)
    (ta + tb).backward()
    _check(tb, aux_b, ta, aux_a)
    np.testing.assert_allclose(b.grad.numpy(), a.grad.numpy(), **GRAD_TOL)


def test_fused_gradient_scales_with_cotangent():
    x, t, _ = _inputs(3, 1, 8, 8, 4)
    g = []
    for scale in (1.0, 3.0):
        xt = _torch_x(x)
        total, _ = fl.fused_multi_loss(xt, torch.from_numpy(t), None,
                                       LossWeights())
        (scale * total).backward()
        g.append(xt.grad.numpy())
    np.testing.assert_allclose(g[1], 3.0 * g[0], rtol=1e-5)


def test_fused_layouts_agree():
    """channels_last and contiguous NCHW logits give the same loss and
    gradient, and the gradient comes back in the logits' layout."""
    x, t, cw = _inputs(4, 2, 9, 13, 9)
    out = []
    for cl in (False, True):
        xt = _torch_x(x, channels_last=cl)
        assert xt.is_contiguous(
            memory_format=torch.channels_last if cl
            else torch.contiguous_format)
        total, _ = fl.fused_multi_loss(xt, torch.from_numpy(t),
                                       torch.from_numpy(cw),
                                       LossWeights(weighted=True))
        total.backward()
        out.append((_f(total), xt.grad.numpy()))
    assert out[0][0] == pytest.approx(out[1][0], rel=1e-6)
    np.testing.assert_allclose(out[1][1], out[0][1], rtol=1e-6, atol=1e-9)


def test_reference_statistics_layout():
    """acc = [inter (C), sump (C), cnt (C), nll_sum, wsum, focal_sum,
    count] from the plain K2a, checked against direct sums."""
    x, t, cw = _inputs(5, 1, 5, 7, 9, out_of_range=True)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    tt = torch.from_numpy(t)
    acc = fl.fused_forward_reference(xt, tt, torch.from_numpy(cw),
                                     LossWeights(weighted=True))
    C = 9
    p = torch.softmax(xt, 1)
    inrange = tt.long() < C
    assert acc.shape == (3 * C + 4,)
    np.testing.assert_allclose(acc[C:2 * C].numpy(),
                               p.sum((0, 2, 3)).numpy(), rtol=1e-5)
    cnt = np.bincount(t[t < C].ravel(), minlength=C)
    np.testing.assert_array_equal(acc[2 * C:3 * C].numpy(), cnt)
    np.testing.assert_allclose(float(acc[3 * C + 1]),
                               cw[t[t < C]].sum(), rtol=1e-5)
    assert float(acc[3 * C + 3]) == t.size
    assert int(inrange.sum()) == cnt.sum()


def test_kernel_wrappers_refuse_bad_operands():
    """What the CUDA wrappers check is device-independent; on the CPU the
    plain version runs, so the checks are exercised directly."""
    x = torch.zeros(1, 129, 4, 4)
    t = torch.zeros(1, 4, 4, dtype=torch.uint8)
    with pytest.raises(ValueError, match="MAX_CLASSES = 128, the JAX "
                                         "package's own limit"):
        fl._check(x, t, None, "k")
    with pytest.raises(ValueError, match="channels_last"):
        fl._check(torch.zeros(1, 4, 4, 9).permute(0, 3, 2, 1), t, None, "k")
    with pytest.raises(ValueError, match="uint8"):
        fl._check(torch.zeros(1, 9, 4, 4), t.long(), None, "k")
    C, N, HW, sB, sC, sP, cw = fl._check(
        torch.zeros(2, 9, 4, 5).contiguous(memory_format=torch.channels_last),
        torch.zeros(2, 4, 5, dtype=torch.uint8), None, "k")
    assert (C, N, HW, sB, sC, sP) == (9, 40, 20, 180, 1, 9)
    assert torch.equal(cw, torch.ones(9))


@pytest.mark.parametrize("C", [1, 16, 17, 20, 128])
def test_kernel_wrappers_take_up_to_128_classes(C):
    """K2a and K2b take every class count the Pallas loss takes."""
    for x in (torch.zeros(2, C, 3, 5),
              torch.zeros(2, C, 3, 5).contiguous(
                  memory_format=torch.channels_last)):
        got = fl._check(x, torch.zeros(2, 3, 5, dtype=torch.uint8), None,
                        "k")
        assert got[:3] == (C, 30, 15)


def _cl(*shape):
    return torch.zeros(*shape).contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("logits,aligned,code,name", [
    (_cl(8, 9, 16, 16), True, 2, "staged<C=9>"),       # the train step's
    (_cl(1, 11, 37, 29), True, 2, "staged<C=11>"),     # ragged span
    (_cl(1, 11, 5, 1), True, 2, "staged<C=11>"),       # W = 1
    (_cl(2, 9, 4, 4), False, 1, "direct<C=9>"),        # unaligned storage
    (torch.zeros(2, 9, 4, 4), True, 1, "direct<C=9>"),  # contiguous NCHW
    (torch.zeros(1, 11, 37, 29), True, 1, "direct<C=11>"),
    (_cl(2, 10, 4, 4), True, 0, "direct<runtime C>"),  # an even stride
    (_cl(2, 4, 4, 4), True, 0, "direct<runtime C>"),
    (torch.zeros(2, 16, 3, 3), True, 0, "direct<runtime C>"),
    (_cl(2, 17, 4, 4), True, 4, "wide-staged"),        # past the registers
    (torch.zeros(2, 20, 3, 3), True, 3, "wide"),
    (_cl(1, 128, 5, 3), False, 3, "wide"),
    (_cl(1, 128, 5, 3), True, 4, "wide-staged"),
    (_cl(2, 20, 1, 7), True, 4, "wide-staged"),        # H = 1
    (torch.zeros(1, 17, 5, 3), True, 3, "wide"),
], ids=lambda v: v if isinstance(v, str) else None)
def test_backward_variant_choice(logits, aligned, code, name):
    """Which K2b kernel a layout gets: the staged ones only for dense
    channels_last logits, below 17 classes with a schema's (odd) class
    count."""
    assert fl.backward_variant_code(logits, aligned) == code
    assert fl.VARIANTS[code].format(C=logits.shape[1]) == name
    if aligned:
        assert fl.backward_variant(logits) == name


@pytest.mark.parametrize("logits,code,name", [
    (_cl(8, 9, 16, 16), 1, "direct<C=9>"),             # the train step's
    (_cl(3, 9, 61, 53), 1, "direct<C=9>"),             # ragged last block
    (_cl(1, 11, 37, 29), 1, "direct<C=11>"),
    (_cl(1, 11, 5, 1), 1, "direct<C=11>"),             # W = 1
    (torch.zeros(2, 9, 4, 4), 1, "direct<C=9>"),       # contiguous NCHW
    (torch.zeros(1, 11, 37, 29), 1, "direct<C=11>"),
    (_cl(2, 10, 4, 4), 0, "direct<runtime C>"),
    (_cl(2, 1, 4, 4), 0, "direct<runtime C>"),         # one class
    (torch.zeros(2, 16, 3, 3), 0, "direct<runtime C>"),
    (_cl(2, 17, 4, 4), 4, "wide-staged"),
    (torch.zeros(2, 20, 3, 3), 3, "wide"),
    (_cl(1, 128, 5, 3), 4, "wide-staged"),
    (_cl(2, 20, 1, 7), 4, "wide-staged"),              # H = 1
    (_cl(1, 33, 5, 1), 4, "wide-staged"),              # W = 1
    (torch.zeros(1, 17, 5, 3), 3, "wide"),
    (torch.zeros(1, 128, 4, 4), 3, "wide"),
], ids=lambda v: v if isinstance(v, str) else None)
def test_forward_variant_choice(logits, code, name):
    """Which K2a kernel a tensor gets: up to 16 classes by the class count
    alone, whatever the layout; above, the wide staged kernel for dense
    channels_last logits and the wide kernel for contiguous NCHW."""
    assert fl.forward_variant_code(logits) == code
    assert fl.VARIANTS[code].format(C=logits.shape[1]) == name
    assert fl.forward_variant(logits) == name


def test_forward_variant_takes_an_unaligned_pointer():
    """A view 4 bytes into 16-byte aligned storage is dense channels_last
    and not aligned: K2b's direct kernel, K2a's direct kernel as ever up
    to 16 classes, and above them the wide kernels where aligned logits
    get the wide staged ones."""
    def unaligned(C):
        flat = torch.zeros(2 * 4 * 4 * C + 1)
        assert flat.data_ptr() % 16 == 0
        x = flat[1:].view(2, 4, 4, C).permute(0, 3, 1, 2)
        assert x.is_contiguous(memory_format=torch.channels_last)
        assert x.data_ptr() % 16 == 4
        return x

    x = unaligned(9)
    assert fl.backward_variant(x) == "direct<C=9>"
    assert fl.backward_variant(_cl(2, 9, 4, 4)) == "staged<C=9>"
    assert fl.forward_variant(x) == fl.forward_variant(_cl(2, 9, 4, 4)) \
        == "direct<C=9>"
    x = unaligned(20)
    assert fl.forward_variant_code(x, aligned=False) == 3
    assert fl.forward_variant(x) == fl.backward_variant(x) == "wide"
    assert fl.forward_variant(_cl(2, 20, 4, 4)) == \
        fl.backward_variant(_cl(2, 20, 4, 4)) == "wide-staged"


def test_backward_variant_known_classes_are_the_schemas_and_odd():
    from pylc_tpu_torch.config import Schema
    assert set(fl.KNOWN_CLASSES) == {Schema.load(s).n_classes
                                     for s in ("schema_a", "schema_b")}
    assert all(c % 2 == 1 for c in fl.KNOWN_CLASSES)  # bank-conflict free
    with open(fl.SOURCE) as f:
        src = f.read()
    for c in fl.KNOWN_CLASSES:
        for kernel in ("backward_staged", "backward_direct",
                       "forward_direct"):
            assert f"fused_loss_{kernel}_kernel<{c}>" in src


@pytest.mark.parametrize("shape,cl", [((2, 9, 5, 7), True),
                                      ((1, 11, 37, 29), True),
                                      ((1, 11, 37, 29), False),
                                      ((3, 10, 4, 6), True)])
def test_plain_backward_at_each_variants_layout(shape, cl):
    """The plain K2b on the layouts of each kernel variant (a span that
    ends ragged, an even class count) against autograd of multi_loss."""
    B, C, H, W = shape
    x, t, cw = _inputs(7, B, H, W, C)
    w = LossWeights(weighted=True)
    xt = _torch_x(x, channels_last=cl)
    tt, cwt = torch.from_numpy(t), torch.from_numpy(cw)
    total, _ = multi_loss(xt, tt, cwt, w)
    total.backward()
    acc = fl.fused_loss_forward(xt.detach(), tt, cwt, w)
    dx = fl.fused_loss_backward(xt.detach(), tt, cwt, acc,
                                torch.tensor(1.0), w)
    np.testing.assert_allclose(dx.numpy(), xt.grad.numpy(), **GRAD_TOL)


@pytest.mark.parametrize("C", [17, 31, 32, 33, 64, 65, 127, 128])
def test_plain_backward_matches_pallas_at_wide_boundaries(C):
    """Class counts at the edges of the wide staged K2b (its span of 256,
    128 or 64 pixels changes at 33 and 65 classes; its per-lane starting
    class depends on the largest power of two dividing C): the dense
    channels_last logits it takes, a ragged last span, a tenth of the
    targets outside [0, C); the plain K2b's dlogits against the Pallas
    backward kernel in interpret mode."""
    B, H, W = 1, 7, 9
    x, t, cw = _inputs(C, B, H, W, C, out_of_range=True)
    w = LossWeights(weighted=C % 2 == 1)
    jw = JaxLossWeights(weighted=C % 2 == 1)

    def jloss(xx):
        return jax_fused(xx, jnp.asarray(t.astype(np.int32)),
                         jnp.asarray(cw), jw)[0]

    jgrad = jax.grad(jloss)(jnp.asarray(x))
    xt = _torch_x(x, channels_last=True)
    assert fl.backward_variant(xt) == "wide-staged"
    total, _ = fl.fused_multi_loss(xt, torch.from_numpy(t),
                                   torch.from_numpy(cw), w)
    total.backward()
    assert xt.grad.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(_nhwc(xt.grad), np.asarray(jgrad), **GRAD_TOL)


def _pallas_statistics(x_nhwc, t, cw, jw):
    """The 3C + 4 statistics from the Pallas forward kernel in interpret
    mode, in the port's order."""
    C = x_nhwc.shape[-1]
    xT, tT, cwp, N = jax_fl._prep(jnp.asarray(x_nhwc),
                                  jnp.asarray(t.astype(np.int32)),
                                  jnp.asarray(cw))
    acc = np.asarray(jax_fl._fused_forward(xT, tT, cwp, jw, N))
    scalars = acc[[jax_fl._NLL, jax_fl._WSUM, jax_fl._FOCAL, jax_fl._COUNT],
                  jax_fl._SCALAR]
    return np.concatenate([acc[:C, jax_fl._INTER], acc[:C, jax_fl._SUMP],
                           acc[:C, jax_fl._CNT], scalars])


@pytest.mark.parametrize("shape,cl,weighted", [
    ((3, 9, 61, 53), True, True),      # 12 whole chunks of 256 and one of 161
    ((3, 9, 61, 53), True, False),
    ((1, 11, 37, 29), True, True),     # schema_b's classes
    ((1, 11, 37, 29), False, True),    # contiguous NCHW
    ((3, 10, 4, 6), True, True),       # run-time class count
    ((2, 4, 33, 65), False, False),
    # past 16 classes: the wide staged kernel (channels_last; its span of
    # 256, 128 or 64 pixels changes at 33 and 65 classes) and the wide
    # kernel (contiguous NCHW)
    ((1, 17, 7, 9), True, True),
    ((2, 20, 9, 11), True, False),
    ((2, 20, 9, 11), False, True),
    ((2, 33, 5, 7), True, True),
    ((1, 128, 5, 6), True, False),
    ((1, 128, 4, 5), False, True),
])
def test_plain_forward_at_each_variants_layout(shape, cl, weighted):
    """The plain K2a on the layouts of each kernel variant, with an N no
    block divides and a tenth of the targets outside [0, C), against the
    Pallas kernel in interpret mode, statistic by statistic."""
    B, C, H, W = shape
    x, t, cw = _inputs(9, B, H, W, C, out_of_range=True)
    xt = _torch_x(x, channels_last=cl).detach()
    assert fl.forward_variant(xt) == (
        ("wide-staged" if cl else "wide") if C > fl.NARROW_CLASSES else
        f"direct<C={C}>" if C in fl.KNOWN_CLASSES else "direct<runtime C>")
    got = fl.fused_loss_forward(xt, torch.from_numpy(t),
                                torch.from_numpy(cw),
                                LossWeights(weighted=weighted))
    want = _pallas_statistics(x, t, cw, JaxLossWeights(weighted=weighted))
    assert got.shape == (3 * C + 4,)
    np.testing.assert_allclose(got.numpy(), want, rtol=VALUE_RTOL)


GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "reference_goldens.npz")


@pytest.mark.parametrize("loss", ["multi_loss", "fused_multi_loss"])
@pytest.mark.parametrize("channels_last", [False, True],
                         ids=["contiguous", "channels_last"])
def test_loss_goldens(loss, channels_last):
    """The reference implementation's loss values (the goldens of
    tests/test_golden_parity.py::test_multi_loss_golden, at its
    tolerances) through the port's plain and fused losses."""
    g = np.load(GOLDEN)
    pred = torch.from_numpy(g["loss_pred"]).contiguous(
        memory_format=torch.channels_last if channels_last
        else torch.contiguous_format)
    tgt = torch.from_numpy(g["loss_target"].astype(np.uint8))
    ce_ref, dice_ref, focal_ref, total_ref = g["loss_values"]
    fn = multi_loss if loss == "multi_loss" else fl.fused_multi_loss
    total, aux = fn(pred, tgt)
    np.testing.assert_allclose(_f(aux["ce"]), ce_ref, rtol=1e-5)
    np.testing.assert_allclose(_f(aux["dice"]), dice_ref, rtol=1e-5)
    np.testing.assert_allclose(_f(aux["focal"]), focal_ref, rtol=1e-4)
    np.testing.assert_allclose(_f(total), total_ref, rtol=1e-4)


def test_kernel_wrappers_refuse_a_batch_beyond_the_grid():
    x = torch.zeros(1, 9, 1, 1).expand(fl.MAX_BATCH + 1, 9, 1, 1)
    t = torch.zeros(fl.MAX_BATCH + 1, 1, 1, dtype=torch.uint8)
    with pytest.raises(ValueError, match="channels_last|65535"):
        fl._check(x, t, None, "k")
    x = torch.zeros(fl.MAX_BATCH + 1, 9, 1, 1)
    with pytest.raises(ValueError, match="65535"):
        fl._check(x, t, None, "k")


def test_direct_yardstick_has_no_cpu_form():
    x, t, cw = _inputs(8, 1, 4, 4, 9)
    xt = _torch_x(x).detach()
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        fl.fused_loss_backward_direct(
            xt, torch.from_numpy(t), None, torch.zeros(31),
            torch.tensor(1.0), LossWeights())
    assert fl.fused_loss_backward.launches == 0
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        fl.fused_loss_forward_direct(xt, torch.from_numpy(t), None,
                                     LossWeights())
    assert fl.fused_loss_forward.launches == 0


def test_kernel_source_states_the_bound():
    """The card builds K2 from the package's own source, whose class bound
    is the wrapper's, and whose header says what bounds each kernel."""
    assert os.path.exists(fl.SOURCE)
    with open(fl.SOURCE) as f:
        src = f.read()
    assert f"constexpr int kMaxC = {fl.MAX_CLASSES};" in src
    header = src[:src.index("#include")]
    # K2a reads 77.6 MB at the train step's shape: 23 us at 3.35 TB/s
    assert "K2a must read 77.6 MB (23 us at" in header
    assert "3.35 TB/s" in header and "device memory bounds both" in header
    assert "fused_loss_forward_direct_kernel<C>" in header
    assert "fused_loss_forward_staged" not in src  # tried, timed, not kept
