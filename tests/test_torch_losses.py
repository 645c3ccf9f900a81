"""The port's losses against the JAX package's, in f32 on the CPU.

``multi_loss`` (plain torch) against JAX ``multi_loss``, and
``fused_multi_loss`` (on the CPU: the plain versions of kernels K2a and
K2b) against JAX ``fused_multi_loss`` (the Pallas kernels in interpret
mode).  Inputs come from a numpy seed; the port takes NCHW logits, JAX
NHWC.  Values agree at rtol 1e-5; gradients (torch autograd against
``jax.grad``) at rtol 2e-4, atol 1e-7, the tolerance of
tests/test_pallas_loss.py: the sums run in another order."""

import json
import os
import re

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


def _unaligned(B, C, H, W):
    """Dense channels_last logits 4 bytes into 16-byte aligned storage."""
    flat = torch.zeros(B * H * W * C + 1)
    assert flat.data_ptr() % 16 == 0
    x = flat[1:].view(B, H, W, C).permute(0, 3, 1, 2)
    assert x.is_contiguous(memory_format=torch.channels_last)
    assert x.data_ptr() % 16 == 4
    return x


# every class count with kernels of its own, on the three layouts: dense
# channels_last (the train step's), the same unaligned, contiguous NCHW (at
# one class the same memory as channels_last)
NARROW_LAYOUTS = [
    case for C in range(1, fl.NARROW_CLASSES + 1) for case in (
        (_cl(2, C, 5, 3), True, 2, 1, f"staged<C={C}>"),
        (_unaligned(2, C, 5, 3), False, 1, 1, f"direct<C={C}>"),
        (torch.zeros(2, C, 5, 3), True, 2 if C == 1 else 1, 1,
         f"staged<C={C}>" if C == 1 else f"direct<C={C}>"))]


@pytest.mark.parametrize("logits,aligned,code,name", [
    (_cl(8, 9, 16, 16), True, 2, "staged<C=9>"),       # the train step's
    (_cl(1, 11, 37, 29), True, 2, "staged<C=11>"),     # ragged span
    (_cl(1, 11, 5, 1), True, 2, "staged<C=11>"),       # W = 1
    (_cl(2, 9, 4, 4), False, 1, "direct<C=9>"),        # unaligned storage
    (torch.zeros(2, 9, 4, 4), True, 1, "direct<C=9>"),  # contiguous NCHW
    (torch.zeros(1, 11, 37, 29), True, 1, "direct<C=11>"),
    (_cl(2, 10, 4, 4), True, 2, "staged<C=10>"),       # an even stride
    (_cl(2, 4, 4, 4), True, 2, "staged<C=4>"),
    (torch.zeros(2, 16, 3, 3), True, 1, "direct<C=16>"),
    (_cl(2, 17, 4, 4), True, 4, "wide-staged"),        # past the registers
    (torch.zeros(2, 20, 3, 3), True, 3, "wide"),
    (_cl(1, 128, 5, 3), False, 3, "wide"),
    (_cl(1, 128, 5, 3), True, 4, "wide-staged"),
    (_cl(2, 20, 1, 7), True, 4, "wide-staged"),        # H = 1
    (torch.zeros(1, 17, 5, 3), True, 3, "wide"),
    *[(x, aligned, code, name) for x, aligned, code, _, name
      in NARROW_LAYOUTS],
], ids=lambda v: v if isinstance(v, str) else None)
def test_backward_variant_choice(logits, aligned, code, name):
    """Which K2b kernel a layout gets: up to 16 classes the staged kernel
    of the class count for dense channels_last logits and its direct
    kernel for every other layout; above, the wide ones likewise."""
    assert fl.backward_variant_code(logits, aligned) == code
    assert fl.VARIANTS[code].format(C=logits.shape[1]) == name
    if aligned == (logits.data_ptr() % 16 == 0):
        assert fl.backward_variant(logits) == name


@pytest.mark.parametrize("logits,code,name", [
    (_cl(8, 9, 16, 16), 1, "direct<C=9>"),             # the train step's
    (_cl(3, 9, 61, 53), 1, "direct<C=9>"),             # ragged last block
    (_cl(1, 11, 37, 29), 1, "direct<C=11>"),
    (_cl(1, 11, 5, 1), 1, "direct<C=11>"),             # W = 1
    (torch.zeros(2, 9, 4, 4), 1, "direct<C=9>"),       # contiguous NCHW
    (torch.zeros(1, 11, 37, 29), 1, "direct<C=11>"),
    (_cl(2, 10, 4, 4), 1, "direct<C=10>"),
    (_cl(2, 1, 4, 4), 1, "direct<C=1>"),               # one class
    (torch.zeros(2, 16, 3, 3), 1, "direct<C=16>"),
    (_cl(2, 17, 4, 4), 4, "wide-staged"),
    (torch.zeros(2, 20, 3, 3), 3, "wide"),
    (_cl(1, 128, 5, 3), 4, "wide-staged"),
    (_cl(2, 20, 1, 7), 4, "wide-staged"),              # H = 1
    (_cl(1, 33, 5, 1), 4, "wide-staged"),              # W = 1
    (torch.zeros(1, 17, 5, 3), 3, "wide"),
    (torch.zeros(1, 128, 4, 4), 3, "wide"),
    *[(x, code, f"direct<C={x.shape[1]}>")
      for x, _, _, code, _ in NARROW_LAYOUTS],
], ids=lambda v: v if isinstance(v, str) else None)
def test_forward_variant_choice(logits, code, name):
    """Which K2a kernel a tensor gets: up to 16 classes the direct kernel
    of the class count, whatever the layout and alignment; above, the wide
    staged kernel for dense channels_last logits and the wide kernel for
    contiguous NCHW."""
    assert fl.forward_variant_code(logits, logits.data_ptr() % 16 == 0) \
        == code
    assert fl.VARIANTS[code].format(C=logits.shape[1]) == name
    assert fl.forward_variant(logits) == name


def test_forward_variant_takes_an_unaligned_pointer():
    """A view 4 bytes into 16-byte aligned storage is dense channels_last
    and not aligned: K2b's direct kernel, K2a's direct kernel as ever up
    to 16 classes, and above them the wide kernels where aligned logits
    get the wide staged ones."""
    def unaligned(C):
        return _unaligned(2, C, 4, 4)

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
    """Every class count from 1 to NARROW_CLASSES, both schemas' among
    them, has its own K2a direct, K2b staged and K2b direct kernels in the
    source: the dispatch's list of class counts is exactly 1..16, each
    kernel (K2a's in two forms, without and with a register budget) is
    launched through it with its class count compiled in, and no run-time
    class count is left (the staged kernel takes even class counts too)."""
    from pylc_tpu_torch.config import Schema
    counts = list(range(1, fl.NARROW_CLASSES + 1))
    assert {Schema.load(s).n_classes
            for s in ("schema_a", "schema_b")} <= set(counts)
    with open(fl.SOURCE) as f:
        src = f.read()
    assert f"constexpr int kNarrowC = {fl.NARROW_CLASSES};" in src
    listed = re.search(r"using NarrowClasses = std::integer_sequence<int,"
                       r"([\d,\s]+)>;", src)
    assert [int(c) for c in listed.group(1).split(",")] == counts
    for kernel in ("backward_staged", "backward_direct"):
        launch = f"fused_loss_{kernel}_kernel<decltype(ct)::value>"
        assert src.count(launch) == 1, kernel
        before = src[:src.index(launch)]
        assert before.rstrip().endswith(
            "with_class_count(C, [&](auto ct) {"), kernel
    # K2a: one kernel up to 9 classes, one with a register budget from 10
    head = ("with_class_count(C, [&](auto ct) {\n"
            "      constexpr int CT = decltype(ct)::value;")
    assert src.count(head) == 1
    launches = src[src.index(head):src.index("});", src.index(head))]
    for kernel in ("forward_direct", "forward_direct_blocks"):
        assert f"fused_loss_{kernel}_kernel<CT>" in launches, kernel
    for gone in ("kClassSlots", "slot_index", "CT % 2 == 1", "kernel<0>",
                 "known_classes"):
        assert gone not in src, gone


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
    _plain_backward_against_pallas(C, (1, 7, 9), "wide-staged")


@pytest.mark.parametrize("C", [2, 6, 8, 12, 13, 16])
def test_plain_backward_matches_pallas_at_narrow_class_counts(C):
    """Users' schemas up to 16 classes, each on its own staged K2b (the
    Pallas kernel pads every count to a multiple of 8): dense channels_last
    logits, a ragged last span of 256 pixels, a tenth of the targets
    outside [0, C); the plain K2b's dlogits against the Pallas backward
    kernel in interpret mode."""
    _plain_backward_against_pallas(C, (2, 13, 23), f"staged<C={C}>")


def _plain_backward_against_pallas(C, bhw, variant):
    B, H, W = bhw
    x, t, cw = _inputs(C, B, H, W, C, out_of_range=True)
    w = LossWeights(weighted=C % 2 == 1)
    jw = JaxLossWeights(weighted=C % 2 == 1)

    def jloss(xx):
        return jax_fused(xx, jnp.asarray(t.astype(np.int32)),
                         jnp.asarray(cw), jw)[0]

    jgrad = jax.grad(jloss)(jnp.asarray(x))
    xt = _torch_x(x, channels_last=True)
    assert fl.backward_variant(xt) == variant
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
    ((3, 10, 4, 6), True, True),       # an even class count
    ((2, 4, 33, 65), False, False),
    # class counts of users' schemas up to 16, each on its own kernel
    ((3, 2, 19, 23), True, False),
    ((2, 6, 21, 17), True, True),
    ((1, 8, 37, 29), True, False),
    ((2, 12, 13, 31), False, True),
    ((1, 13, 29, 17), True, True),
    ((2, 16, 17, 19), True, False),
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
        f"direct<C={C}>")
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


def _write_schema(path, n_classes):
    """A schema file of ``n_classes`` classes with distinct colours, in
    the packaged schemas' format."""
    classes = [{"label": f"class {i}", "code": f"C{i}",
                "colour": {"rgb": [i, 255 - i, (7 * i) % 256],
                           "hex": "#%02x%02x%02x" % (i, 255 - i,
                                                     (7 * i) % 256)}}
               for i in range(n_classes)]
    with open(path, "w") as f:
        json.dump({"classes": classes}, f)
    return str(path)


def test_six_class_schema_train_step_matches_jax(tmp_path):
    """A user's 6-class ``--schema``: one AdamW step of DeepLabV3+/ResNet101
    with the fused loss (on the card K2a ``direct<C=6>`` and K2b
    ``staged<C=6>``; here their plain versions) against the JAX package's
    step (the Pallas loss in interpret mode, the classes padded to 8), at
    tests/test_torch_train.py's sizes and bn3 scaling, held as that file
    holds schema_a's first step: the metrics at METRIC_RTOL, and the
    clipped gradient, read from AdamW's moments, per tensor within
    MOMENT_RTOL of JAX's norm plus the port's own f32-to-f64 distance.
    (After one AdamW step a parameter whose gradient entry lies within
    rounding of zero moves by up to 2 lr either way in any package, so the
    moments and not the parameters carry the comparison.)  The batch is
    that file's first one: on other batches the backbone's f32 rounding,
    spread to every tensor by the global-norm clip, can pass the bound by
    the same amount with the plain loss on both sides as with the fused
    one, at 9 classes as at 6 (ROADMAP Queue 3)."""
    from flax import linen as fnn

    from pylc_tpu.config import Config as JaxConfig
    from pylc_tpu.models.registry import build_model as jax_build_model
    from pylc_tpu.train_state import init_state
    from pylc_tpu.train_state import make_train_step as jax_make_train_step
    from pylc_tpu_torch.convert import state_dict_from_jax
    from pylc_tpu_torch.train_state import make_optimizer, make_train_step
    from test_torch_train import (BATCH, METRIC_RTOL, MOMENT_RTOL,
                                  NOISE_FACTOR, SPE, STEP_KEYS, TILE,
                                  _assert_metrics_close, _batch,
                                  _condition, _flip_of, _InF64, _jax_moments, _jax_tree,
                                  _no_dropout, _np_tree, _port_model,
                                  _port_moments)
    C = 6
    cfg = JaxConfig().replace(
        schema=_write_schema(tmp_path / "six.json", C), tile_size=TILE,
        batch_size=BATCH, compute_dtype="float32", fused_loss="on")
    assert cfg.n_classes == C
    state, _ = init_state(cfg, jax.random.PRNGKey(0), SPE)
    params = _condition(_np_tree(state.params))
    stats = _np_tree(state.batch_stats)
    state = state.replace(params=_jax_tree(params))
    img, mask = _batch(100)    # the file's first step, targets in [0, C)
    mask %= C
    key = jax.random.PRNGKey(STEP_KEYS[0])
    with fnn.intercept_methods(_no_dropout):
        jstate, jm = jax_make_train_step(
            cfg, jax_build_model(cfg, train=True))(
                state, jnp.asarray(img), jnp.asarray(mask), key)
    metrics, moments = [], []
    launches = (fl.fused_loss_forward.launches,
                fl.fused_loss_backward.launches)
    for dtype in (torch.float32, torch.float64):
        model = _port_model(cfg, params, stats).to(dtype)
        opt, sched = make_optimizer(cfg, model, SPE)
        step = make_train_step(cfg, model if dtype == torch.float32
                               else _InF64(model), opt, sched)
        metrics.append(step(torch.from_numpy(img), torch.from_numpy(mask),
                            flip=_flip_of(key)))
        moments.append(_port_moments(model, opt))
    # the CPU path runs the plain versions; the card's kernels for the
    # train step's channels_last logits are the class count's own
    assert (fl.fused_loss_forward.launches,
            fl.fused_loss_backward.launches) == launches
    logits = _cl(BATCH, C, TILE, TILE)
    assert (fl.forward_variant(logits), fl.backward_variant(logits)) == \
        ("direct<C=6>", "staged<C=6>")
    _assert_metrics_close(metrics[0], jm, rtol=METRIC_RTOL)
    want = tuple(state_dict_from_jax(tree, stats) for tree in
                 _jax_moments(_np_tree(jstate.opt_state)))
    assert want[0]["decoder.last_conv.8.weight"].shape[0] == C
    for got, f64, ref in zip(*moments, want):
        assert set(got) <= set(ref)
        for k in got:
            err = float((got[k].double() - ref[k].double()).norm())
            floor = float((got[k].double() - f64[k]).norm())
            scale = float(ref[k].double().norm())
            assert err <= MOMENT_RTOL * scale + NOISE_FACTOR * floor, \
                (k, err, scale, floor)
