"""Parity of the port's dense CRF with pylc_tpu/ops/crf.py and its Pallas
kernel (run in interpret mode, as tests/test_crf.py runs it).

The CUDA kernel itself cannot run here: chip_smoke.py holds it against
``crf_iteration_reference`` on the card.  These tests pin the reference
form and everything around the kernel."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pylc_tpu.ops import crf as jcrf
from pylc_tpu.ops.pallas.crf_kernel import crf_iteration as jax_iteration
from pylc_tpu_torch.ops import crf as tcrf
from pylc_tpu_torch.ops.kernels import crf_kernel as K

torch.set_num_threads(1)

SIGMAS = dict(sigma_spatial_app=3.0, sigma_color=13.0, sigma_spatial_sm=1.5,
              w_app=3.0, w_sm=1.0)


def _inputs(rng, H, W, C, G=3):
    probs = rng.random((H, W, C)).astype(np.float32)
    probs /= probs.sum(-1, keepdims=True)
    guide = rng.integers(0, 256, (H, W, G)).astype(np.uint8)
    return probs, guide


def test_reference_iteration_matches_pallas_kernel():
    """40x72 is ragged against the Pallas kernel's 64x256 blocks."""
    rng = np.random.default_rng(0)
    H, W, C, r = 40, 72, 7, 2
    q = rng.random((C, H, W)).astype(np.float32)
    q /= q.sum(0, keepdims=True)
    g = rng.integers(0, 256, (3, H, W)).astype(np.float32)
    u = np.log(q + 1e-8)
    want = np.asarray(jax_iteration(jnp.asarray(q), jnp.asarray(g),
                                    jnp.asarray(u), r, **SIGMAS,
                                    interpret=True))
    got = K.crf_iteration_reference(torch.from_numpy(q), torch.from_numpy(g),
                                    torch.from_numpy(u), r, **SIGMAS)
    # the same product-of-exps form; atol of tests/test_crf.py:76
    np.testing.assert_allclose(got.numpy(), want, atol=2e-6)


@pytest.mark.parametrize("C,G,H,W,r", [(9, 3, 37, 70, 3), (11, 1, 21, 24, 3)])
def test_reference_iteration_matches_pallas_at_tiled_sizes(C, G, H, W, r):
    """Sizes that the card runs on the tiled kernel (ragged: W = 70 is no
    multiple of its 4-pixel strips), through the plain version."""
    assert K.variant(C, G, r).startswith("tiled")
    rng = np.random.default_rng(C)
    q = rng.random((C, H, W)).astype(np.float32)
    q /= q.sum(0, keepdims=True)
    g = rng.integers(0, 256, (G, H, W)).astype(np.float32)
    u = np.log(q + 1e-8)
    want = np.asarray(jax_iteration(jnp.asarray(q), jnp.asarray(g),
                                    jnp.asarray(u), r, **SIGMAS,
                                    interpret=True))
    got = K.crf_iteration(torch.from_numpy(q), torch.from_numpy(g),
                          torch.from_numpy(u), r, **SIGMAS)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-6)


@pytest.mark.parametrize("C,G,H,W,r", [(17, 3, 19, 26, 3),
                                       (20, 3, 37, 30, 2),
                                       (20, 1, 21, 24, 8),
                                       (16, 4, 19, 22, 8),
                                       (128, 4, 13, 15, 6),
                                       (128, 3, 11, 13, 3)])
def test_reference_iteration_matches_pallas_at_wide_sizes(C, G, H, W, r):
    """More classes than the card's generic kernel holds, and the largest
    narrow size at the largest radius: sizes that run on its wide kernel
    (at r = 6 to 8 with one window row a thread), through the plain
    version, against the Pallas kernel (which takes any C)."""
    assert K.variant(C, G, r) == (f"wide<R={r}>" if C > 16
                                  else f"narrow<R={r}>")
    rng = np.random.default_rng(C + r)
    q = rng.random((C, H, W)).astype(np.float32)
    q /= q.sum(0, keepdims=True)
    g = rng.integers(0, 256, (G, H, W)).astype(np.float32)
    u = np.log(q + 1e-8)
    want = np.asarray(jax_iteration(jnp.asarray(q), jnp.asarray(g),
                                    jnp.asarray(u), r, **SIGMAS,
                                    interpret=True))
    got = K.crf_iteration(torch.from_numpy(q), torch.from_numpy(g),
                          torch.from_numpy(u), r, **SIGMAS)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-6)


def test_mean_field_matches_jax_pallas_branch_at_20_classes():
    """A 20-class schema's CRF, the branch ``test --crf`` takes."""
    rng = np.random.default_rng(4)
    probs, guide = _inputs(rng, 34, 46, 20)
    p = dict(n_iters=2, radius=3, downsample=2)
    want = np.asarray(jcrf.mean_field(jnp.asarray(probs), jnp.asarray(guide),
                                      jcrf.CRFParams(**p, backend="pallas")))
    got = tcrf.mean_field(torch.from_numpy(probs), torch.from_numpy(guide),
                          tcrf.CRFParams(**p)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-6)


@pytest.mark.parametrize("C", [1, 16, 17, 128])
def test_check_takes_up_to_128_classes(C):
    q = torch.zeros(C, 4, 5)
    assert K._check(q, torch.zeros(3, 4, 5), q, 3) == (C, 3, 4, 5)


def test_check_refuses_129_classes():
    q = torch.zeros(129, 4, 5)
    with pytest.raises(ValueError, match="MAX_CLASSES = 128, the JAX "
                                         "package's own limit"):
        K._check(q, torch.zeros(3, 4, 5), q, 3)
    with pytest.raises(ValueError, match="G=5"):
        K._check(q[:9], torch.zeros(5, 4, 5), q[:9], 3)


@pytest.mark.parametrize("H,W,downsample", [(48, 80, 2), (37, 70, 2),
                                            (30, 44, 1)])
def test_mean_field_matches_jax_xla(H, W, downsample):
    rng = np.random.default_rng(1)
    probs, guide = _inputs(rng, H, W, 9)
    p = dict(n_iters=3, radius=2, downsample=downsample)
    want = np.asarray(jcrf.mean_field(jnp.asarray(probs), jnp.asarray(guide),
                                      jcrf.CRFParams(**p, backend="xla")))
    got = tcrf.mean_field(torch.from_numpy(probs), torch.from_numpy(guide),
                          tcrf.CRFParams(**p)).numpy()
    assert got.shape == (H, W, 9)
    # product of two exps here, exp of their sum in the XLA form: ulps
    # per weight, a few 1e-7 after three iterations and the upsample
    np.testing.assert_allclose(got, want, atol=2e-6)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)


def test_mean_field_matches_jax_pallas_branch():
    """The branch the port follows step by step, with grayscale guide."""
    rng = np.random.default_rng(2)
    probs, guide = _inputs(rng, 36, 52, 5, G=1)
    p = dict(n_iters=2, radius=3, downsample=2)
    want = np.asarray(jcrf.mean_field(jnp.asarray(probs),
                                      jnp.asarray(guide[..., 0]),
                                      jcrf.CRFParams(**p, backend="pallas")))
    got = tcrf.mean_field(torch.from_numpy(probs),
                          torch.from_numpy(guide[..., 0]),
                          tcrf.CRFParams(**p)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-6)


def test_make_crf_reads_config():
    from pylc_tpu.config import Config
    cfg = Config().replace(crf_iters=4, crf_radius=2, crf_downsample=1,
                           crf_sigma_color=10.0)
    assert tcrf.make_crf(cfg).params == tcrf.CRFParams(
        n_iters=4, radius=2, downsample=1, sigma_color=10.0)
    jp = jcrf.make_crf(cfg).params
    assert tcrf.make_crf(cfg).params == tcrf.CRFParams(
        **{k: getattr(jp, k) for k in tcrf.CRFParams._fields})


def test_cpu_tensor_takes_plain_path_without_launch():
    rng = np.random.default_rng(3)
    probs, guide = _inputs(rng, 20, 24, 4)
    before = K.crf_iteration.launches
    out = tcrf.mean_field(torch.from_numpy(probs), torch.from_numpy(guide),
                          tcrf.CRFParams(n_iters=3, radius=1))
    assert K.crf_iteration.launches == before == 0
    assert torch.isfinite(out).all()
    q = torch.from_numpy(probs).permute(2, 0, 1).contiguous()
    g = torch.from_numpy(guide).permute(2, 0, 1).float().contiguous()
    u = torch.log(q + 1e-8)
    assert torch.equal(K.crf_iteration(q, g, u, 2, **SIGMAS),
                       K.crf_iteration_reference(q, g, u, 2, **SIGMAS))
    assert K.crf_iteration.launches == 0


def test_kernel_source_and_build_flags():
    """What the card builds: sm_90a without fast math, from the package's
    own source, into the package's build directory."""
    import os
    from pylc_tpu_torch.ops.kernels import _build
    assert os.path.exists(K.SOURCE)
    assert os.path.dirname(_build.library_path("crf_iteration")) == \
        _build.BUILD_DIR
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert not any("fast" in f for f in _build.NVCC_FLAGS)
    with open(K.SOURCE) as f:
        src = f.read()
    for bound, name in ((K.MAX_CLASSES, "kMaxC"), (K.MAX_GUIDE, "kMaxG"),
                        (K.MAX_RADIUS, "kMaxR"),
                        (K.GENERIC_CLASSES, "kGenericC")):
        assert f"constexpr int {name} = {bound};" in src


@pytest.mark.parametrize("size,name", [
    ((9, 3, 3), "tiled<C=9,G=3,R=3>"), ((11, 3, 3), "tiled<C=11,G=3,R=3>"),
    ((9, 1, 3), "tiled<C=9,G=1,R=3>"), ((11, 1, 3), "tiled<C=11,G=1,R=3>"),
    ((11, 3, 2), "narrow<R=2>"), ((9, 3, 4), "narrow<R=4>"),
    ((7, 3, 3), "narrow<R=3>"), ((9, 2, 3), "narrow<R=3>"),
    ((16, 4, 8), "narrow<R=8>"),
    pytest.param((17, 3, 3), "wide<R=3>", id="size9-wide"),
    pytest.param((20, 1, 3), "wide<R=3>", id="size10-wide"),
    pytest.param((128, 4, 8), "wide<R=8>", id="size11-wide"),
    ((1, 1, 0), "generic"), ((16, 4, 5), "narrow<R=5>"),
    ((9, 3, 6), "narrow<R=6>"), ((11, 1, 7), "narrow<R=7>")])
def test_variant_choice(size, name):
    """Which kernel a size runs on: the tiled one for the sizes the
    package uses (both schemas, RGB or grayscale guide, default radius);
    the wide kernel for every other size at every radius (of at most 16
    classes, ``narrow``, from r = 1); the generic kernel for at most 16
    classes at r = 0.  The simple wide kernel is no size's."""
    assert K.variant(*size) == name


# sizes at the edges of the wide kernel's dispatch: class counts that leave
# a chunk of kWideK = 4 classes with 1, 3 or no zero planes, each guide
# width, each radius (an even and an odd number of window rows per pair of
# them up to r = 5, one row a thread past it)
WIDE_BOUNDARIES = [            # (C, G, H, W, r, kernel)
    (17, 3, 9, 13, 3, "wide<R=3>"),
    (31, 4, 10, 14, 3, "wide<R=3>"),
    (33, 1, 9, 11, 2, "wide<R=2>"),
    (127, 3, 7, 9, 1, "wide<R=1>"),
    (128, 1, 7, 10, 0, "wide<R=0>"),
    (128, 3, 6, 7, 3, "wide<R=3>"),
    (104, 3, 6, 9, 4, "wide<R=4>"),
    (105, 4, 8, 12, 5, "wide<R=5>"),
    (128, 4, 6, 7, 5, "wide<R=5>"),
    (17, 1, 12, 9, 6, "wide<R=6>"),
    (45, 2, 9, 10, 7, "wide<R=7>"),
    (20, 4, 13, 11, 8, "wide<R=8>"),
]
# at most 16 classes outside the tiled list: the wide kernel at each
# radius from 1 to 8 (1 to 16 classes, a chunk of kWideK = 4 classes with
# 3, 2 or no zero planes, each guide width) and the generic kernel at r = 0
NARROW_SIZES = [               # (C, G, H, W, r, kernel)
    (1, 1, 7, 9, 0, "generic"),
    (10, 3, 9, 7, 0, "generic"),
    (2, 3, 9, 11, 1, "narrow<R=1>"),
    (6, 4, 10, 13, 2, "narrow<R=2>"),
    (16, 1, 11, 6, 2, "narrow<R=2>"),
    (10, 1, 11, 9, 4, "narrow<R=4>"),
    (1, 4, 8, 11, 4, "narrow<R=4>"),
    (16, 3, 9, 14, 5, "narrow<R=5>"),
    (6, 1, 13, 10, 5, "narrow<R=5>"),
    (5, 2, 10, 9, 6, "narrow<R=6>"),
    (13, 3, 8, 12, 7, "narrow<R=7>"),
    (2, 1, 7, 13, 8, "narrow<R=8>"),
    (16, 4, 12, 9, 8, "narrow<R=8>"),
]


@pytest.mark.parametrize("C,G,H,W,r,kernel", WIDE_BOUNDARIES + NARROW_SIZES)
def test_reference_iteration_matches_pallas_at_wide_boundaries(C, G, H, W, r,
                                                              kernel):
    """Each size at an edge of the wide and narrow dispatch runs on the
    kernel named, and its plain version agrees with the Pallas kernel."""
    assert K.variant(C, G, r) == kernel
    rng = np.random.default_rng(C * 10 + r)
    q = rng.random((C, H, W)).astype(np.float32)
    q /= q.sum(0, keepdims=True)
    g = rng.integers(0, 256, (G, H, W)).astype(np.float32)
    u = np.log(q + 1e-8)
    want = np.asarray(jax_iteration(jnp.asarray(q), jnp.asarray(g),
                                    jnp.asarray(u), r, **SIGMAS,
                                    interpret=True))
    got = K.crf_iteration(torch.from_numpy(q), torch.from_numpy(g),
                          torch.from_numpy(u), r, **SIGMAS)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-6)


def test_wide_dispatch_is_the_sources():
    """The wide kernel's largest radius is the source's and the kernel's
    largest, and the dispatch gives it every class count past the generic
    kernel's at every radius from 0 to 8."""
    with open(K.SOURCE) as f:
        src = f.read()
    assert f"constexpr int kWideMaxR = {K.WIDE_MAX_RADIUS};" in src
    assert K.WIDE_MAX_RADIUS == K.MAX_RADIUS == 8
    for r in range(K.MAX_RADIUS + 1):
        assert [K.wide_fits(C, r) for C in range(1, K.MAX_CLASSES + 1)] == \
            [K.GENERIC_CLASSES < C for C in range(1, K.MAX_CLASSES + 1)]
        for G in range(1, K.MAX_GUIDE + 1):
            assert {K.variant(C, G, r) for C in range(
                K.GENERIC_CLASSES + 1, K.MAX_CLASSES + 1)} == {f"wide<R={r}>"}


def test_narrow_dispatch_is_the_sources():
    """Every size of at most 16 classes outside the tiled list runs on the
    wide kernel at every radius from r = 1 to 8 (``narrow<R=r>``), on the
    generic kernel at r = 0: the source's dispatch
    (crf_iteration_f32 and
    crf_iteration_is_narrow, the latter checked against ``narrow_fits`` on
    the card at every load) and ``variant`` agree."""
    import re
    with open(K.SOURCE) as f:
        src = f.read()
    assert "bool wide_fits(int r) { return r <= kWideMaxR; }" in src
    assert "bool narrow_fits(int r) { return r >= 1 && wide_fits(r); }" in src
    body = re.search(r'extern "C" int crf_iteration_is_narrow\(int C, int G, '
                     r'int r\) \{(.*?)\n\}', src, re.S).group(1)
    assert ("C <= kGenericC && !crf_iteration_is_tiled(C, G, r) && "
            "narrow_fits(r)") in " ".join(body.split())
    entry = src[src.index('extern "C" int crf_iteration_f32('):]
    tiled = entry.index("PYLC_K1_TILED_SIZES(PYLC_K1_LAUNCH)")
    radius = entry.index("switch ((C > kGenericC ? wide_fits(r) : "
                         "narrow_fits(r)) ? r : -1) {")
    assert tiled < radius  # a tiled size never reaches the wide kernel
    for r in range(9):  # every radius the kernel takes
        assert f"case {r}: return launch_wide<{r}>(a, C, G);" in entry
    assert ("return C > kGenericC ? launch_wide_simple(a, C, G, r)\n"
            "                       : launch_generic(a, C, G, r);") in entry
    for C in range(1, K.GENERIC_CLASSES + 1):
        for G in range(1, K.MAX_GUIDE + 1):
            for r in range(K.MAX_RADIUS + 1):
                want = ("tiled" if (C, G, r) in K.TILED_SIZES else
                        f"narrow<R={r}>" if 1 <= r <= 8 else "generic")
                assert K.variant(C, G, r).split("<C=")[0] == want
                assert K.narrow_fits(C, G, r) == want.startswith("narrow")


def test_tiled_sizes_are_the_sources():
    import re
    with open(K.SOURCE) as f:
        macro = re.search(r"#define PYLC_K1_TILED_SIZES\(X\)(.*)", f.read())
    sizes = {tuple(int(v) for v in m) for m in
             re.findall(r"X\((\d+), (\d+), (\d+)\)", macro.group(1))}
    assert sizes == set(K.TILED_SIZES)
    from pylc_tpu_torch.config import Schema
    assert {c for c, _, _ in sizes} == {Schema.load(s).n_classes
                                        for s in ("schema_a", "schema_b")}


def _operands(C=9, G=3, H=6, W=8):
    return torch.zeros(C, H, W), torch.zeros(G, H, W), torch.zeros(C, H, W)


@pytest.mark.parametrize("case,match", [
    ("classes", "outside the kernel's bounds"),
    ("guide", "outside the kernel's bounds"),
    ("radius", "outside the kernel's bounds"),
    ("dtype", "takes float32"), ("strided", "contiguous"),
    ("rank", "contiguous"), ("shapes", "disagree")])
def test_kernel_wrapper_refuses_bad_operands(case, match):
    """What the CUDA wrapper checks is device-independent; on the CPU the
    plain version runs, so the checks are exercised directly."""
    q, g, u = _operands()
    r = 3
    if case == "classes":
        q, g, u = _operands(C=129)
    elif case == "guide":
        q, g, u = _operands(G=5)
    elif case == "radius":
        r = 9
    elif case == "dtype":
        g = g.double()
    elif case == "strided":
        u = torch.zeros(9, 6, 16)[:, :, ::2]
    elif case == "rank":
        g = g[0]
    elif case == "shapes":
        g = torch.zeros(3, 6, 9)
    with pytest.raises(ValueError, match=match):
        K._check(q, g, u, r)


def test_kernel_wrapper_accepts_the_slice_and_no_kernel_on_cpu():
    assert K._check(*_operands(), 3) == (9, 3, 6, 8)
    assert K._check(*_operands(11, 1, 5, 7), 0) == (11, 1, 5, 7)
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        K.crf_iteration_generic(*_operands(), 3, **SIGMAS)
    assert K.crf_iteration.launches == 0


def _miou(pred, true, n_classes):
    ious = [np.sum((pred == c) & (true == c)) / np.sum((pred == c) |
                                                        (true == c))
            for c in range(n_classes) if np.any((pred == c) | (true == c))]
    return float(np.mean(ious))


def test_crf_improves_miou_as_jax_does():
    """The accuracy check of tests/test_crf.py::test_crf_improves_miou on
    the port's CRF: noisy unaries over colour-consistent Voronoi regions;
    refinement must raise mIoU as the JAX CRF does, to within 0.01."""
    rng = np.random.default_rng(42)
    H, W, C = 128, 128, 5
    pts = rng.integers(0, [H, W], size=(C * 3, 2))
    lbl = rng.integers(0, C, size=(C * 3,))
    yy, xx = np.mgrid[0:H, 0:W]
    d = (yy[..., None] - pts[:, 0]) ** 2 + (xx[..., None] - pts[:, 1]) ** 2
    true = lbl[np.argmin(d, axis=-1)].astype(np.int32)
    colors = rng.integers(40, 255, size=(C, 3))
    guide = np.clip(colors[true] + rng.normal(0, 8, (H, W, 3)), 0,
                    255).astype(np.uint8)
    noisy = np.where(rng.random((H, W)) < 0.15,
                     rng.integers(0, C, size=(H, W)), true)
    logits = np.eye(C, dtype=np.float32)[noisy] * 2.0
    logits += rng.normal(0, 0.7, logits.shape).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)

    p = dict(n_iters=5, radius=3, downsample=1)
    before = _miou(probs.argmax(-1), true, C)
    got = tcrf.mean_field(torch.from_numpy(probs), torch.from_numpy(guide),
                          tcrf.CRFParams(**p)).numpy()
    want = np.asarray(jcrf.mean_field(jnp.asarray(probs), jnp.asarray(guide),
                                      jcrf.CRFParams(**p, backend="xla")))
    after = _miou(got.argmax(-1), true, C)
    assert after > before + 0.05 and after > 0.85, (before, after)
    assert abs(after - _miou(want.argmax(-1), true, C)) <= 0.01
