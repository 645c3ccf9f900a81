"""The port's mesh inference (``pylc_tpu_torch/parallel/``) against the
JAX package's, on the CPU.

The JAX side runs on the 8 virtual CPU devices of ``tests/conftest.py``,
its Pallas CRF kernel in interpret mode.  The port's mesh is
``Mesh([cpu] * n)``: every band on the CPU, the halos moved by plain
copies, so these tests hold the banding, the padding and the halo
arithmetic; K1 on the card runs in ``chip_smoke.py``'s ``[multi]``.

Tolerances: the banded stitch sums a canvas block that takes tiles from
two bands as (a+b)+(c+d) where one device sums ((a+b)+c)+d, so it agrees
with the one-device stitch to f32 rounding (atol 1e-6 on probabilities
in [0, 1]).  The banded CRF reads, for every interior pixel, the inputs
the one-device CRF reads; it is held to the one-device CRF at 1e-6 and
to the JAX package's at the 2e-6 of ``tests/test_torch_crf.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pylc_tpu.config import Config
from pylc_tpu.convert import export_deeplab_pth
from pylc_tpu.infer import Segmenter as JaxSegmenter
from pylc_tpu.models.registry import build_model as jax_build_model
from pylc_tpu.ops.crf import CRFParams as JaxCRFParams
from pylc_tpu.ops.crf import make_crf as jax_make_crf
from pylc_tpu.parallel import banded_infer as JBI
from pylc_tpu.parallel import sharded_crf as JSC
from pylc_tpu.parallel import sharded_stitch as JSS
from pylc_tpu.parallel.mesh import get_mesh as jax_get_mesh
from pylc_tpu.train_state import init_state, make_predict as jax_make_predict
from pylc_tpu_torch.infer import STAGES, Segmenter
from pylc_tpu_torch.ops.crf import CRFParams, make_crf, mean_field
from pylc_tpu_torch.ops.kernels.crf_kernel import crf_iteration
from pylc_tpu_torch.ops.tiles import accumulate_blocks, stitch_probs
from pylc_tpu_torch.parallel import banded_infer as BI
from pylc_tpu_torch.parallel import sharded_crf as SC
from pylc_tpu_torch.parallel import sharded_stitch as SS
from pylc_tpu_torch.parallel.mesh import (
    Mesh, batch_sharding, get_mesh, shard_batch)
from pylc_tpu_torch.tester import load_model

torch.set_num_threads(1)

TILE, STRIDE = 64, 32
CRF = dict(radius=2, n_iters=2)
STITCH_ATOL = 1e-6
CRF_ATOL = 1e-6         # banded against the port's one-device CRF
JAX_CRF_ATOL = 2e-6     # against the JAX package, tests/test_torch_crf.py


def cpu_mesh(n):
    return Mesh([torch.device("cpu")] * n)


def _tile_probs(rng, n_rows, n_cols, tile, C=5):
    p = rng.random((n_rows * n_cols, tile, tile, C)).astype(np.float32)
    return p / p.sum(-1, keepdims=True)


# --------------------------------------------------------------------- #
# mesh
# --------------------------------------------------------------------- #

def test_mesh_and_row_splits():
    mesh = Mesh(["cpu", "cpu", torch.device("cpu")])
    assert mesh.size == 3
    assert mesh.distinct == [torch.device("cpu")]
    assert get_mesh(2, "cpu").devices == (torch.device("cpu"),) * 2
    assert [(s.start, s.stop) for s in batch_sharding(mesh, 8)] == \
        [(0, 3), (3, 6), (6, 8)]
    a, b = shard_batch(mesh, np.arange(8), torch.arange(8) * 2)
    assert [t.tolist() for t in a] == [[0, 1, 2], [3, 4, 5], [6, 7]]
    assert torch.cat(b).tolist() == (torch.arange(8) * 2).tolist()
    with pytest.raises(ValueError, match="at least one"):
        Mesh([])


def test_get_mesh_never_shrinks_the_request():
    if torch.cuda.is_available():
        n = torch.cuda.device_count()
        assert get_mesh().size == n
        with pytest.raises(RuntimeError, match="are visible"):
            get_mesh(n + 1)
    else:
        for n in (None, 1, 2):
            with pytest.raises(RuntimeError, match="0 are visible"):
                get_mesh(n)


def test_accumulate_blocks_tile_weights_match_jax():
    """Item 5's ``tile_weights``: a weight-0 tile leaves no trace."""
    from pylc_tpu.ops.tiles import accumulate_blocks as jax_accumulate
    rng = np.random.default_rng(0)
    tp = _tile_probs(rng, 3, 4, 8)
    w = np.array([1, 0, 1, 1, 0.5, 1, 1, 1, 0, 0, 0, 0], np.float32)
    got = accumulate_blocks(torch.from_numpy(tp), 3, 4, 8, 4,
                            tile_weights=torch.from_numpy(w))
    want = jax_accumulate(jnp.asarray(tp), 3, 4, 8, 4,
                          tile_weights=jnp.asarray(w))
    for g, x in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(x), atol=1e-6)
    ones = accumulate_blocks(torch.from_numpy(tp), 3, 4, 8, 4,
                             tile_weights=torch.ones(12))
    plain = accumulate_blocks(torch.from_numpy(tp), 3, 4, 8, 4)
    for g, x in zip(ones, plain):
        torch.testing.assert_close(g, x, rtol=0, atol=0)


# --------------------------------------------------------------------- #
# geometry
# --------------------------------------------------------------------- #

def test_geometry_predicates_agree_with_jax():
    for n_rows in range(1, 12):
        for tile, stride in ((8, 4), (12, 4), (8, 8), (512, 256)):
            for n in (1, 2, 3, 4, 8):
                assert SS.can_shard(n_rows, tile, stride, n) == \
                    JSS.can_shard(n_rows, tile, stride, n)
    for H in (64, 96, 128, 192, 2048):
        for n in (1, 2, 3, 4, 8):
            assert BI.can_band(H, 192, 64, 32, n) == \
                JBI.can_band(H, 192, 64, 32, n)
    for H in (5, 9, 40, 41, 128, 2048):
        for r, k in ((1, 1), (2, 2), (3, 2), (8, 4)):
            for n in (1, 2, 3, 4, 8):
                assert SC.can_shard_crf(
                    H, CRFParams(radius=r, downsample=k), n) == \
                    JSC.can_shard_crf(
                        H, JaxCRFParams(radius=r, downsample=k), n)


@pytest.mark.parametrize("H,n", [(192, 2), (192, 3), (192, 4), (128, 3),
                                 (2048, 3)])
def test_band_plan_split_and_guide_match_jax(H, n):
    """The plan, the host's bands and the banded guide, array for array
    (n = 3 at 192 rows pads 5 tile rows into 6, at 2048 7 into 9)."""
    W, C = 96, 3
    tile, stride = (TILE, STRIDE) if H < 1024 else (512, 256)
    img = np.random.default_rng(H + n).integers(0, 255, (H, W, C),
                                                dtype=np.uint8)
    plan = BI.plan_bands(H, W, tile, stride, n)
    jplan = JBI.plan_bands(H, W, tile, stride, n)
    assert tuple(plan) == tuple(jplan)
    bands = BI.split_bands(img, plan)
    np.testing.assert_array_equal(bands, JBI.split_bands(img, jplan))
    jmesh = jax_get_mesh(n)
    jguide = JBI.banded_guide(
        jax.device_put(bands, JBI.band_sharding(jmesh)), jplan)
    guide = BI.banded_guide([torch.from_numpy(b) for b in bands], plan)
    np.testing.assert_array_equal(torch.cat(guide).numpy(),
                                  np.asarray(jguide))
    np.testing.assert_array_equal(torch.cat(guide).numpy(), img)


# --------------------------------------------------------------------- #
# stitch
# --------------------------------------------------------------------- #

def _stitch_case(n_rows, n):
    n_cols, tile, stride = 3, 8, 4
    tp = _tile_probs(np.random.default_rng(n_rows * 10 + n), n_rows,
                     n_cols, tile)
    got = SS.stitch_probs_sharded(torch.from_numpy(tp), n_rows, n_cols,
                                  tile, stride, cpu_mesh(n))
    assert len(got) <= n + 1
    got = torch.cat(got).numpy()
    one = stitch_probs(torch.from_numpy(tp), n_rows, n_cols, tile,
                       stride).numpy()
    assert got.shape == one.shape == \
        ((n_rows + 1) * stride, (n_cols + 1) * stride, 5)
    np.testing.assert_allclose(got, one, atol=STITCH_ATOL)
    return tp, got


@pytest.mark.parametrize("n_rows,n", [(4, 2), (5, 2), (7, 3), (6, 3),
                                      (8, 4), (7, 4), (16, 8), (13, 8)])
def test_banded_stitch_matches_one_device(n_rows, n):
    """Grids that divide the mesh and grids padded with zero-weight rows
    (5 on 2, 7 on 3 and 4, 13 on 8)."""
    _stitch_case(n_rows, n)


@pytest.mark.parametrize("n_rows,n", [(5, 2), (7, 3), (13, 8)])
def test_banded_stitch_matches_jax(n_rows, n):
    tp, got = _stitch_case(n_rows, n)
    want = np.asarray(JSS.stitch_probs_sharded(
        jnp.asarray(tp), n_rows, 3, 8, 4, jax_get_mesh(n)))
    np.testing.assert_allclose(got, want, atol=STITCH_ATOL)


def test_banded_stitch_without_overlap_and_refusals():
    tp = _tile_probs(np.random.default_rng(1), 5, 2, 8)
    got = torch.cat(SS.stitch_probs_sharded(
        torch.from_numpy(tp), 5, 2, 8, 8, cpu_mesh(2)))  # k = 1: no halo
    np.testing.assert_allclose(got.numpy(), stitch_probs(
        torch.from_numpy(tp), 5, 2, 8, 8).numpy(), atol=STITCH_ATOL)
    with pytest.raises(ValueError, match="use stitch_probs"):
        # 3 tile rows over 4 bands: a band cannot hold the spill of k = 3
        SS.stitch_probs_sharded(torch.from_numpy(
            _tile_probs(np.random.default_rng(2), 3, 2, 12)), 3, 2, 12, 4,
            cpu_mesh(4))


# --------------------------------------------------------------------- #
# CRF
# --------------------------------------------------------------------- #

def _crf_inputs(H, W, C=5, seed=0):
    rng = np.random.default_rng(seed)
    probs = rng.random((H, W, C)).astype(np.float32)
    probs /= probs.sum(-1, keepdims=True)
    return probs, rng.integers(0, 256, (H, W, 3)).astype(np.uint8)


CRF_CASES = [(40, 2, 3, 2), (40, 3, 3, 2), (41, 4, 2, 2), (38, 3, 2, 1),
             (36, 4, 3, 1)]


def _crf_case(H, n, radius, downsample):
    probs, guide = _crf_inputs(H, 30, seed=H + n)
    params = CRFParams(n_iters=3, radius=radius, downsample=downsample)
    assert SC.can_shard_crf(H, params, n)
    got = SC.mean_field_sharded(torch.from_numpy(probs),
                                torch.from_numpy(guide), params, cpu_mesh(n))
    one = mean_field(torch.from_numpy(probs), torch.from_numpy(guide),
                     params)
    assert got.shape == (H, 30, 5)
    np.testing.assert_allclose(got.numpy(), one.numpy(), atol=CRF_ATOL)
    return probs, guide, got


@pytest.mark.parametrize("H,n,radius,downsample", CRF_CASES)
def test_banded_crf_matches_one_device(H, n, radius, downsample):
    """n = 3 pads the 20-row grid into 21 rows and the 38-row one into
    39, n = 4 the 21-row grid of 41 rows into 24 and the 36-row one not
    at all; the last band re-sets its padding rows every iteration."""
    _crf_case(H, n, radius, downsample)


@pytest.mark.parametrize("H,n,radius,downsample", [CRF_CASES[2],
                                                   CRF_CASES[3]])
def test_banded_crf_matches_jax(H, n, radius, downsample):
    probs, guide, got = _crf_case(H, n, radius, downsample)
    want = JSC.mean_field_sharded(
        jnp.asarray(probs), jnp.asarray(guide),
        JaxCRFParams(n_iters=3, radius=radius, downsample=downsample),
        jax_get_mesh(n), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=JAX_CRF_ATOL)


def test_banded_crf_takes_row_banded_inputs():
    """The canvas and the guide as row bands that do not line up with
    the CRF's bands (as the banded stitch leaves them)."""
    probs, guide = _crf_inputs(40, 24, seed=3)
    params = CRFParams(n_iters=2, radius=3)
    cuts = [0, 7, 22, 40]
    parts = [torch.from_numpy(probs[a:b]) for a, b in zip(cuts, cuts[1:])]
    gparts = [torch.from_numpy(guide[a:b]) for a, b in zip(cuts, cuts[1:])]
    got = SC.mean_field_sharded(parts, gparts, params, cpu_mesh(3))
    want = mean_field(torch.from_numpy(probs), torch.from_numpy(guide),
                      params)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=CRF_ATOL)
    with pytest.raises(ValueError, match="can_shard_crf"):
        SC.mean_field_sharded(torch.from_numpy(probs),
                              torch.from_numpy(guide), params, cpu_mesh(8))
    assert SC.halo_bytes(40, 24, 5, params, 3) == 2 * 2 * 3 * 12 * 5 * 4


# --------------------------------------------------------------------- #
# the mesh Segmenter
# --------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    cfg = Config().replace(tile_size=TILE, compute_dtype="float32")
    state, _ = init_state(cfg, jax.random.PRNGKey(0))
    pth = export_deeplab_pth(
        state, cfg, str(tmp_path_factory.mktemp("model") / "m.pth"))
    return cfg, state, pth


@pytest.fixture(scope="module")
def photo():
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:128, 0:192]
    base = np.stack([yy * 2, xx, (yy + xx) % 256], -1)
    return np.clip(base + rng.normal(0, 12, base.shape), 0,
                   255).astype(np.uint8)


@pytest.fixture(scope="module")
def port_model(weights):
    _, _, pth = weights
    cfg, _, predict = load_model(
        pth, Config().replace(compute_dtype="float32"), torch.device("cpu"))
    return cfg, predict


def _segmenter(port_model, n, crf=True):
    cfg, predict = port_model
    return Segmenter(cfg, predict, torch.device("cpu"), batch_size=16,
                     crf=make_crf(cfg, **CRF) if crf else None,
                     mesh=None if n is None else cpu_mesh(n))


@pytest.fixture(scope="module")
def one_device(port_model, photo):
    return {crf: _segmenter(port_model, None, crf).segment_array(
        photo, STRIDE) for crf in (True, False)}


def test_mesh_segmenter_matches_jax_mesh_segmenter(weights, photo,
                                                   port_model):
    """Both packages' mesh programs on 2 devices, CRF on: the banded
    forward, stitch and CRF.  The tolerance of tests/test_torch_infer.py
    (f32 conv sums in another order, then the CRF's exp forms)."""
    cfg, state, _ = weights
    jseg = JaxSegmenter(cfg, state,
                        jax_make_predict(cfg, jax_build_model(cfg)),
                        batch_size=16, crf=jax_make_crf(cfg, **CRF),
                        mesh=jax_get_mesh(2))
    want = jseg.segment_array(photo, STRIDE)
    seg = _segmenter(port_model, 2)
    assert seg.mesh_routes(128, 192, STRIDE) == {
        "forward_stitch": "banded", "crf": "banded"}
    got = seg.segment_array(photo, STRIDE)
    np.testing.assert_allclose(got["probs"].numpy(),
                               np.asarray(want["probs"]), atol=1e-4)
    differ = np.mean(got["class_map"] != np.asarray(want["class_map"]))
    assert differ <= 1e-3, f"class maps differ on {differ:.4%} of pixels"


@pytest.mark.parametrize("n", [2, 3, 4])
@pytest.mark.parametrize("crf", [True, False], ids=["crf", "no_crf"])
def test_mesh_segmenter_matches_one_device(port_model, photo, one_device, n,
                                           crf):
    """3 tile rows of 64 px at stride 32 on 2, 3 and 4 bands (padded to
    4, 3 and 4 rows)."""
    seg = _segmenter(port_model, n, crf)
    got = seg.segment_array(photo, STRIDE)
    want = one_device[crf]
    np.testing.assert_allclose(got["probs"].numpy(), want["probs"].numpy(),
                               atol=CRF_ATOL)
    np.testing.assert_array_equal(got["class_map"], want["class_map"])
    np.testing.assert_array_equal(got["mask_rgb"], want["mask_rgb"])


def test_mesh_segmenter_every_entry_point(port_model, photo, one_device):
    """segment_array_staged, segment_stream and segment_many under a
    mesh give the one-device class maps; no CPU tensor launches K1."""
    seg = _segmenter(port_model, 3)
    want = one_device[True]["class_map"]
    staged = seg.segment_array_staged(photo, STRIDE)
    assert list(staged["stages"]) == list(STAGES)
    np.testing.assert_array_equal(staged["class_map"], want)
    flipped = np.ascontiguousarray(photo[::-1])
    one_flipped = _segmenter(port_model, None).segment_array(flipped, STRIDE)
    streamed = list(seg.segment_stream([("a", photo), ("b", flipped)],
                                       STRIDE))
    assert [t for t, _ in streamed] == ["a", "b"]
    np.testing.assert_array_equal(streamed[0][1]["class_map"], want)
    np.testing.assert_array_equal(streamed[1][1]["class_map"],
                                  one_flipped["class_map"])
    many = seg.segment_many([photo, flipped], STRIDE)
    np.testing.assert_array_equal(many[0]["class_map"], want)
    np.testing.assert_array_equal(many[1]["class_map"],
                                  one_flipped["class_map"])
    assert crf_iteration.launches == 0


def test_mesh_segmenter_fallback_geometries(port_model, photo, one_device,
                                           monkeypatch):
    """Where no band can hold the spill (``can_band`` false: a tile grid
    of k >= 3 sub-blocks, which ``grid_dims``'s stride = tile / 2 never
    gives, so it is forced here), the tile batch is split over the devices
    and stitched on the first.  At radius 9 the 64-row CRF grid's 8-row
    bands cannot hold the halo and the CRF runs on the first device.  Both
    as the JAX package decides."""
    cfg, predict = port_model
    monkeypatch.setattr(BI, "can_band", lambda *a: False)
    seg = _segmenter(port_model, 3)
    assert seg.mesh_routes(128, 192, STRIDE) == {
        "forward_stitch": "tile-split", "crf": "banded"}
    got = seg.segment_array(photo, STRIDE)
    np.testing.assert_allclose(got["probs"].numpy(),
                               one_device[True]["probs"].numpy(),
                               atol=CRF_ATOL)
    np.testing.assert_array_equal(got["class_map"],
                                  one_device[True]["class_map"])
    monkeypatch.undo()
    crf = make_crf(cfg, radius=9, n_iters=1)
    wide = Segmenter(cfg, predict, torch.device("cpu"), crf=crf,
                     mesh=cpu_mesh(8))
    assert wide.mesh_routes(128, 192, STRIDE) == {
        "forward_stitch": "banded", "crf": "one-device"}
    assert not JSC.can_shard_crf(128, JaxCRFParams(radius=9), 8)
    want = Segmenter(cfg, predict, torch.device("cpu"),
                     crf=crf).segment_array(photo, STRIDE)
    np.testing.assert_array_equal(
        wide.segment_array(photo, STRIDE)["class_map"], want["class_map"])


def test_mesh_segmenter_refusals(port_model):
    cfg, predict = port_model
    from pylc_tpu_torch.export import export_segmenter
    with pytest.raises(ValueError, match="single-device Segmenter"):
        export_segmenter(_segmenter(port_model, 2), 128, 192)
    with pytest.raises(ValueError, match="first device"):
        Segmenter(cfg, predict, torch.device("cpu"),
                  mesh=Mesh(["cuda:0", "cpu"]))


def test_mesh_segment_many_matches_jax_mesh_segment_many(weights, photo,
                                                         port_model):
    """Both packages' ``segment_many`` on a 2-device mesh, 3 photos with
    the CRF: each class map against the JAX package's within
    test_mesh_segmenter_matches_jax_mesh_segmenter's tolerance, and equal,
    with its mask, to the port's ``segment_array`` on the same mesh, whose
    canvas is held to the JAX package's at atol 1e-4.  Here the mesh is
    CPU entries, which take the plain loop: the pinned, streamed pipeline
    runs only on the card, where ``chip_smoke.py`` ``[multi]`` holds it to
    ``segment_array`` on ``Mesh([cuda:0] * n)``."""
    cfg, state, _ = weights
    photos = [photo, np.ascontiguousarray(photo[::-1]),
              np.ascontiguousarray(photo[:, ::-1])]
    jseg = JaxSegmenter(cfg, state,
                        jax_make_predict(cfg, jax_build_model(cfg)),
                        batch_size=16, crf=jax_make_crf(cfg, **CRF),
                        mesh=jax_get_mesh(2))
    seg = _segmenter(port_model, 2)
    want = jseg.segment_many(photos, STRIDE)
    got = seg.segment_many(photos, STRIDE)
    assert len(got) == len(want) == 3
    for img, g, w in zip(photos, got, want):
        assert "probs" not in g
        differ = np.mean(g["class_map"] != np.asarray(w["class_map"]))
        assert differ <= 1e-3, f"class maps differ on {differ:.4%} of pixels"
        one = seg.segment_array(img, STRIDE)
        np.testing.assert_array_equal(g["class_map"], one["class_map"])
        np.testing.assert_array_equal(g["mask_rgb"], one["mask_rgb"])
        np.testing.assert_allclose(
            one["probs"].numpy(),
            np.asarray(jseg.segment_array(img, STRIDE)["probs"]), atol=1e-4)
    assert sum(r["seconds"] for r in got) == pytest.approx(
        got[-1]["completed_s"])


@pytest.mark.parametrize("route", ["banded", "tile-split"])
def test_mesh_upload_then_compute_is_segment_array(port_model, photo,
                                                   monkeypatch, route):
    """The mesh path in its two halves: the upload puts the row bands on
    their devices (banded) or the photo on the first device (tile-split),
    and the compute on those parts gives ``segment_array``'s class map
    and canvas exactly."""
    if route == "tile-split":
        monkeypatch.setattr(BI, "can_band", lambda *a: False)
    seg = _segmenter(port_model, 3)
    H, W = photo.shape[:2]
    assert seg.mesh_routes(H, W, STRIDE)["forward_stitch"] == route
    parts = seg._upload(photo, STRIDE)
    if route == "banded":
        plan = BI.plan_bands(H, W, TILE, STRIDE, 3)
        np.testing.assert_array_equal(torch.stack(parts).numpy(),
                                      BI.split_bands(photo, plan))
    else:
        assert len(parts) == 1
        np.testing.assert_array_equal(parts[0].numpy(), photo)
    class_map, canvas = seg._compute_parts(parts, H, W, STRIDE,
                                           lambda name: None)
    want = seg.segment_array(photo, STRIDE)
    np.testing.assert_array_equal(class_map.numpy(), want["class_map"])
    torch.testing.assert_close(canvas, want["probs"], rtol=0, atol=0)
