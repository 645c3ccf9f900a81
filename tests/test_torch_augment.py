"""The port's augmentation path against the JAX package's, on the CPU:
``ops/augment_ops.py`` (homographies, warps, brightness shifts),
``augment.Augmentor`` (optimize, oversample), ``merge_dbs`` and
``grayscale_db``, with the ``augment``, ``merge`` and ``grayscale`` CLI
modes.

Host numpy (the homographies, the shifts, ``optimize``, the grayscale
mean) is held bit for bit.  A warp samples the same coordinates in both
packages, but the port computes them and the resize back in its own
order: an image value that lands within rounding of an integer can
truncate to the next grey level, and a mask sample whose coordinate sits
within rounding of a half pixel can round to the other neighbour.  So
warped images are held within 1 grey level and warped masks equal, each
on at least AGREEMENT of the pixels.  Observed on the CPU: warped f32
images within 7.4e-4 of JAX's; uint8 images equal on 0.999984-1.0 of
the pixels and never more than 1 apart; masks equal everywhere (the
random case, the tie-heavy case, ``augment_batch`` and a whole
``oversample``)."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from pylc_tpu import augment as jaug
from pylc_tpu.cli import main as jax_main
from pylc_tpu.config import Config
from pylc_tpu.db.database import TileDB as JaxTileDB
from pylc_tpu.ops import augment_ops as jops
from pylc_tpu.ops.profile import profile_tiles as jax_profile_tiles
from pylc_tpu_torch import augment as taug
from pylc_tpu_torch.config import Config as PortConfig
from pylc_tpu_torch.db import TileDB
from pylc_tpu_torch.ops import augment_ops as tops
from pylc_tpu_torch.utils.synthetic import textured_scene

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AGREEMENT = 0.999
TILE = 64


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _meta(cfg):
    m = cfg.to_meta()
    m["schema"] = os.path.basename(m["schema"])
    return m


def assert_warps_agree(got_img, want_img, got_mask, want_mask):
    """uint8 images within 1 grey level and masks equal, each on at least
    AGREEMENT of the pixels."""
    diff = np.abs(got_img.astype(np.int32) - want_img.astype(np.int32))
    assert np.mean(diff <= 1) >= AGREEMENT, np.mean(diff <= 1)
    assert np.mean(got_mask == want_mask) >= AGREEMENT, \
        np.mean(got_mask == want_mask)


def _scene_tiles(n, tile=TILE, seed=0):
    """n textured tiles (NHWC uint8) with their class maps."""
    rng = np.random.default_rng(seed)
    imgs, masks = [], []
    for _ in range(n):
        true, guide, _ = textured_scene(tile, tile, 9, rng)
        imgs.append(guide)
        masks.append(true.astype(np.uint8))
    return np.stack(imgs), np.stack(masks)


# --------------------------------------------------------------------- #
# augment_ops
# --------------------------------------------------------------------- #

def test_solve_homography_matches_jax_and_cv2():
    import cv2
    rng = np.random.default_rng(1)
    pts1 = np.float32([[5, 6], [40, 4], [3, 45], [44, 43]])
    pts2 = pts1 + rng.uniform(-3, 3, pts1.shape).astype(np.float32)
    got = tops.solve_homography(pts1, pts2)
    np.testing.assert_array_equal(got, jops.solve_homography(pts1, pts2))
    np.testing.assert_allclose(got, cv2.getPerspectiveTransform(pts1, pts2),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("size", [32, 64, 512])
def test_random_homographies_match_jax_at_a_seed(size):
    a, b = np.random.default_rng(7), np.random.default_rng(7)
    got = tops.random_homographies(a, 5, size)
    np.testing.assert_array_equal(got, jops.random_homographies(b, 5, size))
    assert a.integers(0, 2 ** 31) == b.integers(0, 2 ** 31)  # same state


@pytest.mark.parametrize("case", ["random", "ties"])
def test_warp_tiles_matches_jax(case):
    """The same matrices through both warps.  "ties": the identity and a
    shift by half a pixel in x and y, whose every mask coordinate is a
    tie of the nearest rounding and every image coordinate sits on a
    pixel or between two."""
    imgs, masks = _scene_tiles(6)
    if case == "random":
        h_inv = jops.random_homographies(np.random.default_rng(2), 6, TILE)
    else:
        h_inv = np.tile(np.eye(3, dtype=np.float32), (6, 1, 1))
        h_inv[1::2, :2, 2] = 0.5
        h_inv[2::3, :2, 2] = -0.5
    crop = max(1, round(TILE * 30 / 512))
    ji, jm = jops.warp_tiles(imgs, masks, h_inv, crop)
    ti, tm = tops.warp_tiles(_nchw(imgs), torch.from_numpy(masks),
                             torch.from_numpy(h_inv), crop)
    assert ti.dtype == tm.dtype == torch.float32
    ti = ti.numpy().transpose(0, 2, 3, 1)
    np.testing.assert_allclose(ti, np.asarray(ji), atol=0.01)
    u8 = [np.clip(x, 0, 255).astype(np.uint8) for x in (ti, np.asarray(ji))]
    assert_warps_agree(u8[0], u8[1], tm.numpy(), np.asarray(jm))
    if case == "ties":
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


def test_nearest_rounds_half_away_from_zero_then_mirrors():
    """The mask sampler at coordinates -1.5, -0.5, 0.5, 1.5, 2.5 and 3.5
    of the first row of a 4 x 4 map: rounded away from zero to -2, -1, 1,
    2, 3, 4, then mirrored about the edge pixels to 2, 1, 1, 2, 3, 2."""
    row = torch.arange(10.0, 26.0).reshape(1, 1, 4, 4)
    sx = torch.tensor([[-1.5, -0.5, 0.5, 1.5, 2.5, 3.5]])
    got = tops.sample_nearest(row, torch.zeros_like(sx), sx)
    np.testing.assert_array_equal(got[0, 0].numpy(),
                                  [12, 11, 11, 12, 13, 12])


def test_resize_nearest_index_is_jax_nearest():
    import jax.numpy as jnp
    from jax import image
    for m, n in ((52, 64), (452, 512), (30, 32), (7, 9)):
        src = np.arange(m, dtype=np.float32)
        want = np.asarray(image.resize(jnp.asarray(src), (n,), "nearest"))
        got = tops.resize_nearest_index(m, n, "cpu").numpy()
        np.testing.assert_array_equal(got, want)


def test_channel_shift_matches_jax():
    rng = np.random.default_rng(3)
    imgs = rng.integers(0, 256, (5, 8, 8, 3)).astype(np.uint8)
    shifts = rng.integers(10, 20, 5)
    got = tops.channel_shift(torch.from_numpy(imgs), torch.from_numpy(shifts))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jops.channel_shift(imgs, shifts)))


def test_augment_batch_matches_jax_at_a_seed():
    """Homographies, then shifts, from one generator in both packages;
    the generators end in the same state."""
    imgs, masks = _scene_tiles(5, seed=4)
    a, b = np.random.default_rng(11), np.random.default_rng(11)
    ti, tm = tops.augment_batch(np.ascontiguousarray(
        imgs.transpose(0, 3, 1, 2)), masks, a, "cpu")
    ji, jm = jops.augment_batch(imgs, masks, b)
    assert ti.dtype == tm.dtype == np.uint8
    assert ti.shape == (5, 3, TILE, TILE) and tm.shape == masks.shape
    assert_warps_agree(ti.transpose(0, 2, 3, 1), ji, tm, jm)
    assert a.integers(0, 2 ** 31) == b.integers(0, 2 ** 31)


# --------------------------------------------------------------------- #
# Augmentor, merge, grayscale
# --------------------------------------------------------------------- #

def unbalanced_db(path, n=40, tile=32, n_classes=9, seed=3):
    """tests/test_augment.py's DB: class 0 dominates, every fifth tile
    carries a rare class on its left half, profiled by the JAX
    package."""
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (n, 3, tile, tile)).astype(np.uint8)
    masks = np.zeros((n, tile, tile), np.uint8)
    for i in range(0, n, 5):
        masks[i, :, : tile // 2] = (i // 5) % (n_classes - 1) + 1
    cfg = Config().replace(tile_size=tile, ch=3, id="_db_unbal")
    cfg = cfg.replace(**jax_profile_tiles([(imgs, masks)], n_classes, tile))
    JaxTileDB.save(str(path), imgs, masks, cfg)
    return str(path)


@pytest.fixture(scope="module")
def db_path(tmp_path_factory):
    return unbalanced_db(tmp_path_factory.mktemp("db") / "unbal.h5")


def test_optimize_matches_jax_exactly(db_path):
    got = taug.Augmentor(PortConfig(), "cpu").load(db_path).optimize()
    want = jaug.Augmentor(Config()).load(db_path).optimize()
    np.testing.assert_array_equal(got.rates, want.rates)
    assert set(got.optim_meta) == set(want.optim_meta)
    for k, v in want.optim_meta.items():
        np.testing.assert_array_equal(got.optim_meta[k], v, err_msg=k)
    assert got.optim_meta["jsd"] < got.meta.jsd
    assert 0 < got.rates.sum() < int(0.36 * len(got.rates))


@pytest.fixture(scope="module")
def oversampled(db_path):
    got = taug.Augmentor(PortConfig(), "cpu").load(db_path).optimize() \
        .oversample(seed=5, device_batch=4)
    want = jaug.Augmentor(Config()).load(db_path).optimize() \
        .oversample(seed=5, device_batch=4)
    return got, want


def test_oversample_matches_jax_at_a_seed(oversampled, db_path):
    """A whole ``oversample`` (device batches of 4 copies, the final
    co-shuffle from the same generator, the profile): originals equal,
    copies as the warps, the meta field by field."""
    got, want = oversampled
    n_in = TileDB(db_path).size
    assert len(got.out_imgs) == len(want.out_imgs) == n_in + got.rates.sum()
    assert got.out_imgs.dtype == got.out_masks.dtype == np.uint8
    assert_warps_agree(got.out_imgs, want.out_imgs, got.out_masks,
                       want.out_masks)
    if np.array_equal(got.out_masks, want.out_masks):
        assert_meta_equal(got.meta, want.meta)
    assert got.meta.id == want.meta.id == "_aug_db_unbal"
    assert got.meta.n_samples == len(got.out_imgs)


def test_oversample_reads_an_in_memory_db(db_path):
    """``Augmentor.load`` takes a ``TileDB`` built with ``data=`` (the
    card's machine has no h5py) and gives what the file gives."""
    db = TileDB(db_path)
    imgs, masks = db.read_chunk(0, db.size)
    mem = TileDB(data={"img": imgs, "mask": masks, "meta": db.get_meta()})
    a = taug.Augmentor(PortConfig(), "cpu").load(mem).optimize() \
        .oversample(seed=5, device_batch=4)
    b = taug.Augmentor(PortConfig(), "cpu").load(db_path).optimize() \
        .oversample(seed=5, device_batch=4)
    np.testing.assert_array_equal(a.out_imgs, b.out_imgs)
    np.testing.assert_array_equal(a.out_masks, b.out_masks)
    assert a.get_data().size == len(b.out_imgs)


def test_augmented_db_is_read_by_both_packages(oversampled, tmp_path):
    got, want = oversampled
    for aug, other in ((got, JaxTileDB), (want, TileDB)):
        path = aug.save(str(tmp_path / type(aug).__module__))
        db = other(path)
        imgs, masks = db.read_chunk(0, db.size)
        np.testing.assert_array_equal(imgs, aug.out_imgs)
        np.testing.assert_array_equal(masks, aug.out_masks)
        assert _meta(db.get_meta()) == _meta(aug.meta)


def assert_meta_equal(got, want):
    """Metas field by field: exactly, but the pixel means and stds at
    rtol 1e-6 (each package reduces a tile in f32 in its own order)."""
    got, want = _meta(got), _meta(want)
    for k in ("px_mean", "px_std"):
        np.testing.assert_allclose(got.pop(k), want.pop(k), rtol=1e-6,
                                   err_msg=k)
    assert got == want


def _assert_dbs_equal(a, b):
    """Two .h5 DBs equal byte for byte in img and mask and in their meta
    as ``assert_meta_equal`` holds it, each file read by the other
    package."""
    A, B = TileDB(a), JaxTileDB(b)
    np.testing.assert_array_equal(A.read_chunk(0, A.size)[0],
                                  B.read_chunk(0, B.size)[0])
    np.testing.assert_array_equal(A.read_chunk(0, A.size)[1],
                                  B.read_chunk(0, B.size)[1])
    assert_meta_equal(A.get_meta(), B.get_meta())
    assert _meta(JaxTileDB(a).get_meta()) == _meta(A.get_meta())
    assert _meta(TileDB(b).get_meta()) == _meta(B.get_meta())


def test_merge_and_grayscale_match_jax(db_path, tmp_path):
    other = unbalanced_db(tmp_path / "other.h5", n=15, seed=8)
    out = {}
    for name, mod, kw in (("port", taug, {"device": "cpu"}),
                          ("jax", jaug, {})):
        out[name] = (
            mod.merge_dbs([db_path, other], str(tmp_path / f"m_{name}.h5"),
                          seed=2, **kw),
            mod.grayscale_db(db_path, str(tmp_path / f"g_{name}.h5"), **kw))
    for a, b in zip(out["port"], out["jax"]):
        _assert_dbs_equal(a, b)
    merged, gray = TileDB(out["port"][0]), TileDB(out["port"][1])
    assert merged.size == 55
    assert merged.get_meta().id == "_merged_2_55"
    assert gray.img_shape[1] == 1 and gray.get_meta().ch == 1


def test_merge_refuses_incompatible_dbs(db_path, tmp_path):
    gray = taug.grayscale_db(db_path, str(tmp_path / "gs.h5"),
                             device="cpu")
    with pytest.raises(ValueError, match="ch=1 differs"):
        taug.merge_dbs([db_path, gray], str(tmp_path / "bad.h5"),
                       device="cpu")
    other = unbalanced_db(tmp_path / "t16.h5", n=5, tile=16)
    with pytest.raises(ValueError, match="tile_size"):
        taug.merge_dbs([db_path, other], str(tmp_path / "bad.h5"),
                       device="cpu")
    with pytest.raises(ValueError, match="3-channel"):
        taug.grayscale_db(gray, str(tmp_path / "gg.h5"), device="cpu")


def test_augmentor_runs_on_the_card_unless_asked():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            taug.Augmentor(PortConfig())
    assert taug.Augmentor(PortConfig(), "cpu").device.type == "cpu"


# --------------------------------------------------------------------- #
# CLI: augment, merge, grayscale
# --------------------------------------------------------------------- #

def run_port_cli(argv, cwd):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-m", "pylc_tpu_torch", *argv,
                          "--device", "cpu"], cwd=str(cwd), env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_augment_merge_grayscale_cli_match_pylc(db_path, tmp_path,
                                                monkeypatch):
    """``python -m pylc_tpu_torch augment|merge|grayscale ... --device
    cpu`` against the JAX package's CLI (``pylc.py``'s ``main``)."""
    monkeypatch.chdir(tmp_path)
    outs = {}
    for name in ("port", "jax"):
        d = tmp_path / name
        d.mkdir()
        argvs = [["augment", "--db", db_path, "--output", str(d)],
                 ["merge", "--dbs", db_path, db_path, "--output",
                  str(d / "merged.h5")],
                 ["grayscale", "--db", db_path, "--output",
                  str(d / "gs.h5")]]
        for argv in argvs:
            if name == "port":
                run_port_cli(argv, tmp_path)
            else:
                jax_main(argv)
        outs[name] = [str(d / "_aug_db_unbal.h5"), str(d / "merged.h5"),
                      str(d / "gs.h5")]
    (pa, pm, pg), (ja, jm, jg) = outs["port"], outs["jax"]
    _assert_dbs_equal(pm, jm)
    _assert_dbs_equal(pg, jg)
    A, B = TileDB(pa), JaxTileDB(ja)
    assert A.size == B.size
    assert_warps_agree(A.read_chunk(0, A.size)[0], B.read_chunk(0, B.size)[0],
                       A.read_chunk(0, A.size)[1], B.read_chunk(0, B.size)[1])
