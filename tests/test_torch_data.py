"""The port's data path against the JAX package's, on the CPU: the device
palette codecs (``ops/palette.py``), the profiler (``ops/profile.py``)
and the extractor (``extract.py``), with the ``extract`` and ``profile``
CLI modes.

Every comparison is exact but the profile's means and standard
deviations (rtol 1e-6: both packages reduce in f32, in their own order;
the largest difference seen was 2.1e-7).
Photos are seeded ``utils/synthetic.textured_scene`` scenes of 96 x 128
px written as JPEG, with schema_a masks as PNG in which one pixel in 20
has a colour outside the palette (class 1, the reference's quirk);
tiles are 32 px."""

import json
import os
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch

from pylc_tpu import native as jnative
from pylc_tpu.cli import main as jax_main
from pylc_tpu.config import Config
from pylc_tpu.db.database import TileDB as JaxTileDB
from pylc_tpu.extract import Extractor as JaxExtractor
from pylc_tpu.ops import palette as jpalette
from pylc_tpu.ops.profile import profile_tiles as jax_profile_tiles
from pylc_tpu_torch import native as tnative
from pylc_tpu_torch.config import Config as PortConfig
from pylc_tpu_torch.db import TileDB
from pylc_tpu_torch.extract import Extractor
from pylc_tpu_torch.ops import palette as tpalette
from pylc_tpu_torch.ops.profile import profile_tiles
from pylc_tpu_torch.utils.synthetic import textured_scene

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden", "reference_goldens.npz")
TILE = 32
PHOTO_HW = (96, 128)
N_PHOTOS = 3
STD_RTOL = 1e-6
CPU = torch.device("cpu")


def _palette(schema="schema_a"):
    return np.asarray(Config(schema=schema).palette_rgb, np.uint8)


def _meta(cfg):
    """A config's meta without the id (it holds the time) and with the
    schema cut to its file name."""
    m = cfg.to_meta()
    m.pop("id")
    m["schema"] = os.path.basename(m["schema"])
    return m


def assert_meta_equal(got, want):
    """Two configs' metas field by field but ``id``: exactly, but the
    pixel means and stds at STD_RTOL."""
    got, want = _meta(got), _meta(want)
    for k in ("px_mean", "px_std"):
        a, b = got.pop(k), want.pop(k)
        assert (a is None) == (b is None), k
        if a is not None:
            np.testing.assert_allclose(a, b, rtol=STD_RTOL, err_msg=k)
    assert got == want


def write_photos(root, n=N_PHOTOS, hw=PHOTO_HW, ch=3, seed=0,
                 stray=0.05):
    """n seeded photo (JPEG) and mask (PNG) pairs under root/images and
    root/masks; ``stray`` of the mask pixels take a colour outside the
    palette."""
    pal = _palette()
    img_dir, mask_dir = os.path.join(root, "images"), \
        os.path.join(root, "masks")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(mask_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        true, guide, _ = textured_scene(*hw, len(pal), rng)
        if ch == 1:
            guide = np.repeat(guide.mean(-1, keepdims=True).astype(np.uint8),
                              3, -1)
        mask = pal[true]
        mask[rng.random(hw) < stray] = (1, 2, 3)
        cv2.imwrite(os.path.join(img_dir, f"p{i}.jpg"),
                    cv2.cvtColor(guide, cv2.COLOR_RGB2BGR),
                    [cv2.IMWRITE_JPEG_QUALITY, 95])
        cv2.imwrite(os.path.join(mask_dir, f"p{i}.png"),
                    cv2.cvtColor(mask, cv2.COLOR_RGB2BGR))
    return img_dir, mask_dir


@pytest.fixture(scope="module")
def photos(tmp_path_factory):
    return write_photos(str(tmp_path_factory.mktemp("photos")))


def _cfg(**kw):
    return dict(tile_size=TILE, stride=TILE, **kw)


# --------------------------------------------------------------------- #
# palette
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("schema", ["schema_a", "schema_b"])
@pytest.mark.parametrize("shape", [(3, 17, 19), (1100, 1000)],
                         ids=["tiles", "photo"])
def test_class_encode_matches_jax_and_native(schema, shape):
    pal = _palette(schema)
    rng = np.random.default_rng(5)
    cm = rng.integers(0, len(pal), shape).astype(np.uint8)
    rgb = pal[cm]
    stray = rng.random(shape) < 0.1
    rgb[stray] = rng.integers(0, 256, (int(stray.sum()), 3))
    got = tpalette.class_encode(torch.from_numpy(rgb), pal)
    assert got.dtype == torch.uint8 and tuple(got.shape) == shape
    got = got.numpy()
    np.testing.assert_array_equal(got, np.asarray(
        jpalette.class_encode(rgb, pal)))
    np.testing.assert_array_equal(got, tnative.class_encode(rgb, pal))
    np.testing.assert_array_equal(got, jnative.class_encode(rgb, pal))
    # stray colours take class 1 unless one happens to be in the palette
    np.testing.assert_array_equal(got[~stray], cm[~stray])
    np.testing.assert_array_equal(
        tpalette.class_encode(torch.from_numpy(rgb), pal,
                              default_class=7).numpy(),
        np.asarray(jpalette.class_encode(rgb, pal, default_class=7)))


def test_class_encode_duplicate_colour_takes_first_class():
    pal = np.array([[1, 1, 1], [2, 2, 2], [1, 1, 1]], np.uint8)
    rgb = np.array([[[1, 1, 1], [2, 2, 2], [3, 3, 3]]], np.uint8)
    got = tpalette.class_encode(torch.from_numpy(rgb), pal).numpy()
    np.testing.assert_array_equal(got, [[0, 1, 1]])
    np.testing.assert_array_equal(got, np.asarray(
        jpalette.class_encode(rgb, pal)))


@pytest.mark.parametrize("schema", ["schema_a", "schema_b"])
def test_colourize_matches_jax_and_native(schema):
    pal = _palette(schema)
    cm = np.random.default_rng(3).integers(0, len(pal), (2, 37, 53)
                                           ).astype(np.uint8)
    got = tpalette.colourize(torch.from_numpy(cm), pal).numpy()
    assert got.dtype == np.uint8 and got.shape == (2, 37, 53, 3)
    np.testing.assert_array_equal(got, np.asarray(jpalette.colourize(cm,
                                                                     pal)))
    np.testing.assert_array_equal(got, tnative.colourize(cm, pal))


def test_colourize_out_of_palette_takes_colour_0_as_native():
    """The JAX function fills a class outside the palette with 255; the
    port's device form takes colour 0, as both of its host forms do."""
    pal = _palette()
    cm = np.array([[0, 8, 9, 255]], np.uint8)
    got = tpalette.colourize(torch.from_numpy(cm), pal).numpy()
    np.testing.assert_array_equal(got, tnative.colourize(cm, pal))
    np.testing.assert_array_equal(got[0, 2:], pal[[0, 0]])


def test_map_palette_matches_jax_and_refuses_outside_the_key():
    key = np.array([0, 1, 1, 2, 3, 3, 4, 5, 6, 7, 8])
    cm = np.random.default_rng(4).integers(0, 11, (5, 9)).astype(np.uint8)
    got = tpalette.map_palette(torch.from_numpy(cm), key).numpy()
    np.testing.assert_array_equal(got, np.asarray(jpalette.map_palette(cm,
                                                                       key)))
    np.testing.assert_array_equal(got, key[cm])
    with pytest.raises(ValueError, match="outside the key"):
        tpalette.map_palette(torch.tensor([[0, 11]]), key)


def test_palette_codecs_match_the_reference_goldens():
    """``reference_goldens.npz``: outputs of the reference's own
    class_encode (with its class-1 quirk), colourize and map_palette."""
    g = np.load(GOLDEN)
    pal = _palette()
    enc = tpalette.class_encode(torch.from_numpy(g["encode_in_rgb"]), pal)
    np.testing.assert_array_equal(enc.numpy(), g["encode_out"])
    np.testing.assert_array_equal(
        tpalette.colourize(enc, pal).numpy(), g["colourize_out"])
    np.testing.assert_array_equal(
        tpalette.map_palette(torch.from_numpy(g["map_palette_in"]),
                             g["map_palette_key"]).numpy(),
        g["map_palette_out"])


# --------------------------------------------------------------------- #
# profile
# --------------------------------------------------------------------- #

def assert_profile_equal(got, want):
    """Histograms, counts, probabilities, weights, M2 and JSD exactly;
    the pixel means and stds at STD_RTOL."""
    assert set(got) == set(want)
    for k in want:
        if k in ("px_mean", "px_std"):
            np.testing.assert_allclose(got[k], want[k], rtol=STD_RTOL,
                                       err_msg=k)
        else:
            assert got[k] == want[k], k


@pytest.mark.parametrize("layout", ["nchw", "nhwc", "gray_nchw",
                                    "gray_nhwc"])
def test_profile_matches_jax(layout):
    """Chunks of 4, 4 and 3 tiles; a tenth of the mask values at or above
    ``n_classes`` (255 and n_classes), which neither package counts."""
    rng = np.random.default_rng(6)
    ch = 1 if layout.startswith("gray") else 3
    imgs = rng.integers(0, 256, (11, ch, TILE, TILE)).astype(np.uint8)
    if layout.endswith("nhwc"):
        imgs = np.ascontiguousarray(imgs.transpose(0, 2, 3, 1))
    masks = rng.integers(0, 9, (11, TILE, TILE)).astype(np.uint8)
    out = rng.random(masks.shape) < 0.1
    masks[out] = rng.choice([9, 255], int(out.sum()))
    chunks = [(imgs[i:i + 4], masks[i:i + 4]) for i in range(0, 11, 4)]
    got = profile_tiles(chunks, 9, TILE, CPU)
    want = jax_profile_tiles(chunks, 9, TILE)
    assert_profile_equal(got, want)
    assert got["dset_px_count"] == int((~out).sum())
    assert len(got["px_mean"]) == ch


def test_profile_runs_on_the_card_unless_asked():
    chunks = [(np.zeros((1, 3, 4, 4), np.uint8), np.zeros((1, 4, 4),
                                                          np.uint8))]
    if not torch.cuda.is_available():
        from pylc_tpu_torch.cli import main
        with pytest.raises(RuntimeError, match="no CUDA device"):
            profile_tiles(chunks, 9, 4)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Extractor(PortConfig())
        for argv in (["extract", "-i", "im", "--ch", "3"],
                     ["profile", "--db", "x.h5"], ["augment", "--db", "x.h5"],
                     ["merge", "--dbs", "a.h5"], ["grayscale", "--db", "x.h5"]):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                main(argv)
    assert profile_tiles(chunks, 9, 4, "cpu")["n_samples"] == 1


# --------------------------------------------------------------------- #
# extract
# --------------------------------------------------------------------- #

def run_both(img_dir, mask_dir, cfg_kw, extract_kw=None, seed=0):
    """The same extraction through both packages -> (port, jax)
    extractors, coshuffled and profiled."""
    out = []
    for ex in (Extractor(PortConfig().replace(**cfg_kw), "cpu"),
               JaxExtractor(Config().replace(**cfg_kw))):
        ex.load(img_dir, mask_dir).extract(verbose=False,
                                           **(extract_kw or {}))
        out.append(ex.coshuffle(seed).profile())
    return out


def assert_extractions_equal(port, jax_ex):
    got, want = port.get_data().data, jax_ex.get_data().data
    assert got["img"].dtype == np.uint8 and got["mask"].dtype == np.uint8
    np.testing.assert_array_equal(got["img"], want["img"])
    np.testing.assert_array_equal(got["mask"], want["mask"])
    assert_meta_equal(port.meta, jax_ex.meta)
    assert port.meta.id.startswith("_db_pylc_")


@pytest.mark.parametrize("case", [
    ("plain", {}, {}),
    ("fit_stride16", {}, {"fit": True, "stride": 16}),
    ("scale", {}, {"scale": 0.5}),
    ("two_scales", {"scales": [0.5, 1.0]}, {}),
    ("schema_b", {"schema": "schema_b"}, {}),
], ids=lambda c: c[0])
def test_extraction_matches_jax(photos, case):
    """Tiles, masks and meta (the ``extract`` dict, the profile) of the
    same extraction, field by field but ``id``."""
    _, cfg_kw, extract_kw = case
    kw = _cfg(**cfg_kw)
    if "schema" in kw:
        kw.pop("schema")
        port = Extractor(PortConfig(schema="schema_b").replace(**kw), "cpu")
        jax_ex = JaxExtractor(Config(schema="schema_b").replace(**kw))
        for ex in (port, jax_ex):
            ex.load(*photos).extract(verbose=False).coshuffle(3).profile()
    else:
        port, jax_ex = run_both(*photos, kw, extract_kw, seed=3)
    assert_extractions_equal(port, jax_ex)


def test_grayscale_extraction_matches_jax(tmp_path):
    photos = write_photos(str(tmp_path), n=2, ch=1, seed=4)
    port, jax_ex = run_both(*photos, _cfg(ch=1))
    assert port.get_data().data["img"].shape[1] == 1
    assert_extractions_equal(port, jax_ex)


def test_extract_creates_db_with_meta(photos, tmp_path):
    """The port's counterpart of tests/test_e2e.py's flow: 3 photos of
    96 x 128 at 32 px tiles -> 36 tiles, profiled, saved and read back by
    both packages."""
    ex = Extractor(PortConfig().replace(**_cfg()), "cpu")
    path = ex.load(*photos).extract(verbose=False).coshuffle().profile() \
        .save(str(tmp_path))
    db = TileDB(path)
    meta = db.get_meta(base=PortConfig())
    assert db.size == N_PHOTOS * 12 == meta.n_samples == meta.n_tiles
    assert db.img_shape[1:] == (3, TILE, TILE)
    assert db.mask_shape[1:] == (TILE, TILE)
    assert len(meta.weights) == meta.n_classes
    assert meta.extract["fid"] == "p2_jpg_scale_1.0"
    imgs, masks = db.read_chunk(0, 8)
    assert masks.max() < meta.n_classes
    jdb = JaxTileDB(path)
    jimgs, jmasks = jdb.read_chunk(0, db.size)
    pimgs, pmasks = db.read_chunk(0, db.size)
    np.testing.assert_array_equal(jimgs, pimgs)
    np.testing.assert_array_equal(jmasks, pmasks)
    assert _meta(jdb.get_meta()) == _meta(meta)


def test_each_package_reads_the_others_extracted_db(photos, tmp_path):
    port, jax_ex = run_both(*photos, _cfg())
    p_path = port.save(str(tmp_path / "port"))
    j_path = jax_ex.save(str(tmp_path / "jax"))
    for path in (p_path, j_path):
        a, b = TileDB(path), JaxTileDB(path)
        for (ia, ma), (ib, mb) in zip(a.iter_chunks(7), b.iter_chunks(7)):
            np.testing.assert_array_equal(ia, ib)
            np.testing.assert_array_equal(ma, mb)
        assert _meta(a.get_meta()) == _meta(b.get_meta())
    np.testing.assert_array_equal(TileDB(p_path).read_chunk(0, 36)[0],
                                  JaxTileDB(j_path).read_chunk(0, 36)[0])


def test_multiscale_extraction(photos):
    """scales=[0.5, 1.0] extracts tiles at both pyramid levels
    (reference utils/extract.py:133 loops scales): 96 x 128 gives 12
    tiles at 1.0 and 2 at 0.5 (48 x 64)."""
    cfg = PortConfig().replace(**_cfg(scales=[0.5, 1.0]))
    ex = Extractor(cfg, "cpu").load(*photos).extract(verbose=False)
    n = sum(len(t) for t in ex.imgs)
    assert n == N_PHOTOS * (12 + 2) == ex.meta.n_tiles
    assert ex.meta.extract["fid"].endswith("_scale_1.0")


def test_extract_without_masks(photos, tmp_path):
    """Mask-less extraction (an inference-only DB) survives the whole
    extract -> coshuffle -> profile -> save chain, as in JAX: an empty
    mask array and the config's statistics untouched."""
    img_dir = photos[0]
    port = Extractor(PortConfig().replace(**_cfg()), "cpu").load(img_dir)
    jax_ex = JaxExtractor(Config().replace(**_cfg())).load(img_dir, None)
    for ex in (port, jax_ex):
        ex.extract(verbose=False).coshuffle().profile()
    assert port.get_data().data["mask"].shape == (0,)
    assert_extractions_equal(port, jax_ex)
    path = port.save(str(tmp_path))
    assert os.path.exists(path)
    assert JaxTileDB(path).mask_shape == (0,)
    assert port.meta.px_dist is None


def test_extract_refuses_mismatched_mask(photos, tmp_path):
    img_dir, _ = photos
    mask_dir = tmp_path / "masks"
    mask_dir.mkdir()
    for i in range(N_PHOTOS):
        cv2.imwrite(str(mask_dir / f"p{i}.png"),
                    np.full((64, 64, 3), (10, 20, 30), np.uint8))
    ex = Extractor(PortConfig().replace(**_cfg()), "cpu")
    with pytest.raises(ValueError, match="Dimensions do not match"):
        ex.load(img_dir, str(mask_dir)).extract(verbose=False)
    with pytest.raises(FileNotFoundError):
        ex.load(str(tmp_path / "none"))


# --------------------------------------------------------------------- #
# CLI: extract and profile
# --------------------------------------------------------------------- #

def run_port_cli(argv, cwd):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-m", "pylc_tpu_torch", *argv,
                          "--device", "cpu"], cwd=str(cwd), env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def _only_h5(d):
    (name,) = [f for f in os.listdir(d) if f.endswith(".h5")]
    return os.path.join(d, name)


def test_extract_and_profile_cli_match_pylc(tmp_path, capsys, monkeypatch):
    """``python -m pylc_tpu_torch extract`` and ``profile`` against the
    JAX package's CLI (``pylc.py``'s ``main``) on the same photos: the
    same tiles, masks and meta, and the same printed profile."""
    # the parser has no --tile_size, so the CLI extracts 512 px tiles:
    # two photos of 768 x 1024 give 1 x 2 tiles each
    big = write_photos(str(tmp_path / "big"), n=2, hw=(768, 1024), seed=9)
    argv = ["extract", "-i", big[0], "-m", big[1], "--ch", "3"]
    out_p, out_j = tmp_path / "port", tmp_path / "jax"
    out_p.mkdir()
    out_j.mkdir()
    stdout = run_port_cli(argv + ["--output", str(out_p)], tmp_path)
    assert "Saved 4 tiles to" in stdout
    monkeypatch.chdir(tmp_path)
    jax_main(argv + ["--output", str(out_j)])
    p, j = TileDB(_only_h5(out_p)), JaxTileDB(_only_h5(out_j))
    np.testing.assert_array_equal(p.read_chunk(0, 4)[0],
                                  j.read_chunk(0, 4)[0])
    np.testing.assert_array_equal(p.read_chunk(0, 4)[1],
                                  j.read_chunk(0, 4)[1])
    assert_meta_equal(p.get_meta(), j.get_meta())

    capsys.readouterr()
    jax_main(["profile", "--db", _only_h5(out_p)])
    want = capsys.readouterr().out
    got = run_port_cli(["profile", "--db", _only_h5(out_p)], tmp_path)
    got, want = got.splitlines(), want.splitlines()
    assert len(got) == len(want)
    for a, b in zip(got, want):
        if a.startswith(("Pixel mean", "Pixel std")):
            np.testing.assert_allclose(json.loads(a[24:]),
                                       json.loads(b[24:]), rtol=STD_RTOL)
        else:
            assert a == b
    assert got[1] == "Profile Metadata" and got[6] == f"{'Samples':24s}4"
