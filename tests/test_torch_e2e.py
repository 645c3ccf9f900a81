"""End-to-end flows through both packages, on the CPU: photos on disk ->
tile DB -> training -> segmentation, the port's counterparts of
tests/test_e2e.py's ``test_train_and_infer_e2e`` and
``test_grayscale_pipeline_e2e``.

Each flow extracts the same photos with both packages and holds the two
DBs equal, then trains the port on the JAX package's DB.  Training is
not compared across packages (AdamW's first step is about lr * sign(g),
see tests/test_torch_train.py); the port's best model is.  A DeepLab's
best ``.pth`` segments a photo in both packages' testers, in f32: the
class maps agree on AGREEMENT of the pixels and F1 and IoU within
METRIC_ATOL.  A U-Net's ``.pth`` is read by the port only (the JAX
package loads DeepLab ``.pth`` files alone)."""

import os

import cv2
import numpy as np
import pytest
import torch

from pylc_tpu.config import Config
from pylc_tpu.db.database import TileDB as JaxTileDB
from pylc_tpu.extract import Extractor as JaxExtractor
from pylc_tpu_torch.config import Config as PortConfig
from pylc_tpu_torch.db import TileDB
from pylc_tpu_torch.extract import Extractor
from pylc_tpu_torch.trainer import train

from test_torch_data import assert_meta_equal, write_photos

torch.set_num_threads(1)

AGREEMENT = 0.999
METRIC_ATOL = 1e-4


def extract_both(photos, out_dir, **kw):
    """The photos through both packages' extractors and into .h5 files:
    (port's path, JAX's path), after holding the two DBs equal."""
    paths = []
    for name, ex in (("port", Extractor(PortConfig().replace(**kw), "cpu")),
                     ("jax", JaxExtractor(Config().replace(**kw)))):
        ex.load(*photos).extract(verbose=False).coshuffle().profile()
        paths.append(ex.save(os.path.join(out_dir, name)))
    p, j = TileDB(paths[0]), JaxTileDB(paths[1])
    assert p.size == j.size > 0
    for (ip, mp), (ij, mj) in zip(p.iter_chunks(64), j.iter_chunks(64)):
        np.testing.assert_array_equal(ip, ij)
        np.testing.assert_array_equal(mp, mj)
    assert_meta_equal(p.get_meta(), j.get_meta())
    return paths


def test_train_and_infer_e2e(tmp_path):
    """4 photos of 64 x 96 at 32 px tiles (24 tiles; half of them kept
    by ``clip``) -> DeepLabV3+/ResNet101 trained by the port for one
    epoch on the JAX package's DB -> the best ``.pth`` segments the
    first photo against its mask in both testers."""
    from pylc_tpu.tester import test as jax_test
    from pylc_tpu_torch.tester import test as port_test
    photos = write_photos(str(tmp_path / "raw"), n=4, hw=(64, 96), seed=1)
    _, jax_db = extract_both(photos, str(tmp_path / "db"), tile_size=32,
                             stride=32)
    cfg = PortConfig().replace(
        tile_size=32, batch_size=2, n_epochs=1, clip=0.5,
        compute_dtype="float32", save_dir=str(tmp_path / "save"))
    summary = train(cfg, jax_db, None, False, device="cpu")
    assert summary["steps"] == 5 and np.isfinite(summary["best_dice"])
    model_dir = os.path.join(cfg.save_dir, summary["model_id"])
    pth = os.path.join(model_dir, summary["model_id"] + ".pth")
    # the resume checkpoints (AdamW's state, ~0.7 GB each) are not needed
    os.remove(os.path.join(model_dir, "checkpoint.pth"))
    os.remove(os.path.join(model_dir, "checkpoint.ckpt"))

    photo = os.path.join(photos[0], "p0.jpg")
    mask = os.path.join(photos[1], "p0.png")
    runs = {}
    for name, run, conf, kw in (
            ("port", port_test, PortConfig, {"device": "cpu"}),
            ("jax", jax_test, Config, {"n_devices": 1})):
        out = tmp_path / name
        (res,) = run(conf().replace(output_dir=str(out),
                                    compute_dtype="float32"),
                     pth, photo, mask, 1.0, verbose=False, **kw)
        (png,) = (out / summary["model_id"] / "masks").iterdir()
        runs[name] = (cv2.imread(str(png)), res["metrics"])
    (pm, pmet), (jm, jmet) = runs["port"], runs["jax"]
    assert pm.shape == (64, 96, 3)
    assert np.mean(np.all(pm == jm, axis=-1)) >= AGREEMENT
    for k in ("f1", "iou"):
        assert abs(pmet[k] - jmet[k]) <= METRIC_ATOL, (k, pmet[k], jmet[k])


def test_grayscale_pipeline_e2e(tmp_path):
    """ch=1 end to end: 3 grayscale photos of 128 x 192 -> DBs of 64 px
    single-channel tiles from both packages -> a U-Net trained by the port
    on the JAX package's DB -> the port's tester on every photo."""
    from pylc_tpu_torch.tester import test as port_test
    photos = write_photos(str(tmp_path / "raw"), n=3, hw=(128, 192), ch=1,
                          seed=2)
    kw = dict(ch=1, tile_size=64, stride=64)
    _, jax_db = extract_both(photos, str(tmp_path / "db"), **kw)
    assert JaxTileDB(jax_db).img_shape[1] == 1
    cfg = PortConfig().replace(
        **kw, input_size=64, output_size=24, unet_depth=3, unet_wf=3,
        arch="unet", batch_size=4, n_epochs=1, buffer_size=64, dropout=0.0,
        report=4, compute_dtype="float32", save_dir=str(tmp_path / "save"),
        output_dir=str(tmp_path / "out"))
    summary = train(cfg, jax_db, None, False, device="cpu")
    assert summary["steps"] == 3
    model = os.path.join(cfg.save_dir, summary["model_id"],
                         summary["model_id"] + ".pth")
    assert torch.load(model, weights_only=True)["meta"]["ch"] == 1
    results = port_test(cfg, model, photos[0], photos[1], 1.0,
                        verbose=False, device="cpu")
    assert len(results) == 3
    assert all(0 <= r["metrics"]["f1"] <= 1 for r in results)
    masks = os.listdir(tmp_path / "out" / summary["model_id"] / "masks")
    assert len(masks) == 3


@pytest.mark.parametrize("fit", [False, True], ids=["plain", "fit"])
def test_extracted_dbs_equal_across_packages(tmp_path, fit):
    """The extraction both flows start from, with and without the grid
    fit, at the CLI's 512 px tiles on one photo of 600 x 1100."""
    photos = write_photos(str(tmp_path / "raw"), n=1, hw=(600, 1100),
                          seed=3)
    paths = []
    for ex in (Extractor(PortConfig(), "cpu"), JaxExtractor(Config())):
        ex.load(*photos).extract(fit=fit, verbose=False).coshuffle()
        paths.append(ex.profile().save(str(tmp_path / type(ex).__module__)))
    p, j = TileDB(paths[0]), JaxTileDB(paths[1])
    assert p.size == j.size == 2
    np.testing.assert_array_equal(p.read_chunk(0, 2)[0],
                                  j.read_chunk(0, 2)[0])
    np.testing.assert_array_equal(p.read_chunk(0, 2)[1],
                                  j.read_chunk(0, 2)[1])
    assert_meta_equal(p.get_meta(), j.get_meta())
    if fit:
        assert p.get_meta().extract["w_fitted"] == 1024


# --------------------------------------------------------------------- #
# the train and resume flows of tests/test_e2e.py, through both packages
# on one extracted DB
# --------------------------------------------------------------------- #

# tests/test_e2e.py's tiny U-Net run
TINY = dict(tile_size=64, stride=64, input_size=64, output_size=24,
            unet_depth=3, unet_wf=3, arch="unet", ch=3, batch_size=4,
            n_epochs=1, buffer_size=64, dropout=0.0, report=4)


@pytest.fixture(scope="module")
def flows_db(tmp_path_factory):
    """Four 192 x 256 photos at 64 px tiles, extracted by both packages
    and held equal: 48 tiles.  Returns the JAX package's ``.h5``."""
    root = tmp_path_factory.mktemp("flows")
    photos = write_photos(str(root / "raw"), n=4, hw=(192, 256), seed=7)
    _, jax_db = extract_both(photos, str(root / "db"), tile_size=64,
                             stride=64)
    assert TileDB(jax_db).size == 48
    return jax_db


def _trainers(db, tmp_path, name, **kw):
    """(port's run, JAX's run) of the tiny training on ``db`` with
    ``kw``; each run takes more fields and returns (cfg, summary), and
    each package saves under a directory of its own."""
    from pylc_tpu.trainer import train as jax_train

    def port(**more):
        cfg = PortConfig().replace(**{**TINY, **kw, **more}, save_dir=str(
            tmp_path / name / "port"))
        return cfg, train(cfg, db, None, False, device="cpu")

    def jax_run(**more):
        cfg = Config().replace(**{**TINY, **kw, **more}, save_dir=str(
            tmp_path / name / "jax"))
        return cfg, jax_train(cfg, db, n_devices=1, verbose=False)

    return port, jax_run


def test_checkpoint_resume_runs_full_epochs(flows_db, tmp_path):
    """Resume completes exactly n_epochs (the reference's range(offset,
    n - offset) shrank it, train.py:72), in both packages, with the same
    steps."""
    summaries = {}
    for name, run in zip(("port", "jax"),
                         _trainers(flows_db, tmp_path, "resume")):
        run()
        _, summaries[name] = run(n_epochs=2, resume_checkpoint=True)
    assert summaries["port"]["epochs"] == summaries["jax"]["epochs"] == 1
    assert summaries["port"]["steps"] == summaries["jax"]["steps"] > 0


def test_db_meta_does_not_stomp_cli_arch(flows_db):
    """--arch chosen at train time survives the DB meta's data fields,
    in both packages' readers of the same DB."""
    for db, conf in ((TileDB(flows_db), PortConfig),
                     (JaxTileDB(flows_db), Config)):
        base = conf().replace(**TINY).replace(arch="resunet",
                                              backbone="xception")
        cfg = db.get_meta(base=base, data_only=True)
        assert (cfg.arch, cfg.backbone) == ("resunet", "xception")
        assert cfg.n_samples == 48 and cfg.px_mean is not None


def test_validation_smaller_than_batch_still_tracks_best(flows_db,
                                                         tmp_path):
    """A validation split smaller than the batch (48 tiles -> 9 to
    validate, batch 32) still validates and saves the best model, in
    both packages."""
    import json
    for name, run in zip(("port", "jax"),
                         _trainers(flows_db, tmp_path, "valid",
                                   batch_size=32)):
        cfg, summary = run()
        model_dir = os.path.join(cfg.save_dir, summary["model_id"])
        with open(os.path.join(model_dir, "losses.json")) as f:
            d = json.load(f)
        assert len(d["valid"]) >= 2, name   # initial + end of epoch
        assert d["best_dice"] < 1.0, name
        ext = ".pth" if name == "port" else ".ckpt"
        assert os.path.exists(os.path.join(
            model_dir, summary["model_id"] + ext)), name


def test_db_clip_fraction(flows_db):
    """clip keeps a fraction of the DB (reference db/database.py:71)."""
    for cls in (TileDB, JaxTileDB):
        assert cls(flows_db, clip=0.5).size == 24
        assert cls(flows_db).size == 48
