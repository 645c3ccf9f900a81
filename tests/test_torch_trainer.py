"""The port's tile DB, trainer, checkpoints, ImageNet loader and ``train``
CLI, against the JAX package where both have the piece.

Training runs on the CPU at 32 px tiles, batch 2, from a 10-tile DB (8
train, 2 validation tiles).  The best model a port run writes loads in
both packages' testers."""

import dataclasses
import json
import os
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch

from pylc_tpu.config import Config
from pylc_tpu.db.database import TileDB as JaxTileDB
from pylc_tpu.db.dataset import TileDataset as JaxTileDataset
from pylc_tpu_torch.db import TileDB, TileDataset
from pylc_tpu_torch.models.registry import build_model
from pylc_tpu_torch.trainer import train

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TILE, N_TILES, BATCH = 32, 10, 2
UNET = dict(unet_depth=3, unet_wf=3, input_size=64, output_size=24)


def _cfg(tmp, **kw):
    return Config().replace(tile_size=TILE, batch_size=BATCH, n_epochs=1,
                            compute_dtype="float32", save_dir=str(tmp),
                            **kw)


def _tiles(n=N_TILES, tile=TILE, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (n, 3, tile, tile), dtype=np.uint8),
            rng.integers(0, 9, (n, tile, tile), dtype=np.uint8))


@pytest.fixture(scope="module")
def h5_db(tmp_path_factory):
    imgs, masks = _tiles()
    path = str(tmp_path_factory.mktemp("db") / "tiles.h5")
    JaxTileDB.save(path, imgs, masks, Config().replace(tile_size=TILE,
                                                       id="_db_test"))
    return path


@pytest.fixture(scope="module")
def trained(tmp_path_factory, h5_db):
    save = tmp_path_factory.mktemp("save")
    cfg = _cfg(save)
    summary = train(cfg, h5_db, verbose=False, device="cpu")
    return cfg, summary


def _batches(ds, epochs=2):
    return [(i.copy(), m.copy()) for _ in range(epochs) for i, m in ds]


@pytest.mark.parametrize("source,shuffle,part", [
    ("h5", False, (0.0, 0.8)), ("h5", True, (0.0, 0.8)),
    ("memory", False, (0.8, 1.0)), ("memory", True, (0.0, 1.0))])
def test_tile_db_and_dataset_match_jax(h5_db, source, shuffle, part):
    """Same partition (ceil indices), chunk order, per-epoch seeded
    shuffle and batches as the JAX TileDB/TileDataset, over two epochs."""
    if source == "h5":
        dbs = [cls(h5_db, partition=part) for cls in (TileDB, JaxTileDB)]
    else:
        imgs, masks = _tiles(n=23, seed=1)
        data = {"img": imgs, "mask": masks, "meta": Config().to_meta()}
        dbs = [cls(data=data, partition=part) for cls in (TileDB, JaxTileDB)]
    ours, theirs = dbs
    assert (ours.start, ours.end, ours.partition_size) == \
        (theirs.start, theirs.end, theirs.partition_size)
    kw = dict(batch_size=3, shuffle=shuffle, chunk_size=4, seed=5,
              drop_last=not shuffle)
    got = _batches(TileDataset(ours, **kw))
    want = _batches(JaxTileDataset(theirs, **kw))
    assert len(got) == len(want) > 0
    for (gi, gm), (wi, wm) in zip(got, want):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gm, wm)
    for shard in ((0, 2), (1, 2)):
        assert ours.shard_range(shard, drop_tail=False) == \
            theirs.shard_range(shard, drop_tail=False)


def test_tile_db_needs_exactly_one_source():
    with pytest.raises(ValueError, match="exactly one"):
        TileDB()


def test_train_writes_losses_and_best_model(trained):
    cfg, summary = trained
    assert summary["steps"] == 4 and summary["epochs"] == 1
    model_dir = os.path.join(cfg.save_dir, summary["model_id"])
    with open(os.path.join(model_dir, "losses.json")) as f:
        losses = json.load(f)
    assert len(losses["valid"]) == 2      # epoch 0 and after epoch 1
    assert losses["train"] and losses["best_dice"] < 1.0
    assert np.isfinite(np.asarray([r[1:] for r in losses["train"]
                                   + losses["valid"]])).all()
    best = torch.load(os.path.join(model_dir, summary["model_id"] + ".pth"),
                      weights_only=True)
    assert set(best) == {"model", "meta"}
    assert best["meta"]["tile_size"] == TILE
    ckpt = torch.load(os.path.join(model_dir, "checkpoint.pth"),
                      weights_only=True)
    assert (ckpt["epoch"], ckpt["iter"]) == (1, 4)
    assert {"model", "optimizer", "scheduler", "meta"} <= set(ckpt)


def test_resume_runs_exactly_n_epochs(tmp_path, h5_db):
    cfg = _cfg(tmp_path)
    train(cfg, h5_db, verbose=False, device="cpu")
    summary = train(cfg.replace(n_epochs=2, resume_checkpoint=True), h5_db,
                    verbose=False, device="cpu")
    assert summary["epochs"] == 1          # 2 - the 1 already run
    assert summary["steps"] == 8
    with open(os.path.join(str(tmp_path), summary["model_id"],
                           "losses.json")) as f:
        losses = json.load(f)
    assert [r[0] for r in losses["valid"]] == [0, 4, 4, 8]
    assert [step for step, _ in losses["lr"]] == [0, 4]
    # step_lr: the resumed epoch runs at lr * gamma
    assert losses["lr"][1][1] == pytest.approx(cfg.lr * cfg.gamma)


def test_explicit_pretrained_path_must_exist(tmp_path, h5_db):
    for pretrained in (str(tmp_path / "missing.pth"), True):
        with pytest.raises(FileNotFoundError, match="pretrained"):
            train(_cfg(tmp_path, pretrained=pretrained), h5_db,
                  verbose=False, device="cpu")


@dataclasses.dataclass(frozen=True)
class _State:
    """The two fields of a JAX TrainState the ImageNet loader touches."""
    params: dict
    batch_stats: dict

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def test_resnet101_imagenet_loader_matches_jax(tmp_path):
    from pylc_tpu.convert import convert_resnet_backbone
    from pylc_tpu.convert import load_resnet101_imagenet as jax_load
    from pylc_tpu_torch.convert import (load_resnet101_imagenet,
                                        resnet_state_dict)
    cfg = Config().replace(tile_size=TILE)
    gen = torch.Generator().manual_seed(3)
    sd = {k: torch.randn(v.shape, generator=gen) if v.is_floating_point()
          else v for k, v in build_model(cfg).backbone.state_dict().items()}
    sd["fc.weight"] = torch.randn(1000, 2048, generator=gen)
    sd["fc.bias"] = torch.randn(1000, generator=gen)
    path = str(tmp_path / "resnet101-test.pth")
    torch.save(sd, path)

    model = build_model(cfg)
    load_resnet101_imagenet(path, model)
    got = model.backbone.state_dict()
    for k, v in got.items():
        assert torch.equal(v, sd[k]), k

    p, s = convert_resnet_backbone({k: v for k, v in sd.items()
                                    if not k.startswith("fc.")})
    zeros = _State({"backbone": jax_tree_zeros(p)},
                   {"backbone": jax_tree_zeros(s)})
    state = jax_load(path, zeros)
    want = resnet_state_dict(state.params["backbone"],
                             state.batch_stats["backbone"])
    assert set(want) <= set(got)
    for k, v in want.items():
        assert torch.equal(got[k], v), k

    torch.save({**sd, "extra.weight": torch.zeros(1)}, path)
    with pytest.raises(RuntimeError, match="extra"):
        load_resnet101_imagenet(path, build_model(cfg))


def jax_tree_zeros(tree):
    return {k: jax_tree_zeros(v) if isinstance(v, dict) else np.zeros_like(v)
            for k, v in tree.items()}


def test_trained_pth_loads_in_both_testers(trained, tmp_path):
    """The port's best model in the reference schema: the port's tester
    and the JAX package's give the same class map on one photo."""
    from pylc_tpu.tester import test as jax_test
    from pylc_tpu_torch.tester import test as port_test
    cfg, summary = trained
    pth = os.path.join(cfg.save_dir, summary["model_id"],
                       summary["model_id"] + ".pth")
    img = np.random.default_rng(4).integers(0, 256, (64, 96, 3),
                                            dtype=np.uint8)
    photo = str(tmp_path / "photo.jpg")
    cv2.imwrite(photo, img)
    masks = {}
    for name, run, kw in (("port", port_test, {"device":
                                               torch.device("cpu")}),
                          ("jax", jax_test, {"n_devices": 1,
                                             "verbose": False})):
        out = tmp_path / name
        # f32 in both: their bf16 paths round in different places
        run(Config().replace(output_dir=str(out), compute_dtype="float32"),
            pth, photo, scale=1.0, **kw)
        (mask,) = (out / summary["model_id"] / "masks").iterdir()
        masks[name] = cv2.imread(str(mask))
    assert masks["port"].shape == (64, 96, 3)
    agree = np.mean(np.all(masks["port"] == masks["jax"], axis=-1))
    assert agree >= 0.999, agree


def test_train_and_test_take_the_jax_arguments():
    """``trainer.train`` and ``tester.test`` take the JAX package's
    arguments in its order (a third positional argument of ``train`` is
    the device count in both), with ``device`` keyword-only after them."""
    import inspect
    from pylc_tpu import tester as jax_tester
    from pylc_tpu import trainer as jax_trainer
    from pylc_tpu_torch import tester as port_tester
    from pylc_tpu_torch import trainer as port_trainer
    for port, ref in ((port_trainer.train, jax_trainer.train),
                      (port_tester.test, jax_tester.test)):
        got = list(inspect.signature(port).parameters.values())
        want = list(inspect.signature(ref).parameters.values())
        # the port's ``db`` is the JAX package's ``db_path``, or a dict
        assert [(p.name, p.default) for p in got[:-1]] == \
            [(p.name.replace("db_path", "db"), p.default) for p in want]
        assert got[-1].name == "device"
        assert got[-1].kind is inspect.Parameter.KEYWORD_ONLY


def test_train_takes_n_devices_positionally(tmp_path, capsys, monkeypatch):
    """``train(cfg, db, None, False, device="cpu")`` runs and prints
    nothing; ``n_devices`` 1 runs too; 2 spawns two ranks on the CPU
    (gloo), which take the 2 steps with a row each; 8 would spawn eight.
    A small U-Net on an in-memory DB (6 tiles of 64 px)."""
    from pylc_tpu_torch import trainer
    from pylc_tpu_torch.parallel import mesh
    from pylc_tpu_torch.config import Config as PortConfig
    cfg = PortConfig().replace(tile_size=64, batch_size=BATCH, n_epochs=1,
                               compute_dtype="float32", arch="unet",
                               save_dir=str(tmp_path), **UNET)
    imgs, masks = _tiles(6, 64)
    db = {"img": imgs, "mask": masks, "meta": cfg.replace(id="mem").to_meta()}
    assert train(cfg, db, None, False, device="cpu")["steps"] == 2
    assert capsys.readouterr().out == ""
    assert train(cfg, db, 1, False, device="cpu")["steps"] == 2
    monkeypatch.setattr(mesh, "JOIN_TIMEOUT_S", 120)
    assert train(cfg, db, 2, False, device="cpu")["steps"] == 2
    assert capsys.readouterr().out == ""
    spawned = []
    monkeypatch.setattr(trainer, "spawn",
                        lambda fn, n, *a, **kw: spawned.append(
                            (fn, n, kw["devices"])))
    train(cfg, db, 8, device="cpu")
    assert spawned == [(trainer.train, 8, (torch.device("cpu"),) * 8)]


@pytest.mark.parametrize("resume", [False, True])
def test_only_rank_0_touches_losses_json(resume, tmp_path, monkeypatch):
    """``train`` on a rank other than 0 builds its loss tracker without
    reading, removing or writing a stale ``losses.json``: when every rank
    removed it, two ranks could both see it and the second raised
    ``FileNotFoundError``.  The rank is patched to 1 of 2 and the run stops
    right after the tracker is built; rank 0 still removes the stale log,
    or reads it with ``resume``."""
    from pylc_tpu_torch import checkpoint, trainer
    from pylc_tpu_torch.config import Config as PortConfig

    class Built(Exception):
        pass

    built = []

    def tracker(*args, **kw):
        built.append(checkpoint.RunningLoss(*args, **kw))
        raise Built

    cfg = PortConfig().replace(tile_size=64, batch_size=BATCH, n_epochs=1,
                               compute_dtype="float32", arch="unet",
                               save_dir=str(tmp_path),
                               resume_checkpoint=resume, **UNET)
    imgs, masks = _tiles(6, 64)
    db = {"img": imgs, "mask": masks, "meta": cfg.replace(id="mem").to_meta()}
    model_id = TileDB(data=db).get_meta(base=cfg, data_only=True) \
        .gen_model_id()
    log = tmp_path / model_id / "losses.json"
    log.parent.mkdir()
    stale = {"train": [[1, 0.5, 0.5, 0.5]], "valid": [[1, 0.4, 0.3, 0.2]],
             "best_dice": 0.3, "lr": [[1, 1e-4]]}
    log.write_text(json.dumps(stale))
    monkeypatch.setattr(trainer, "RunningLoss", tracker)
    monkeypatch.setattr(trainer, "world_size", lambda: 2)
    monkeypatch.setattr(trainer, "rank", lambda: 1)
    with pytest.raises(Built):
        train(cfg, db, device="cpu")
    (loss,) = built
    assert log.exists(), "rank 1 removed losses.json"
    assert json.loads(log.read_text()) == stale
    assert (loss.train, loss.valid, loss.best_dice) == ([], [], 1.0)
    assert not loss.owner
    with pytest.raises(RuntimeError, match="only the owner"):
        loss.save()
    assert json.loads(log.read_text()) == stale

    monkeypatch.setattr(trainer, "rank", lambda: 0)
    built.clear()
    with pytest.raises(Built):
        train(cfg, db, device="cpu")
    (loss,) = built
    assert loss.owner and log.exists() == resume
    assert loss.best_dice == (0.3 if resume else 1.0)


def test_tester_takes_verbose_and_n_devices(trained, tmp_path, capsys):
    """``tester.test(..., verbose=False, n_devices=1)`` segments and
    prints nothing; ``verbose=True`` prints the photo's line and its
    metrics; ``n_devices=2`` segments on a mesh of two CPU entries, with
    the same result, and says so."""
    from pylc_tpu_torch.tester import test as port_test
    cfg, summary = trained
    pth = os.path.join(cfg.save_dir, summary["model_id"],
                       summary["model_id"] + ".pth")
    rng = np.random.default_rng(5)
    photo, mask = str(tmp_path / "p.jpg"), str(tmp_path / "p.png")
    cv2.imwrite(photo, rng.integers(0, 256, (64, 96, 3), dtype=np.uint8))
    pal = np.asarray(cfg.palette_rgb, np.uint8)
    cv2.imwrite(mask, pal[rng.integers(0, 9, (64, 96))][..., ::-1])
    out = cfg.replace(output_dir=str(tmp_path / "out"))
    capsys.readouterr()
    (res,) = port_test(out, pth, photo, mask, 1.0, False, False, False,
                       False, 1, device="cpu")
    assert capsys.readouterr().out == ""
    assert 0 <= res["metrics"]["f1"] <= 1
    port_test(out, pth, photo, mask, 1.0, verbose=True, device="cpu")
    printed = capsys.readouterr().out
    assert "MP/s" in printed and "F1" in printed
    (on_mesh,) = port_test(out, pth, photo, mask, 1.0, n_devices=2,
                           device="cpu")
    assert "Inference mesh: 2 devices" in capsys.readouterr().out
    assert on_mesh["metrics"] == res["metrics"]


def test_train_cli_runs_on_the_cpu(tmp_path, h5_db):
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-m", "pylc_tpu_torch", "train", "--db", h5_db,
         "--batch_size", "2", "--n_epochs", "1", "--report", "2",
         "--device", "cpu"], cwd=str(tmp_path), env=env,
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "Training done: 4 steps" in out.stdout
    model_id = Config().gen_model_id()
    model_dir = tmp_path / "data" / "save" / model_id
    assert (model_dir / f"{model_id}.pth").exists()
    assert json.loads((model_dir / "losses.json").read_text())["valid"]


@pytest.mark.parametrize("backbone", ["resnet", "xception", "mobilenet",
                                      "drn"])
def test_pretrained_rule_matches_jax_for_every_backbone(backbone, tmp_path,
                                                        monkeypatch):
    """The JAX trainer's rule and default paths: the config's default
    names the ResNet101 file, which another backbone reads as its own
    default; a missing default trains from scratch; the flag or a path of
    the user's own must exist; the U-Nets have no encoder."""
    from pylc_tpu_torch.config import Config as PortConfig
    from pylc_tpu_torch.trainer import PRETRAINED_PATHS, resolve_pretrained
    monkeypatch.chdir(tmp_path)
    cfg = PortConfig().replace(backbone=backbone)
    own = PRETRAINED_PATHS[backbone]
    assert os.path.basename(own) == {
        "resnet": "resnet101-5d3b4d8f.pth",
        "xception": "xception-b5690688.pth",
        "mobilenet": "mobilenet_v2-6a65762b.pth",
        "drn": "drn_d_54-0e0534ff.pth"}[backbone]
    assert cfg.pretrained == PRETRAINED_PATHS["resnet"]
    assert resolve_pretrained(cfg) is None
    # another backbone's default is a default still: no loud failure
    other = PRETRAINED_PATHS["drn" if backbone != "drn" else "xception"]
    assert resolve_pretrained(cfg.replace(pretrained=other)) is None
    with pytest.raises(FileNotFoundError, match=os.path.basename(own)):
        resolve_pretrained(cfg.replace(pretrained=True))
    with pytest.raises(FileNotFoundError, match="mine.pth"):
        resolve_pretrained(cfg.replace(pretrained="./mine.pth"))
    os.makedirs("data/models")
    open(own, "wb").close()
    assert resolve_pretrained(cfg) == own
    assert resolve_pretrained(cfg.replace(pretrained=True)) == own
    assert resolve_pretrained(cfg.replace(arch="unet",
                                          pretrained=True)) is None


def test_trainer_loads_the_backbones_encoder(tmp_path, monkeypatch):
    """``train`` with an encoder file at a path of the user's: the
    backbone starts from it (MobileNetV2; a wrong file fails loudly)."""
    from pylc_tpu_torch.config import Config as PortConfig
    imgs, masks = _tiles()
    cfg = PortConfig().replace(
        tile_size=TILE, batch_size=BATCH, n_epochs=1, lr=0.0,
        weight_decay=0.0, compute_dtype="float32", backbone="mobilenet",
        save_dir=str(tmp_path), pretrained=str(tmp_path / "enc.pth"))
    db = {"img": imgs, "mask": masks, "meta": cfg.replace(id="m").to_meta()}
    gen = torch.Generator().manual_seed(9)
    sd = {k: torch.rand(v.shape, generator=gen) + 0.5
          for k, v in build_model(cfg).backbone.state_dict().items()
          if v.is_floating_point()}
    torch.save({"not": torch.zeros(1)}, cfg.pretrained)
    with pytest.raises(ValueError, match="not a MobileNetV2"):
        train(cfg, db, verbose=False, device="cpu")
    torch.save(sd, cfg.pretrained)
    model = train(cfg, db, verbose=False, device="cpu")["model"]
    got = model.backbone.state_dict()
    for k in sd:  # lr 0: the weights are the file's still
        if not k.endswith(("running_mean", "running_var")):
            assert torch.equal(got[k], sd[k]), k


@pytest.mark.parametrize("kw", [
    dict(UNET, arch="unet", up_mode="upconv", ch=1),
    dict(UNET, arch="resunet", norm_type="layer", activ_type="gelu"),
    dict(UNET, arch="unet", norm_type="instance", head_lr_mult=10.0),
], ids=["unet_upconv_ch1", "resunet_layer_gelu", "unet_instance_head_lr"])
def test_trainer_and_tester_run_the_unets(kw, tmp_path):
    """``trainer.train`` on a U-Net (the mask cropped to the 24 px the
    unpadded convs leave of 64), its best model under the port's own key
    names through ``tester.test`` with the CRF on, all on the CPU."""
    from pylc_tpu_torch.config import Config as PortConfig
    from pylc_tpu_torch.tester import test as port_test
    ch = kw.get("ch", 3)
    rng = np.random.default_rng(2)
    cfg = PortConfig().replace(
        tile_size=64, batch_size=BATCH, n_epochs=1, compute_dtype="float32",
        save_dir=str(tmp_path / "save"), output_dir=str(tmp_path / "out"),
        **kw)
    db = {"img": rng.integers(0, 256, (6, ch, 64, 64), dtype=np.uint8),
          "mask": rng.integers(0, 9, (6, 64, 64), dtype=np.uint8),
          "meta": cfg.replace(id="mem").to_meta()}
    summary = train(cfg, db, verbose=False, device="cpu")
    assert summary["steps"] == 2 and 0 < summary["best_dice"] < 1
    pth = os.path.join(cfg.save_dir, summary["model_id"],
                       summary["model_id"] + ".pth")
    best = torch.load(pth, weights_only=True)
    assert best["meta"]["arch"] == kw["arch"]
    assert "enc0.conv0.weight" in best["model"]
    assert best["model"]["enc0.conv0.weight"].shape[1] == ch

    photo = str(tmp_path / "photo.jpg")
    img = rng.integers(0, 256, (128, 192, 3), dtype=np.uint8)
    cv2.imwrite(photo, img)
    (res,) = port_test(cfg, pth, photo, scale=1.0, use_crf=True,
                       device="cpu")
    (mask,) = (tmp_path / "out" / summary["model_id"] / "masks").iterdir()
    assert cv2.imread(str(mask)).shape == (128, 192, 3)
    assert res["megapixels"] == pytest.approx(128 * 192 / 1e6)


@pytest.mark.parametrize("flags", [
    ["--backbone", "mobilenet"],
    ["--backbone", "drn", "--normalize", "instance"],
    ["--backbone", "xception", "--normalize", "layer", "--activation",
     "lrelu"],
], ids=["mobilenet", "drn_instance", "xception_layer"])
def test_train_cli_runs_the_new_backbones_on_the_cpu(flags, tmp_path, h5_db):
    """``python -m pylc_tpu_torch train --backbone ... --normalize ...
    --device cpu``, and for the BatchNorm model (the meta does not carry
    the normalizer) ``test`` on its best model."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "pylc_tpu_torch", "train", "--db", h5_db,
         "--batch_size", "2", "--n_epochs", "1", "--device", "cpu", *flags],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "Training done: 4 steps" in out.stdout
    model_id = Config().gen_model_id()
    pth = tmp_path / "data" / "save" / model_id / f"{model_id}.pth"
    best = torch.load(str(pth), weights_only=True)
    assert best["meta"]["backbone"] == flags[1]
    keys = {"mobilenet": "backbone.features.17.conv.7.weight",
            "drn": "backbone.layer8.0.weight",
            "xception": "backbone.block20.rep.8.weight"}
    assert keys[flags[1]] in best["model"]
    assert ("backbone.bn1.running_mean" in best["model"]
            or "backbone.features.0.1.running_mean" in best["model"]) \
        == (len(flags) == 2)
    if len(flags) > 2:
        return
    photo = str(tmp_path / "photo.jpg")
    cv2.imwrite(photo, np.random.default_rng(3).integers(
        0, 256, (32, 64, 3), dtype=np.uint8))
    out = subprocess.run(
        [sys.executable, "-m", "pylc_tpu_torch", "test", "-l", str(pth),
         "-i", photo, "--crf", "--device", "cpu"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    (mask,) = (tmp_path / "data" / "outputs" / model_id / "masks").iterdir()
    assert cv2.imread(str(mask)).shape == (32, 64, 3)
