"""The slice as a whole: the port's Segmenter and its ``test`` CLI against
the JAX package's Segmenter, same DeepLabV3+/ResNet101 weights, f32 on
the CPU, dense CRF on.

The weights are built once for the module (JAX ``init_state``) and
reach the port as the reference-schema ``.pth`` the JAX exporter
writes."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from pylc_tpu.config import Config
from pylc_tpu.convert import export_deeplab_pth
from pylc_tpu.infer import Segmenter as JaxSegmenter
from pylc_tpu.models.registry import build_model as jax_build_model
from pylc_tpu.ops.crf import make_crf as jax_make_crf
from pylc_tpu.train_state import init_state, make_predict as jax_make_predict
from pylc_tpu_torch.config import Config as PortConfig
from pylc_tpu_torch.infer import STAGES, Segmenter
from pylc_tpu_torch.ops.crf import make_crf
from pylc_tpu_torch.ops.kernels.crf_kernel import crf_iteration
from pylc_tpu_torch.tester import load_model

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TILE, STRIDE = 64, 32
CRF = dict(radius=2, n_iters=2)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    cfg = Config().replace(tile_size=TILE, compute_dtype="float32")
    state, _ = init_state(cfg, jax.random.PRNGKey(0))
    pth = export_deeplab_pth(
        state, cfg, str(tmp_path_factory.mktemp("model") / "m.pth"))
    return cfg, state, pth


@pytest.fixture(scope="module")
def photo():
    # smooth colour fields plus noise: regions for the CRF to follow
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:128, 0:192]
    base = np.stack([yy * 2, xx, (yy + xx) % 256], -1)
    return np.clip(base + rng.normal(0, 12, base.shape), 0,
                   255).astype(np.uint8)


@pytest.fixture(scope="module")
def port_segmenter(weights):
    cfg, _, pth = weights
    cfg, _, predict = load_model(
        pth, Config().replace(compute_dtype="float32"), torch.device("cpu"))
    return Segmenter(cfg, predict, torch.device("cpu"), batch_size=16,
                     crf=make_crf(cfg, **CRF))


@pytest.fixture(scope="module")
def jax_segmenter(weights):
    cfg, state, _ = weights
    return JaxSegmenter(cfg, state,
                        jax_make_predict(cfg, jax_build_model(cfg)),
                        batch_size=16, crf=jax_make_crf(cfg, **CRF))


@pytest.fixture(scope="module")
def photos(photo):
    """Three photos of one shape: the archive path's input."""
    return [photo, np.ascontiguousarray(photo[::-1]),
            np.ascontiguousarray(photo[:, ::-1])]


def test_segmenter_matches_jax(weights, photo, port_segmenter, jax_segmenter):
    cfg, _, _ = weights
    want = jax_segmenter.segment_array(photo, STRIDE)
    got = port_segmenter.segment_array(photo, STRIDE)
    assert got["class_map"].shape == (128, 192)
    assert got["class_map"].dtype == np.uint8
    # f32 conv sums in another order, then the CRF's exp forms
    np.testing.assert_allclose(got["probs"].numpy(),
                               np.asarray(want["probs"]), atol=1e-4)
    differ = np.mean(got["class_map"] != want["class_map"])
    assert differ <= 1e-3, f"class maps differ on {differ:.4%} of pixels"
    np.testing.assert_array_equal(
        got["mask_rgb"], np.asarray(cfg.palette_rgb, np.uint8)[
            got["class_map"]])


def test_staged_and_stream_agree_with_segment_array(photo, port_segmenter):
    base = port_segmenter.segment_array(photo, STRIDE)
    staged = port_segmenter.segment_array_staged(photo, STRIDE)
    assert list(staged["stages"]) == list(STAGES)
    assert all(v >= 0 for v in staged["stages"].values())
    np.testing.assert_array_equal(staged["class_map"], base["class_map"])
    streamed = list(port_segmenter.segment_stream(
        [("a", photo), ("b", photo[:, :128])], STRIDE))
    assert [t for t, _ in streamed] == ["a", "b"]
    np.testing.assert_array_equal(streamed[0][1]["class_map"],
                                  base["class_map"])
    assert streamed[1][1]["class_map"].shape == (128, 128)
    assert crf_iteration.launches == 0  # CPU tensors: the plain form


def test_segment_many_equals_segment_array(photos, port_segmenter):
    """The archive path on the CPU: the photos in turn, each result
    segment_array's own."""
    many = port_segmenter.segment_many(photos, STRIDE)
    assert len(many) == len(photos)
    for img, res in zip(photos, many):
        base = port_segmenter.segment_array(img, STRIDE)
        assert sorted(res) == ["class_map", "completed_s", "mask_rgb",
                               "megapixels", "seconds"]
        np.testing.assert_array_equal(res["class_map"], base["class_map"])
        np.testing.assert_array_equal(res["mask_rgb"], base["mask_rgb"])
        assert res["megapixels"] == base["megapixels"]
    # marginal wall times: they add up to the last completion
    done = [r["completed_s"] for r in many]
    assert done == sorted(done) and all(r["seconds"] > 0 for r in many)
    assert sum(r["seconds"] for r in many) == pytest.approx(done[-1],
                                                            rel=1e-9)
    assert crf_iteration.launches == 0  # CPU tensors: the plain form


def test_segment_many_matches_jax(photos, port_segmenter, jax_segmenter):
    want = jax_segmenter.segment_many(photos, STRIDE)
    got = port_segmenter.segment_many(photos, STRIDE)
    assert len(got) == len(want) == len(photos)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        differ = np.mean(g["class_map"] != w["class_map"])
        assert differ <= 1e-3, f"class maps differ on {differ:.4%} of pixels"
        assert g["megapixels"] == w["megapixels"]


def _stub_segmenter(n_classes=9, tile=TILE):
    """A Segmenter over a predict function with no network: the logit of
    class k is k times the pixel's mean over its channels."""
    cfg = PortConfig().replace(tile_size=tile, compute_dtype="float32")
    assert cfg.n_classes == n_classes

    def predict(tiles):
        mean = tiles.float().mean(dim=-1, keepdim=True) / 255.0
        return mean * torch.arange(n_classes, dtype=torch.float32)

    return Segmenter(cfg, predict, torch.device("cpu"), batch_size=4)


@pytest.mark.parametrize("case", ["empty_list", "empty_tuple", "one_photo",
                                  "two_dimensional"])
def test_segment_many_edge_inputs(case):
    seg = _stub_segmenter()
    rng = np.random.default_rng(3)
    if case.startswith("empty"):
        assert seg.segment_many([] if case == "empty_list" else ()) == []
        return
    shape = (64, 128) if case == "two_dimensional" else (64, 128, 3)
    imgs = [rng.integers(0, 255, shape, dtype=np.uint8)
            for _ in range(1 if case == "one_photo" else 2)]
    out = seg.segment_many(imgs, STRIDE)
    assert len(out) == len(imgs)
    for img, res in zip(imgs, out):
        assert res["class_map"].shape == (64, 128)
        assert res["mask_rgb"].shape == (64, 128, 3)
        np.testing.assert_array_equal(
            res["class_map"], seg.segment_array(img, STRIDE)["class_map"])


@pytest.mark.parametrize("at", [1, 2])
def test_segment_many_refuses_mixed_shapes(at):
    """The JAX package's error text, raised before any photo runs."""
    seg = _stub_segmenter()
    imgs = [np.zeros((64, 128, 3), np.uint8) for _ in range(3)]
    imgs[at] = np.zeros((128, 64, 3), np.uint8)
    with pytest.raises(ValueError) as err:
        seg.segment_many(imgs, STRIDE)
    assert str(err.value) == (
        f"segment_many requires uniform shapes: imgs[{at}] is (128, 64), "
        "imgs[0] is (64, 128) — use segment_stream for mixed-shape "
        "batches.")


@pytest.mark.parametrize("odd", [np.zeros((64, 128, 1), np.uint8),
                                 np.zeros((64, 128), np.uint8),
                                 np.zeros((64, 128, 3), np.float32)],
                         ids=["one_channel", "two_dimensional", "float32"])
def test_segment_many_refuses_mixed_channels_and_dtypes(odd):
    """The pinned buffers of the CUDA path take imgs[0]'s channels and
    dtype, so both paths refuse a photo that differs in either."""
    seg = _stub_segmenter()
    imgs = [np.zeros((64, 128, 3), np.uint8), odd]
    with pytest.raises(ValueError, match=r"uniform shapes: imgs\[1\] is "
                                         r"\(64, 128, [13]\) (uint8|float32)"
                                         r", imgs\[0\] is \(64, 128, 3\) "
                                         r"uint8"):
        seg.segment_many(imgs, STRIDE)


def test_segment_many_mixed_shapes_message_is_jax(photo, port_segmenter,
                                                  jax_segmenter):
    imgs = [photo, photo[:, :128]]
    with pytest.raises(ValueError) as want:
        jax_segmenter.segment_many(imgs, STRIDE)
    with pytest.raises(ValueError) as got:
        port_segmenter.segment_many(imgs, STRIDE)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("entry", ["load_model", "test"])
def test_tester_runs_on_the_card_unless_asked(entry, weights, tmp_path):
    """No device given: the tester's entry points resolve to cuda and
    raise where there is no card; "cpu" has to be asked for."""
    from pylc_tpu_torch import tester
    _, _, pth = weights
    if torch.cuda.is_available():
        pytest.skip("needs a host without a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if entry == "load_model":
            tester.load_model(pth, PortConfig())
        else:
            tester.test(PortConfig(), pth, str(tmp_path))
    cfg, model, _ = tester.load_model(pth, PortConfig(), "cpu")
    assert next(model.parameters()).device.type == "cpu"


def test_cli_writes_segmenter_mask(weights, photo, tmp_path):
    """``python -m pylc_tpu_torch test -l m.pth -i photo.jpg --crf
    --device cpu`` writes the mask the port's Segmenter gives."""
    import cv2

    _, _, pth = weights
    img_path = str(tmp_path / "photo.jpg")
    cv2.imwrite(img_path, cv2.cvtColor(photo, cv2.COLOR_RGB2BGR))
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "pylc_tpu_torch", "test", "-l", pth, "-i",
         img_path, "--crf", "--device", "cpu"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    masks = tmp_path / "data" / "outputs" / "pylc_deeplab_ch3_schema_a" / \
        "masks"
    written = cv2.imread(str(masks / "photo_jpg_scale_1.0.png"))
    assert written is not None, os.listdir(masks)
    cfg, _, predict = load_model(pth, Config(), torch.device("cpu"))
    want = Segmenter(cfg, predict, torch.device("cpu"),
                     crf=make_crf(cfg)).segment_file(img_path)["mask_rgb"]
    np.testing.assert_array_equal(cv2.cvtColor(written, cv2.COLOR_BGR2RGB),
                                  want)


def test_cli_refuses_missing_card_and_unported_modes(weights, tmp_path):
    from pylc_tpu_torch.cli import main
    _, _, pth = weights
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["test", "-l", pth, "-i", str(tmp_path)])
    for mode in (["export", "-l", pth, "--size", "64x64"],
                 ["serve", "-l", pth]):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            main(mode + ["--device", "cpu"])
    for flag in (["--n_devices", "2"], ["--multihost"]):
        with pytest.raises(NotImplementedError, match="item 18"):
            main(["train", "--db", "x.h5", "--device", "cpu", *flag])
    ckpt = tmp_path / "m.ckpt"
    ckpt.touch()  # anything but a .pth is read as the JAX package's .ckpt
    with pytest.raises(ValueError, match="not a msgpack model file"):
        load_model(str(ckpt), Config(), "cpu")


UNET = dict(arch="unet", unet_depth=3, unet_wf=3, input_size=TILE,
            output_size=24)


@pytest.fixture(scope="module")
def unet_ckpt(tmp_path_factory):
    """A small U-Net (64 px in, 24 px out) as the JAX package's best-model
    ``.ckpt``, which the port reads through the bridge."""
    from pylc_tpu.checkpoint import Checkpoint
    cfg = Config().replace(tile_size=TILE, compute_dtype="float32", **UNET)
    state, _ = init_state(cfg, jax.random.PRNGKey(1))
    ckpt = Checkpoint(cfg.gen_model_id(), str(tmp_path_factory.mktemp("u")))
    ckpt.save(state, cfg, epoch=1, is_best=True)
    return cfg, state, ckpt.model_file


@pytest.mark.parametrize("use_crf", [False, True], ids=["plain", "crf"])
def test_unet_segmenter_matches_jax(unet_ckpt, photo, use_crf):
    """Logits smaller than the tile (a valid-conv U-Net's 24 of 64 px)
    are resized to the tile before the softmax, in both packages."""
    cfg, state, path = unet_ckpt
    base = PortConfig().replace(compute_dtype="float32", **UNET)
    pcfg, _, predict = load_model(path, base, "cpu")
    assert predict(torch.zeros(1, TILE, TILE, 3, dtype=torch.uint8)
                   ).shape == (1, 24, 24, 9)
    got = Segmenter(pcfg, predict, torch.device("cpu"), batch_size=4,
                    crf=make_crf(pcfg, **CRF) if use_crf else None
                    ).segment_array(photo, STRIDE)
    want = JaxSegmenter(cfg, state,
                        jax_make_predict(cfg, jax_build_model(cfg)),
                        batch_size=4,
                        crf=jax_make_crf(cfg, **CRF) if use_crf else None
                        ).segment_array(photo, STRIDE)
    assert got["class_map"].shape == (128, 192)
    np.testing.assert_allclose(got["probs"].numpy(),
                               np.asarray(want["probs"]), atol=1e-4)
    differ = np.mean(got["class_map"] != want["class_map"])
    assert differ <= 1e-3, f"class maps differ on {differ:.4%} of pixels"


def test_unet_goes_through_every_segmenter_entry(unet_ckpt, photo):
    """``segment_many`` and ``segment_stream`` get the resize too: all
    three go through one canvas function."""
    _, _, path = unet_ckpt
    base = PortConfig().replace(compute_dtype="float32", **UNET)
    pcfg, _, predict = load_model(path, base, "cpu")
    seg = Segmenter(pcfg, predict, torch.device("cpu"), batch_size=4)
    want = seg.segment_array(photo, STRIDE)["class_map"]
    (many,) = seg.segment_many([photo], STRIDE)
    ((_, streamed),) = seg.segment_stream([("a", photo)], STRIDE)
    np.testing.assert_array_equal(many["class_map"], want)
    np.testing.assert_array_equal(streamed["class_map"], want)


def test_cli_reads_a_jax_ckpt(photo, tmp_path):
    """``python -m pylc_tpu_torch test -l m.ckpt``: a DeepLab/MobileNetV2
    best model of the JAX package (arch and backbone ride in its
    ``.meta``) gives the mask of the port's Segmenter on that model."""
    import cv2

    from pylc_tpu.checkpoint import Checkpoint
    cfg = Config().replace(tile_size=TILE, backbone="mobilenet")
    state, _ = init_state(cfg, jax.random.PRNGKey(2))
    ckpt = Checkpoint(cfg.gen_model_id(), str(tmp_path / "save"))
    ckpt.save(state, cfg, epoch=1, is_best=True)
    img_path = str(tmp_path / "photo.jpg")
    cv2.imwrite(img_path, cv2.cvtColor(photo, cv2.COLOR_RGB2BGR))
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "pylc_tpu_torch", "test", "-l",
         ckpt.model_file, "-i", img_path, "--device", "cpu"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    masks = tmp_path / "data" / "outputs" / cfg.gen_model_id() / "masks"
    written = cv2.imread(str(masks / "photo_jpg_scale_1.0.png"))
    assert written is not None, os.listdir(masks)
    pcfg, model, predict = load_model(ckpt.model_file, PortConfig(), "cpu")
    assert type(model.backbone).__name__ == "MobileNetV2"
    want = Segmenter(pcfg, predict, torch.device("cpu")).segment_file(
        img_path)["mask_rgb"]
    np.testing.assert_array_equal(cv2.cvtColor(written, cv2.COLOR_BGR2RGB),
                                  want)
