"""The port's tools on the CPU: ``utils/tracing.py`` against
``pylc_tpu/utils/tracing.py``, ``utils/analyze.py`` through the flows of
tests/test_analyze.py, and ``gui.py``'s presenter through the flows of
tests/test_gui.py, its masks held against the JAX package's presenter on
the same model."""

import json
import os
import subprocess
import sys
import threading

import cv2
import jax
import numpy as np
import pytest
import torch

from pylc_tpu.checkpoint import Checkpoint
from pylc_tpu.config import Config, DEFAULT_SCHEMA, Schema
from pylc_tpu.extract import Extractor as JaxExtractor
from pylc_tpu.gui import ClassifierPresenter as JaxPresenter
from pylc_tpu.train_state import init_state
from pylc_tpu.utils import tracing as jax_tracing
from pylc_tpu_torch.extract import Extractor
from pylc_tpu_torch.gui import ClassifierPresenter
from pylc_tpu_torch.utils import analyze as an
from pylc_tpu_torch.utils import tracing

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TILE = 64
# argmax agreement of the two packages' bf16 presenters (0.996 measured
# on the tiny model below)
BF16_AGREEMENT = 0.99


# --------------------------------------------------------------------- #
# tracing
# --------------------------------------------------------------------- #

def test_trace_writes_a_chrome_trace_with_the_annotations(tmp_path):
    """Regions from this thread and from a thread started before the
    trace (as a server's) are in the written trace."""
    go, done = threading.Event(), threading.Event()

    def worker():
        go.wait(30)
        with tracing.annotate("pylc.worker_region"):
            torch.ones(64, 64) @ torch.ones(64, 64)
        done.set()

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    with tracing.trace(str(tmp_path / "tr")) as prof:
        with tracing.annotate("pylc.test_region"):
            torch.ones(32, 32) @ torch.ones(32, 32)
        go.set()
        assert done.wait(30)
    t.join(timeout=30)
    path = tmp_path / "tr" / tracing.TRACE_FILE
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"pylc.test_region", "pylc.worker_region"} <= names
    assert any(e.key == "pylc.test_region" for e in prof.key_averages())


@pytest.mark.parametrize("python_tracer", [False, True])
def test_trace_python_stack_option(tmp_path, python_tracer):
    with tracing.trace(str(tmp_path), python_tracer=python_tracer) as prof:
        torch.ones(8) + 1
    assert prof.with_stack is python_tracer
    assert os.path.getsize(tmp_path / tracing.TRACE_FILE) > 0


def test_stage_timer_matches_jax_api():
    """Same stages, total, report layout and dict as the JAX package's
    StageTimer; ``sync_on`` takes tensors (a CPU tensor needs no wait)."""
    port, ref = tracing.StageTimer(), jax_tracing.StageTimer()
    x = torch.ones(16)
    for timer in (port, ref):
        with timer.stage("decode"):
            pass
        with timer.stage("forward", sync_on=None):
            pass
    with port.stage("sync", sync_on={"a": [x, (x * 2,)]}):
        x = x + 1
    with ref.stage("sync", sync_on=jax.numpy.ones(4)):
        pass
    assert [n for n, _ in port.stages] == [n for n, _ in ref.stages]
    assert port.total() == pytest.approx(sum(port.as_dict().values()))
    lines = port.report().splitlines()
    assert lines[0] == ref.report().splitlines()[0]
    assert [ln.split()[0] for ln in lines] == \
        [ln.split()[0] for ln in ref.report().splitlines()]
    assert list(port.as_dict()) == ["decode", "forward", "sync"]


def test_stage_timer_records_a_failed_stage():
    timer = tracing.StageTimer()
    with pytest.raises(ZeroDivisionError):
        with timer.stage("boom"):
            1 / 0
    assert [n for n, _ in timer.stages] == ["boom"]


# --------------------------------------------------------------------- #
# analyze: the flows of tests/test_analyze.py
# --------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def small_db(tmp_path_factory):
    """tests/test_analyze.py's 2-photo dataset, extracted by the port; the
    JAX package's extraction of it is the same DB."""
    root = tmp_path_factory.mktemp("an")
    img_dir, mask_dir = root / "images", root / "masks"
    img_dir.mkdir()
    mask_dir.mkdir()
    schema = Schema.load(DEFAULT_SCHEMA)
    palette = np.array(schema.palette_rgb, dtype=np.uint8)
    rng = np.random.default_rng(3)
    for i in range(2):
        img = rng.integers(0, 256, (128, 192, 3)).astype(np.uint8)
        cmap = np.broadcast_to(np.arange(192) * schema.n_classes // 192,
                               (128, 192)).astype(np.uint8)
        cv2.imwrite(str(img_dir / f"a{i}.jpg"),
                    cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
        cv2.imwrite(str(mask_dir / f"a{i}.png"),
                    cv2.cvtColor(palette[cmap], cv2.COLOR_RGB2BGR))
    kw = dict(tile_size=TILE, stride=TILE, ch=3, buffer_size=16)
    from pylc_tpu_torch.config import Config as PortConfig
    paths = []
    for name, ex in (("port", Extractor(PortConfig().replace(**kw), "cpu")),
                     ("jax", JaxExtractor(Config().replace(**kw)))):
        ex.load(str(img_dir), str(mask_dir)).extract(verbose=False)
        paths.append(ex.profile().save(str(root / name)))
    return paths[0], paths[1], str(img_dir)


def test_db_plots_write_artifacts(small_db, tmp_path):
    path, jax_path, _ = small_db
    db, meta = an.load_db(path)
    _, jmeta = an.load_db(jax_path)
    assert db.size == 12 and meta.n_classes == jmeta.n_classes == 9
    assert meta.probs == pytest.approx(jmeta.probs)
    for out in (an.plot_legend(meta, str(tmp_path / "legend.png")),
                an.plot_profile(meta, str(tmp_path / "profile.png")),
                an.plot_samples(path, n=4, out_path=str(tmp_path / "s.png")),
                an.plot_grid_profiles(path, n=6, n_cols=3,
                                      rates=list(range(12)),
                                      out_path=str(tmp_path / "grid.png"))):
        assert os.path.getsize(out) > 0
    assert sorted(os.listdir(tmp_path)) == ["grid.png", "legend.png",
                                            "profile.png", "s.png"]


def test_run_and_loss_plots(tmp_path):
    """plot_losses on one run and plot_run_comparison over two, from
    losses.json logs in the trainers' schema."""
    dirs = []
    rng = np.random.default_rng(0)
    for name in ("run_a", "run_b"):
        d = tmp_path / name
        d.mkdir()
        rows = [[int(i), float(2.0 / (1 + i) + rng.random() * .05),
                 float(0.9 - 0.02 * i), float(0.4 / (1 + i))]
                for i in range(1, 12)]
        with open(d / "losses.json", "w") as f:
            json.dump({"train": rows, "valid": rows[::4],
                       "lr": [[r[0], 1e-4] for r in rows]}, f)
        dirs.append(str(d))
    assert os.path.getsize(an.plot_losses(dirs[0],
                                          str(tmp_path / "one.png"))) > 0
    assert [r["name"] for r in an.load_runs(dirs)] == ["run_a", "run_b"]
    assert os.path.getsize(an.plot_run_comparison(
        dirs, str(tmp_path / "cmp.png"))) > 0
    from pylc_tpu.utils import analyze as jan
    v = rng.random(20)
    np.testing.assert_array_equal(an._smooth(v, 5), jan._smooth(v, 5))


def test_eval_comparison_and_prediction_panels(small_db, tmp_path):
    _, _, img_dir = small_db
    paths = []
    for i, (f1, iou, mcc) in enumerate([(0.8, 0.7, 0.6), (0.9, 0.8, 0.7)]):
        p = tmp_path / f"m{i}_eval.json"
        with open(p, "w") as f:
            json.dump({"f1": f1, "iou": iou, "mcc": mcc, "report": {}}, f)
        paths.append(str(p))
    assert os.path.getsize(an.plot_eval_comparison(
        paths, str(tmp_path / "eval.png"))) > 0
    img_path = os.path.join(img_dir, "a0.jpg")
    fake = np.zeros((128, 192, 3), np.uint8)
    fake[..., 1] = 200
    assert os.path.getsize(an.compare_predictions(
        img_path, {"exp1": fake, "exp2": fake[:, :, ::-1]},
        str(tmp_path / "preds.png"))) > 0
    assert os.path.getsize(an.side_by_side(
        img_path, fake, fake, out_path=str(tmp_path / "sbs.png"))) > 0
    written = an.load_output_mask(str(tmp_path / "sbs.png"))
    assert written.ndim == 3 and written.shape[2] == 3


# --------------------------------------------------------------------- #
# gui: the presenter's flows of tests/test_gui.py
# --------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def tiny_model(tmp_path_factory):
    """A DeepLab/MobileNetV2 best model of the JAX package (.ckpt and
    .meta), which both presenters load."""
    cfg = Config().replace(arch="deeplab", backbone="mobilenet", ch=3,
                           tile_size=TILE, compute_dtype="float32")
    state, _ = init_state(cfg, jax.random.PRNGKey(3))
    ckpt = Checkpoint(cfg.gen_model_id(),
                      str(tmp_path_factory.mktemp("gui_model")))
    ckpt.save(state, cfg, epoch=1, is_best=True)
    return ckpt.model_file


@pytest.fixture(scope="module")
def tiny_image(tmp_path_factory):
    img = np.random.default_rng(5).integers(0, 255, (96, 128, 3))
    p = str(tmp_path_factory.mktemp("gui_img") / "photo.jpg")
    cv2.imwrite(p, img.astype(np.uint8))
    return p


def test_missing_inputs_validation(tiny_model, tiny_image, tmp_path):
    p = ClassifierPresenter(device="cpu")
    assert "Select a model" in p.missing_inputs()
    p.model_path, p.img_path = str(tmp_path / "nope.ckpt"), tiny_image
    assert "Model file not found" in p.missing_inputs()
    p.model_path, p.img_path = tiny_model, str(tmp_path / "nope.jpg")
    assert "Image file not found" in p.missing_inputs()
    p.img_path = tiny_image
    assert p.missing_inputs() is None


def test_segment_preview_save_flow(tiny_model, tiny_image, tmp_path):
    """Segment, preview, status, save, headless; the mask agrees with
    the JAX package's presenter's on the same model.  Both presenters
    serve in bf16 (``Config()``'s default), where the JAX model also runs
    BatchNorm in bf16 and torch autocast keeps it in f32 (ROADMAP Queue
    3), hence BF16_AGREEMENT and not the f32 tests' 0.999."""
    p = ClassifierPresenter(device="cpu")
    p.model_path, p.img_path = tiny_model, tiny_image
    res = p.segment()
    assert res is p.result
    mask = res["mask_rgb"]
    assert mask.shape == (96, 128, 3) and mask.dtype == np.uint8

    ppm = p.preview_ppm(max_px=64)
    header, raw = ppm.split(b" 255 ", 1)
    assert header.startswith(b"P6 ")
    w, h = (int(v) for v in header.split()[1:])
    assert (h, w) == (48, 64) and len(raw) == h * w * 3
    status = p.done_status()
    assert status.startswith("Done:") and "MP/s" in status

    pal = {tuple(c) for c in Schema.load(DEFAULT_SCHEMA).palette_rgb}
    assert {tuple(int(v) for v in u)
            for u in np.unique(mask.reshape(-1, 3), axis=0)} <= pal
    j = JaxPresenter()
    j.model_path, j.img_path = tiny_model, tiny_image
    want = j.segment()["mask_rgb"]
    assert np.mean(np.all(mask == want, -1)) >= BF16_AGREEMENT
    assert p.preview_ppm(max_px=64)[:16] == j.preview_ppm(max_px=64)[:16]

    out = str(tmp_path / "mask.png")
    assert p.save_mask(out) == "Saved mask.png"
    np.testing.assert_array_equal(
        cv2.cvtColor(cv2.imread(out), cv2.COLOR_BGR2RGB), mask)


def test_save_without_result_is_noop(tmp_path):
    p = ClassifierPresenter()
    assert p.save_mask(str(tmp_path / "x.png")) is None
    assert not os.path.exists(tmp_path / "x.png")


def test_presenter_runs_on_the_card_unless_asked(tiny_model, tiny_image):
    p = ClassifierPresenter()
    p.model_path, p.img_path = tiny_model, tiny_image
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            p.segment()


def test_gui_module_entry_point():
    """``python -m pylc_tpu_torch.gui`` parses its flags (the window
    itself needs a display)."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-m", "pylc_tpu_torch.gui",
                          "--help"], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and "--device" in out.stdout
