"""The port's own copies of the jax-free modules (config, CLI parser,
reference-``.pth`` loader, host palette look-ups, evaluator, the numpy
utilities ``balance.py`` and ``synthetic.py``) against the JAX package's,
on the CPU.

The port imports nothing of ``pylc_tpu``; these tests import both and
hold the copies equal: exactly (names, defaults, parsed configs, byte
look-ups) except for the ``schema`` path, which each package resolves
against its own ``schemas/`` directory, and the evaluator's float
metrics, which are the same sklearn calls on the same arrays and are
compared exactly too.
"""

import dataclasses
import filecmp
import json
import os
import sys
import types

import numpy as np
import pytest
import torch

from pylc_tpu import cli as jcli
from pylc_tpu import config as jconfig
from pylc_tpu import convert as jconvert
from pylc_tpu import evaluate as jevaluate
from pylc_tpu import native as jnative
from pylc_tpu_torch import cli as tcli
from pylc_tpu_torch import config as tconfig
from pylc_tpu_torch import convert as tconvert
from pylc_tpu_torch import evaluate as tevaluate
from pylc_tpu_torch import native as tnative

SCHEMAS = ("schema_a", "schema_b")


def _plain(cfg):
    """A config of either package as a dict, the schema path cut to its
    file name."""
    d = dataclasses.asdict(cfg)
    d["schema"] = os.path.basename(d["schema"])
    return d


def _meta(cfg):
    m = cfg.to_meta()
    m["schema"] = os.path.basename(m["schema"])
    return m


def _profiled(cfg):
    """``cfg`` with the fields a profiled DB carries."""
    n = cfg.n_classes
    return cfg.replace(
        id="db_7", n_samples=12, n_tiles=40, px_mean=[1.5, 2.5, 3.5],
        px_std=[0.5, 0.25, 0.125], px_dist=[[1] * n, [2] * n],
        dset_px_dist=list(range(n)), dset_px_count=99,
        probs=[1.0 / n] * n, weights=[float(i) for i in range(n)], m2=0.25,
        jsd=0.5, extract={"fid": "a", "n": 3}, scales=[0.5, 1.0])


# --------------------------------------------------------------------- #
# config
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("name", ["META_FIELDS", "DATA_META_FIELDS"])
def test_meta_field_lists_equal(name):
    assert getattr(tconfig, name) == getattr(jconfig, name)


def test_config_fields_names_types_defaults_equal():
    jf, tf = dataclasses.fields(jconfig.Config), \
        dataclasses.fields(tconfig.Config)
    assert [f.name for f in tf] == [f.name for f in jf]
    assert [str(f.type) for f in tf] == [str(f.type) for f in jf]
    assert _plain(tconfig.Config()) == _plain(jconfig.Config())
    assert tconfig.Config is not jconfig.Config


@pytest.mark.parametrize("prop", ["ch_label", "tiles_per_image",
                                  "tile_px_count", "pad_size", "crop_window"])
def test_config_derived_properties_equal(prop):
    kw = dict(ch=1, scales=[0.5, 1.0], tile_size=64, input_size=128,
              output_size=100)
    assert getattr(tconfig.Config().replace(**kw), prop) == \
        getattr(jconfig.Config().replace(**kw), prop)


@pytest.mark.parametrize("schema", SCHEMAS)
def test_schema_files_and_loaded_schemas_equal(schema):
    jpath = os.path.join(jconfig.SCHEMA_DIR, schema + ".json")
    tpath = os.path.join(tconfig.SCHEMA_DIR, schema + ".json")
    assert os.path.dirname(tpath).endswith(
        os.path.join("pylc_tpu_torch", "schemas"))
    assert filecmp.cmp(jpath, tpath, shallow=False)
    # a bare name resolves against each package's own directory
    js, ts = jconfig.Schema.load(schema), tconfig.Schema.load(schema)
    assert ts.path == tpath and js.path == jpath
    for f in ("class_labels", "class_codes", "palette_hex", "palette_rgb",
              "n_classes", "name"):
        assert getattr(ts, f) == getattr(js, f), f
    assert ts.n_classes == {"schema_a": 9, "schema_b": 11}[schema]


@pytest.mark.parametrize("schema", SCHEMAS)
def test_to_meta_equal(schema):
    j = _profiled(jconfig.Config(schema=schema))
    t = _profiled(tconfig.Config(schema=schema))
    assert _meta(t) == _meta(j)
    assert list(t.to_meta()) == list(j.to_meta())  # key order: same bytes
    assert json.loads(t.to_meta_json()) == t.to_meta()
    assert t.gen_model_id() == j.gen_model_id()
    assert t.describe().replace(t.schema, "") == \
        j.describe().replace(j.schema, "")


@pytest.mark.parametrize("schema", SCHEMAS)
@pytest.mark.parametrize("fields", [None, "data"])
def test_meta_round_trip_across_packages(schema, fields):
    """Meta written by either package rehydrates in the other to the same
    config; with DATA_META_FIELDS the base's network settings stay."""
    jf = jconfig.DATA_META_FIELDS if fields else None
    tf = tconfig.DATA_META_FIELDS if fields else None
    jmeta = _profiled(jconfig.Config(schema=schema)).replace(
        arch="unet", backbone="xception", normalize_default=True).to_meta()
    tmeta = _profiled(tconfig.Config(schema=schema)).replace(
        arch="unet", backbone="xception", normalize_default=True).to_meta()
    jbase = jconfig.Config().replace(arch="resunet", lr=0.5)
    tbase = tconfig.Config().replace(arch="resunet", lr=0.5)
    got = tconfig.Config.from_meta_json(json.dumps(jmeta), tbase, tf)
    want = jconfig.Config.from_meta_json(json.dumps(tmeta), jbase, jf)
    assert isinstance(got, tconfig.Config)
    assert _plain(got) == _plain(want)
    assert got.arch == ("resunet" if fields else "unet")
    assert got.lr == 0.5 and got.n_tiles == 40
    assert got.n_classes == len(got.class_labels)
    assert _meta(got) == _meta(want)
    # unknown keys, *_options and None values are ignored
    noisy = dict(tmeta, not_a_field=1, arch_options=("x",), id=None,
                 tile_px_count=5)
    again = tconfig.Config.from_meta(noisy, tbase, tf)
    assert again.id is None and again.tile_px_count == again.tile_size ** 2
    assert again.arch_options == tbase.arch_options


def test_replace_semantics_equal():
    kw = dict(lr=None, tile_size=32, tile_px_count=7, nonsense=3,
              schema="schema_b")
    j, t = jconfig.Config().replace(**kw), tconfig.Config().replace(**kw)
    assert _plain(t) == _plain(j)
    assert t.lr == 1e-4 and t.n_classes == 11 and t.tile_px_count == 1024
    base = tconfig.Config()
    base.replace(tile_size=64)
    assert base.tile_size == 512  # pure


def test_missing_schema_raises():
    with pytest.raises(FileNotFoundError):
        tconfig.Schema.load("no_such_schema")


# --------------------------------------------------------------------- #
# CLI parser
# --------------------------------------------------------------------- #

ARGVS = {
    # the argument lists of tests/test_cli.py's train and test flows
    "train_flags": [
        "train", "--db", "x.h5", "--arch", "unet", "--backbone", "xception",
        "--optim", "sgd", "--sched", "cyclic_lr", "--normalize", "syncbatch",
        "--activation", "lrelu", "--lr", "0.01", "--batch_size", "4",
        "--n_epochs", "3", "--weighted", "--resume", "--clip", "0.5",
        "--up_mode", "upconv", "--ce_weight", "0.3"],
    "train_plain": ["train", "--db", "x"],
    "train_multihost": ["train", "--db", "x", "--multihost"],
    "train_more": ["train", "--db", "x", "--schema", "schema_b",
                   "--dice_weight", "0.2", "--focal_weight", "0.1",
                   "--pretrained", "--n_workers", "2", "--report", "5",
                   "--head_lr_mult", "10", "--n_devices", "1"],
    "test_flags": ["test", "-l", "m.ckpt", "-i", "img.jpg", "-m", "mask.png",
                   "--scale", "0.5", "--save_logits", "--aggregate_metrics",
                   "--crf"],
    "test_crf": ["test", "-l", "m.pth", "-i", "d", "--crf", "--crf_iters",
                 "4", "--crf_radius", "2", "--crf_downsample", "1",
                 "--crf_w_app", "2.5", "--crf_sigma_app", "4",
                 "--crf_sigma_color", "9", "--crf_w_smooth", "0.5",
                 "--crf_sigma_smooth", "2", "--n_devices", "1"],
    "extract": ["extract", "-i", "im", "-m", "ma", "--ch", "1",
                "--batch_size", "3", "--output", "o"],
    "augment": ["augment", "--db", "d", "--output", "o"],
    "merge": ["merge", "--dbs", "a", "b", "--output", "o"],
    "grayscale": ["grayscale", "--db", "d"],
    "profile": ["profile", "--db", "d", "--schema", "schema_b"],
    "export": ["export", "-l", "m", "--size", "1024x1536", "--stride", "256",
               "--crf", "--platforms", "cpu", "-o", "out"],
    "serve": ["serve", "-l", "m", "--port", "9000", "--scale", "0.5",
              "--crf"],
}


@pytest.mark.parametrize("case", sorted(ARGVS))
def test_parser_yields_equal_args_and_config(case):
    argv = ARGVS[case]
    jargs = jcli.get_parser().parse_args(argv)
    targs = tcli.get_parser().parse_args(argv)
    jvars = {k: v for k, v in vars(jargs).items() if k != "func"}
    tvars = dict(vars(targs))
    assert tvars.pop("device") == "cuda"
    assert tvars == jvars
    got, want = tcli._cfg_from_args(targs), jcli._cfg_from_args(jargs)
    assert isinstance(got, tconfig.Config)
    assert _plain(got) == _plain(want)


def test_parser_subcommands_and_flags_equal():
    def flags(parser):
        sub = parser._subparsers._group_actions[0].choices
        return {mode: sorted(s for a in p._actions for s in a.option_strings)
                for mode, p in sub.items()}
    jf, tf = flags(jcli.get_parser()), flags(tcli.get_parser())
    assert sorted(tf) == sorted(jf)
    for mode in jf:
        assert sorted(jf[mode] + ["--device"]) == tf[mode], mode


@pytest.mark.parametrize("argv,device", [
    (["test", "-l", "m", "-i", "x"], "cuda"),
    (["test", "-l", "m", "-i", "x", "--device", "cpu"], "cpu"),
    (["--device", "cpu", "test", "-l", "m", "-i", "x"], "cpu"),
    (["--device", "cuda:1", "train", "--db", "d", "--device", "cpu"], "cpu"),
])
def test_parser_device_flag(argv, device):
    args = tcli.get_parser().parse_args(argv)
    assert args.device == device
    assert not hasattr(tcli._cfg_from_args(args), "device")


def test_parser_rejects_bad_choice():
    with pytest.raises(SystemExit):
        tcli.get_parser().parse_args(["train", "--db", "x", "--normalize",
                                      "synbatch"])


@pytest.mark.parametrize("mode", sorted(tcli.NOT_PORTED))
def test_unported_modes_raise_with_their_roadmap_item(mode, tmp_path,
                                                      monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item"):
        tcli.main(ARGVS[mode] + ["--device", "cpu"])


# --------------------------------------------------------------------- #
# numpy utilities copied whole: balance.py and synthetic.py
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("module,names", [
    ("balance", ["jsd", "m2"]),
    ("synthetic", ["value_noise", "textured_scene", "miou"]),
])
def test_copied_numpy_utilities_equal(module, names):
    """Every function of the port's copy has the original's source, and
    gives the original's output on seeded inputs."""
    import importlib
    import inspect
    jmod = importlib.import_module(f"pylc_tpu.utils.{module}")
    tmod = importlib.import_module(f"pylc_tpu_torch.utils.{module}")
    public = {n for n, v in vars(jmod).items()
              if inspect.isfunction(v) and v.__module__ == jmod.__name__}
    assert public == set(names)
    for name in names:
        assert inspect.getsource(getattr(tmod, name)) == \
            inspect.getsource(getattr(jmod, name)), name
    if module == "balance":
        p = np.random.default_rng(0).dirichlet(np.ones(9))
        q = np.full(9, 1 / 9)
        assert tmod.jsd(p, q) == jmod.jsd(p, q)
        assert tmod.m2(p, 9) == jmod.m2(p, 9)
    else:
        a, b = (mod.textured_scene(40, 56, 9, np.random.default_rng(1))
                for mod in (tmod, jmod))
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
        assert tmod.miou(a[0], (a[0] + 1) % 9, 9) == \
            jmod.miou(b[0], (b[0] + 1) % 9, 9)


# --------------------------------------------------------------------- #
# reference .pth loader
# --------------------------------------------------------------------- #

def test_load_reference_pth_equal(tmp_path):
    """A ``.pth`` whose meta is a pickled ``config.Parameters`` loads in
    both packages to the same dict, with no ``config`` module left."""
    ref = types.ModuleType("config")

    class Parameters:
        pass

    Parameters.__module__, Parameters.__qualname__ = "config", "Parameters"
    ref.Parameters = Parameters
    meta = Parameters()
    meta.arch, meta.ch, meta.n_classes, meta.tile_size = "deeplab", 3, 9, 64
    path = str(tmp_path / "ref.pth")
    sys.modules["config"] = ref
    try:
        torch.save({"model": {"w": torch.arange(6.).view(2, 3)},
                    "meta": meta}, path)
    finally:
        del sys.modules["config"]
    got, want = tconvert.load_reference_pth(path), \
        jconvert.load_reference_pth(path)
    assert "config" not in sys.modules
    assert got["meta"].__dict__ == want["meta"].__dict__ == meta.__dict__
    assert type(got["meta"]).__module__.startswith("pylc_tpu_torch")
    assert torch.equal(got["model"]["w"], want["model"]["w"])
    cfg = tconfig.Config.from_meta(dict(got["meta"].__dict__))
    assert cfg.tile_size == 64 and isinstance(cfg, tconfig.Config)


# --------------------------------------------------------------------- #
# host palette look-ups
# --------------------------------------------------------------------- #

def _palette(schema):
    return np.asarray(tconfig.Schema.load(schema).palette_rgb, np.uint8)


def test_native_cpp_form_is_built_here():
    """This host has g++, so the C++ forms run; the parametrised cases
    below name the form they test."""
    assert tnative.available() is True
    assert os.path.exists(tnative.SOURCE)
    assert jnative.available() is True


@pytest.mark.parametrize("form", ["cpp", "numpy"])
@pytest.mark.parametrize("schema", SCHEMAS)
def test_colourize_equal(form, schema):
    pal = _palette(schema)
    cm = np.random.default_rng(3).integers(0, len(pal), (37, 53)
                                           ).astype(np.uint8)
    fn = tnative.colourize if form == "cpp" else tnative.colourize_numpy
    got = fn(cm, pal)
    assert got.dtype == np.uint8 and got.shape == (37, 53, 3)
    np.testing.assert_array_equal(got, jnative.colourize(cm, pal))
    np.testing.assert_array_equal(got, pal[cm])


@pytest.mark.parametrize("form", ["cpp", "numpy"])
def test_colourize_out_of_palette_takes_colour_0(form):
    pal = _palette("schema_a")
    cm = np.array([[0, 8, 9, 255]], np.uint8)
    fn = tnative.colourize if form == "cpp" else tnative.colourize_numpy
    got = fn(cm, pal)
    np.testing.assert_array_equal(got, jnative.colourize(cm, pal))
    np.testing.assert_array_equal(got[0, 2], pal[0])
    np.testing.assert_array_equal(got[0, 3], pal[0])


@pytest.mark.parametrize("form", ["cpp", "numpy"])
@pytest.mark.parametrize("shape", [(41, 29), (1100, 1000)],
                         ids=["scan", "table"])
def test_class_encode_equal_with_unmatched_pixels(form, shape):
    """Both of the C++ form's strategies (palette scan under 1 Mpx, direct
    table above) and the numpy form; a colour that is not in the palette
    becomes class 1, the reference's quirk."""
    pal = _palette("schema_b")
    rng = np.random.default_rng(5)
    cm = rng.integers(0, len(pal), shape).astype(np.uint8)
    rgb = pal[cm]
    stray = rng.random(shape) < 0.1
    rgb[stray] = (1, 2, 3)
    fn = tnative.class_encode if form == "cpp" else \
        tnative.class_encode_numpy
    got = fn(rgb, pal)
    assert got.dtype == np.uint8 and got.shape == shape
    np.testing.assert_array_equal(got, jnative.class_encode(rgb, pal))
    np.testing.assert_array_equal(got, np.where(stray, 1, cm))
    np.testing.assert_array_equal(fn(rgb[:8], pal, default_class=0)[stray[:8]],
                                  0)


@pytest.mark.parametrize("form", ["cpp", "numpy"])
def test_class_encode_duplicate_colour_takes_first_class(form):
    pal = np.array([[1, 1, 1], [2, 2, 2], [1, 1, 1]], np.uint8)
    rgb = np.array([[[1, 1, 1], [2, 2, 2]]], np.uint8)
    fn = tnative.class_encode if form == "cpp" else \
        tnative.class_encode_numpy
    np.testing.assert_array_equal(fn(rgb, pal), [[0, 1]])
    big = np.broadcast_to(rgb[:, :1], (1024, 1024, 3))
    np.testing.assert_array_equal(fn(big, pal), np.zeros((1024, 1024)))


@pytest.mark.parametrize("fn", ["colourize", "colourize_numpy",
                                "class_encode", "class_encode_numpy"])
def test_native_rejects_a_bad_palette(fn):
    arg = np.zeros((2, 2, 3), np.uint8) if "encode" in fn else \
        np.zeros((2, 2), np.uint8)
    with pytest.raises(ValueError, match="palette"):
        getattr(tnative, fn)(arg, np.zeros((4, 4), np.uint8))


def test_native_numpy_forms_run_without_gxx(monkeypatch):
    """A host without g++: ``available()`` is False and the public
    functions take the numpy forms."""
    from pylc_tpu_torch.ops.kernels import _build
    monkeypatch.setattr(_build, "gxx", lambda: "")
    tnative._library.cache_clear()
    try:
        assert tnative.available() is False
        pal = _palette("schema_a")
        cm = np.arange(9, dtype=np.uint8).reshape(3, 3)
        np.testing.assert_array_equal(tnative.colourize(cm, pal), pal[cm])
        np.testing.assert_array_equal(tnative.class_encode(pal[cm], pal), cm)
        with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
            tnative.build(force=True)
    finally:
        tnative._library.cache_clear()
    monkeypatch.undo()
    assert tnative.available() is True


# --------------------------------------------------------------------- #
# evaluator
# --------------------------------------------------------------------- #

def _masks(schema, seed, shape=(64, 64)):
    pal = _palette(schema)
    rng = np.random.default_rng(seed)
    true = rng.integers(0, len(pal), shape).astype(np.uint8)
    pred = np.where(rng.random(shape) < 0.7, true,
                    rng.integers(0, len(pal), shape)).astype(np.uint8)
    return pal, pal[true], pal[pred]


@pytest.mark.parametrize("schema", SCHEMAS)
@pytest.mark.parametrize("seeded", [False, True], ids=["plain", "seeded"])
def test_evaluator_metrics_equal(schema, seeded, tmp_path):
    pytest.importorskip("sklearn", reason="the metrics are sklearn's")
    import cv2
    jcfg = jconfig.Config(schema=schema).replace(tile_size=64, id="m")
    tcfg = tconfig.Config(schema=schema).replace(tile_size=64, id="m")
    jev = jevaluate.Evaluator(jcfg, str(tmp_path / "j"))
    tev = tevaluate.Evaluator(tcfg, str(tmp_path / "t"))
    assert not isinstance(tev, jevaluate.Evaluator)
    for seed in (0, 1):
        _, true_rgb, pred_rgb = _masks(schema, seed)
        true_path = str(tmp_path / f"true{seed}.png")
        cv2.imwrite(true_path, cv2.cvtColor(true_rgb, cv2.COLOR_RGB2BGR))
        for ev in (jev, tev):
            ev.load(pred_rgb, f"photo{seed}", true_path)
            ev.evaluate(seed_class_pixels=seeded)
        np.testing.assert_array_equal(tev.y_true, jev.y_true)
        np.testing.assert_array_equal(tev.y_pred, jev.y_pred)
        assert tev.metrics.results == jev.metrics.results
        np.testing.assert_array_equal(tev.metrics.cmatrix,
                                      jev.metrics.cmatrix)
    assert 0.5 < tev.metrics.results["f1"] < 1.0
    for ev in (jev, tev):
        ev.evaluate(aggregate=True)
    assert tev.fid == "aggregate_metrics"
    assert tev.metrics.results == jev.metrics.results
    # artifacts: the same names, the same JSON and the same LaTeX
    tpaths, jpaths = tev.save_metrics(), jev.save_metrics()
    assert [os.path.basename(p) for p in tpaths if p] == \
        [os.path.basename(p) for p in jpaths if p]
    with open(tpaths[0]) as a, open(jpaths[0]) as b:
        assert a.read() == b.read()
    with open(tev.save_tex()) as a, open(jev.save_tex()) as b:
        assert a.read() == b.read()
    tev.reset()
    assert tev.fid is None and tev.y_true is None


def test_evaluator_aggregate_without_data_raises(tmp_path):
    ev = tevaluate.Evaluator(tconfig.Config(), str(tmp_path))
    with pytest.raises(ValueError, match="buffer is empty"):
        ev.evaluate(aggregate=True)


def test_evaluator_rejects_mismatched_ground_truth(tmp_path):
    import cv2
    cfg = tconfig.Config().replace(tile_size=64)
    _, true_rgb, pred_rgb = _masks("schema_a", 0)
    path = str(tmp_path / "true.png")
    cv2.imwrite(path, true_rgb[:32])
    with pytest.raises(ValueError, match="do not match"):
        tevaluate.Evaluator(cfg, str(tmp_path)).load(pred_rgb, "p", path)


def test_report_to_tex_equal():
    report = {"A": {"precision": 0.5, "recall": 0.25, "f1-score": 0.33,
                    "support": 30},
              "B": {"precision": 1.0, "recall": 0.75, "f1-score": 0.86,
                    "support": 70},
              "accuracy": 0.6,
              "macro avg": {"precision": 0.75, "recall": 0.5,
                            "f1-score": 0.6, "support": 100},
              "weighted avg": {"precision": 0.85, "recall": 0.6,
                               "f1-score": 0.7, "support": 100}}
    summary = {"f1": 0.7, "iou": 0.5, "mcc": 0.4}
    got = tevaluate.report_to_tex(report, "t", "m", summary)
    assert got == jevaluate.report_to_tex(report, "t", "m", summary)
    assert "wIoU" in got and "Total Pixels" in got
