"""The optimizer state across the ``.ckpt`` bridge: a run the JAX package
started resumes in the port with its moments, step counts and schedule
position, and the port writes a ``checkpoint.ckpt`` that the JAX package
resumes.  The port's trainer writes it, and the best model's ``.ckpt``,
at every save, with no call of ``convert``: the JAX package restores a
port run and reads its best model, and the port resumes its own run from
``checkpoint.pth``.

The tree mapping (``convert.optimizer_from_jax`` / ``optimizer_to_jax``)
is held bit for bit on DeepLab/MobileNetV2, whose two parameter groups
both hold parameters at ``head_lr_mult`` 10.  The steps run on the small
U-Net of tests/test_torch_ddp.py (depth 2, width 2**2, 32 px tiles, no
dropout), in f32 on the CPU, for AdamW and SGD at ``head_lr_mult`` 1 and
10: N_JAX steps of JAX, written by ``pylc_tpu.checkpoint.Checkpoint``,
N_PORT steps of the port from that file against JAX's own continuation,
then the port's file read by ``Checkpoint.load`` and N_BACK steps of JAX
against the port's own.  Two steps per epoch, so both continuations cross
an epoch edge of ``step_lr``.  Tolerances are tests/test_torch_train.py's:
the metrics at METRIC_RTOL, each parameter tensor within NOISE_FACTOR
times PARAM_ATOL plus the distance between the port in f32 and in f64
after the same steps.  JAX's fused loss is off (the Pallas loss in
interpret mode would lengthen every compile; the loss is not what is
resumed).  SGD runs at lr 1e-2, so that a lost momentum moves the
parameters by more than the noise."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from pylc_tpu.checkpoint import Checkpoint as JaxCheckpoint
from pylc_tpu.config import Config as JaxConfig
from pylc_tpu.db.database import TileDB as JaxTileDB
from pylc_tpu.models.registry import build_model as jax_build_model
from pylc_tpu.train_state import init_state
from pylc_tpu.train_state import make_optimizer as jax_make_optimizer
from pylc_tpu.train_state import make_train_step as jax_make_train_step
from pylc_tpu_torch import convert
from pylc_tpu_torch import trainer as ttrainer
from pylc_tpu_torch.checkpoint import Checkpoint
from pylc_tpu_torch.config import Config
from pylc_tpu_torch.models.registry import build_model
from pylc_tpu_torch.train_state import (init_model, make_optimizer,
                                        make_train_step)
from test_torch_train import (METRIC_RTOL, _assert_metrics_close,
                              _assert_within_noise, _flip_of, _np_tree)

torch.set_num_threads(1)

SPE = 2                      # steps per epoch: step_lr decays every 2
N_JAX, N_PORT, N_BACK = 3, 2, 2
UNET = dict(arch="unet", ch=3, tile_size=32, input_size=32, output_size=16,
            unet_depth=2, unet_wf=2, dropout=0.0, batch_size=2,
            compute_dtype="float32", fused_loss="off")
OPTIMS = [("adam", 1.0), ("adam", 10.0), ("sgd", 1.0), ("sgd", 10.0)]


def _optim_kw(optim, mult):
    return dict(optim_type=optim, head_lr_mult=mult,
                **({"lr": 1e-2} if optim == "sgd" else {}))


def _flat(tree, prefix=()):
    """{path: leaf}, an empty dict (an empty state or a masked subtree)
    kept as a leaf of its own."""
    if isinstance(tree, dict):
        if not tree:
            return {prefix: "{}"}
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (str(k),)))
        return out
    return {prefix: np.asarray(tree)}


def _assert_trees_equal(got, want):
    """Same paths, empty nodes, dtypes, shapes and bits."""
    g, w = _flat(got), _flat(want)
    assert g.keys() == w.keys(), sorted(set(g) ^ set(w))[:5]
    for k in w:
        if isinstance(w[k], str) or isinstance(g[k], str):
            assert g[k] == w[k], k
            continue
        assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
        assert np.array_equal(g[k], w[k]), k


def _batch(seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (2, 3, 32, 32)).astype(np.uint8),
            rng.integers(0, 9, (2, 32, 32)).astype(np.uint8))


@pytest.mark.parametrize("optim,mult", OPTIMS)
def test_optimizer_tree_round_trips_bit_for_bit(optim, mult):
    """optax's state of the JAX ``make_optimizer`` (DeepLab/MobileNetV2
    trees), every moment drawn at random and every count at 3 -> the
    port's AdamW or SGD and LambdaLR -> the tree again: every path, ``{}`` node, dtype
    and bit.  On the way each parameter's moments sit in the torch
    layout, AdamW's step and the schedule's position are 3, and each
    group's lr is the schedule's value at 3 times its multiplier."""
    kw = dict(backbone="mobilenet", tile_size=32, **_optim_kw(optim, mult))
    cfg = Config().replace(**kw)
    model = init_model(cfg)
    params, _ = convert.jax_trees_from_state_dict(model.state_dict(), cfg)
    tx = jax_make_optimizer(JaxConfig().replace(**kw), SPE)
    rng = np.random.default_rng(5)

    def fill(a):
        if a.dtype == np.int32:  # the counts
            return np.asarray(3, np.int32)
        return rng.normal(size=a.shape).astype(np.float32)
    tree = jax.tree_util.tree_map(fill, _np_tree(serialization.to_state_dict(
        tx.init(jax.tree_util.tree_map(jnp.asarray, params)))))

    opt, sched = make_optimizer(cfg, model, SPE)
    assert convert.optimizer_from_jax(tree, cfg, model, opt, sched) == 3
    assert sched.last_epoch == 3
    lr3 = cfg.lr * cfg.gamma ** (3 // SPE)
    mults = [1.0] if mult == 1.0 else [1.0, mult]
    np.testing.assert_allclose([g["lr"] for g in opt.param_groups],
                               [lr3 * m for m in mults], rtol=1e-12)
    moment = "exp_avg" if optim == "adam" else "momentum_buffer"
    jmoment = "mu" if optim == "adam" else "trace"
    chain = tree["1"] if mult == 1.0 else \
        tree["1"]["inner_states"]["backbone"]["inner_state"]
    w = opt.state[model.backbone.features[1].conv[0].weight]
    np.testing.assert_array_equal(
        w[moment].numpy(), np.asarray(chain["0"][jmoment]["backbone"][
            "block1"]["dw_conv"]["kernel"]).transpose(3, 2, 0, 1))
    if optim == "adam":
        assert float(w["step"]) == 3.0
    _assert_trees_equal(convert.optimizer_to_jax(cfg, model, opt, sched),
                        tree)


def test_wrong_optimizer_state_is_refused():
    """An SGD state given to an AdamW config, and a split state to an
    unsplit one, raise naming what the config expects."""
    cfg = Config().replace(**{k: v for k, v in UNET.items()})
    model = init_model(cfg)
    opt, sched = make_optimizer(cfg, model, SPE)
    for other in (cfg.replace(optim_type="sgd"),
                  cfg.replace(head_lr_mult=10.0)):
        o2, s2 = make_optimizer(other, model, SPE)
        tree = convert.optimizer_to_jax(other, model, o2, s2)
        with pytest.raises(ValueError, match="optim_type='adam', "
                                             "head_lr_mult=1.0"):
            convert.optimizer_from_jax(tree, cfg, model, opt, sched)


@pytest.fixture(scope="module")
def jax_unet():
    jcfg = JaxConfig().replace(**UNET)
    state, _ = init_state(jcfg, jax.random.PRNGKey(0), SPE)
    return _np_tree(state.params), _np_tree(state.batch_stats), state


def _jax_state(template, params, stats, tx):
    return template.replace(
        step=jnp.zeros((), jnp.int32),
        params=jax.tree_util.tree_map(jnp.asarray, params),
        batch_stats=jax.tree_util.tree_map(jnp.asarray, stats),
        opt_state=tx.init(jax.tree_util.tree_map(jnp.asarray, params)),
        tx=tx)


def _port_from_file(cfg, path, dtype):
    model = build_model(cfg).to(dtype)
    opt, sched = make_optimizer(cfg, model, SPE)
    info = convert.load_ckpt_checkpoint(path, cfg, model, opt, sched)
    wrapped = model if dtype == torch.float32 else _InF64(model)
    return model, opt, sched, make_train_step(cfg, wrapped, opt, sched), \
        info


class _InF64(torch.nn.Module):
    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, x):
        return self.model(x.double())


@pytest.fixture(scope="module", params=OPTIMS,
                ids=[f"{o}-{m:g}" for o, m in OPTIMS])
def resumed(request, jax_unet, tmp_path_factory):
    """JAX N_JAX steps -> checkpoint.ckpt A -> the port (f32 and f64)
    N_PORT steps, beside JAX's own N_PORT; the port's file B -> JAX
    N_BACK steps, beside the port's own N_BACK."""
    optim, mult = request.param
    kw = dict(UNET, **_optim_kw(optim, mult))
    jcfg, cfg = JaxConfig().replace(**kw), Config().replace(**kw)
    params, stats, template = jax_unet
    jstep = jax_make_train_step(jcfg, jax_build_model(jcfg, train=True))
    state = _jax_state(template, params, stats,
                       jax_make_optimizer(jcfg, SPE))
    keys = [jax.random.PRNGKey(20 + i)
            for i in range(N_JAX + N_PORT + N_BACK)]
    batches = [_batch(300 + i) for i in range(len(keys))]

    def jax_steps(state, steps):
        metrics = []
        for i in steps:
            img, mask = batches[i]
            state, m = jstep(state, jnp.asarray(img), jnp.asarray(mask),
                             keys[i])
            metrics.append({k: float(v) for k, v in m.items()})
        return state, metrics

    def port_steps(step, steps):
        return [{k: float(v) for k, v in step(
            torch.from_numpy(batches[i][0]), torch.from_numpy(batches[i][1]),
            flip=_flip_of(keys[i])).items()} for i in steps]

    root = tmp_path_factory.mktemp(f"resume_{optim}_{mult:g}")
    state, _ = jax_steps(state, range(N_JAX))
    ckpt_a = JaxCheckpoint("a", str(root))
    ckpt_a.save(state, jcfg, epoch=1)
    with open(ckpt_a.checkpoint_file, "rb") as f:
        file_a = serialization.msgpack_restore(f.read())
    forward = range(N_JAX, N_JAX + N_PORT)
    jstate, jmetrics = jax_steps(state, forward)

    runs = {}
    for dtype in (torch.float32, torch.float64):
        model, opt, sched, step, info = _port_from_file(
            cfg, ckpt_a.checkpoint_file, dtype)
        if dtype == torch.float32:
            # the file back at once: the JAX package's tree, bit for bit
            at_load = convert.optimizer_to_jax(cfg, model, opt, sched)
        metrics = port_steps(step, forward)
        runs[dtype] = dict(model=model, opt=opt, sched=sched, step=step,
                           info=info, metrics=metrics,
                           forward=_state(model))

    port = runs[torch.float32]
    ckpt_b = Checkpoint("b", str(root))
    convert.save_ckpt_checkpoint(ckpt_b.jax_checkpoint_file, cfg,
                                 port["model"], port["opt"], port["sched"],
                                 epoch=2, iteration=N_JAX + N_PORT)
    back = range(N_JAX + N_PORT, len(keys))
    restored = JaxCheckpoint("b", str(root)).load(_jax_state(
        template, params, stats, jax_make_optimizer(jcfg, SPE)))
    jback, _ = jax_steps(restored["state"], back)
    for run in runs.values():
        port_steps(run["step"], back)
        run["back"] = _state(run["model"])

    def jax_sd(s):
        return convert.state_dict_from_jax(_np_tree(s.params),
                                           _np_tree(s.batch_stats), cfg)

    return dict(file_a=file_a, at_load=at_load, info=port["info"],
                jmetrics=jmetrics, pmetrics=port["metrics"],
                restored=restored, jforward=jax_sd(jstate),
                jback=jax_sd(jback),
                forward={d: r["forward"] for d, r in runs.items()},
                back={d: r["back"] for d, r in runs.items()})


def _state(model):
    return {k: v.clone() for k, v in model.state_dict().items()}


def test_jax_file_round_trips_bit_for_bit(resumed):
    """The JAX package's ``checkpoint.ckpt`` read by the port: its
    optimizer tree back out of the port equals the file's, and iter and
    epoch are the file's."""
    r = resumed
    _assert_trees_equal(r["at_load"], r["file_a"]["opt_state"])
    assert (r["info"]["epoch"], r["info"]["iter"]) == (1, N_JAX)
    assert r["info"]["meta"]["arch"] == "unet"


def test_port_resumes_a_jax_run(resumed):
    """N_PORT port steps from JAX's file against JAX's own N_PORT steps:
    the metrics of each step, every parameter within f32's noise floor,
    the BatchNorm statistics at the same floor."""
    r = resumed
    for got, want in zip(r["pmetrics"], r["jmetrics"]):
        _assert_metrics_close(got, want, rtol=METRIC_RTOL)
    _assert_params_close(r, "forward", "jforward")


def test_jax_resumes_a_port_run(resumed):
    """The port's ``checkpoint.ckpt`` through ``Checkpoint.load`` of the
    JAX package (flax's ``from_bytes`` holds it to the template's
    structure): step, epoch, every moment as the port had it; then N_BACK
    JAX steps against the port's own."""
    r = resumed
    restored = r["restored"]
    assert restored["epoch"] == 2
    assert int(restored["state"].step) == N_JAX + N_PORT
    counts = {k: int(v) for k, v in _flat(_np_tree(serialization.to_state_dict(
        restored["state"].opt_state))).items() if k[-1] == "count"}
    assert counts and set(counts.values()) == {N_JAX + N_PORT}, counts
    _assert_params_close(r, "back", "jback")


def _assert_params_close(r, port, jax_key):
    got, f64 = r[port][torch.float32], _params64(r[port][torch.float64])
    want = r[jax_key]
    keys = [k for k in want if "running" not in k]
    _assert_within_noise(got, f64, want, keys, f"params ({port})")
    for k in want:
        if "running" in k:
            floor = float((got[k].double() - f64[k]).abs().max())
            np.testing.assert_allclose(got[k].double().numpy(),
                                       want[k].double().numpy(), rtol=1e-5,
                                       atol=4 * floor + 1e-7, err_msg=k)


def _params64(sd):
    return {k: v.double() for k, v in sd.items()}


def test_trainer_resumes_a_jax_checkpoint(tmp_path, capsys):
    """``trainer.train(resume_checkpoint=True)`` on a model directory that
    holds only the JAX trainer's ``checkpoint.ckpt`` (one epoch of two
    done): it says so, runs exactly the remaining epoch from iter SPE,
    keeps the JAX run's losses.json rows, and writes its own
    ``checkpoint.pth``, which a second resume prefers."""
    from pylc_tpu.trainer import train as jax_train
    rng = np.random.default_rng(9)
    imgs = rng.integers(0, 256, (6, 3, 32, 32), dtype=np.uint8)
    masks = rng.integers(0, 9, (6, 32, 32), dtype=np.uint8)
    db = str(tmp_path / "tiles.h5")
    JaxTileDB.save(db, imgs, masks,
                   JaxConfig().replace(tile_size=32, id="_db_resume"))
    kw = dict(UNET, shuffle=False, partition=2.5 / 6,
              save_dir=str(tmp_path / "save"))
    jsum = jax_train(JaxConfig().replace(**kw, n_epochs=1), db,
                     n_devices=1, verbose=False)
    assert jsum["steps"] == SPE
    model_dir = tmp_path / "save" / jsum["model_id"]
    assert sorted(os.listdir(model_dir)) == [
        "checkpoint.ckpt", "checkpoint.ckpt.meta", "losses.json",
        f"{jsum['model_id']}.ckpt", f"{jsum['model_id']}.ckpt.meta"]
    cfg = Config().replace(**kw, n_epochs=2, resume_checkpoint=True)
    capsys.readouterr()
    summary = ttrainer.train(cfg, db, None, True, device="cpu")
    printed = capsys.readouterr().out
    assert summary["model_id"] == jsum["model_id"]
    assert f"Resumed from epoch 1 (iter {SPE}) of " \
        f"{model_dir / 'checkpoint.ckpt'}." in printed
    assert summary["epochs"] == 1 and summary["steps"] == 2 * SPE
    losses = json.loads((model_dir / "losses.json").read_text())
    # the JAX run's validations at 0 and SPE, then the resumed run's at
    # its start (both trainers validate the first epoch they run) and end
    assert [row[0] for row in losses["valid"]] == [0, SPE, SPE, 2 * SPE]
    assert (model_dir / "checkpoint.pth").exists()
    capsys.readouterr()
    again = ttrainer.train(cfg.replace(n_epochs=3), db, None, True,
                           device="cpu")
    assert f"of {model_dir / 'checkpoint.pth'}." in capsys.readouterr().out
    assert again["epochs"] == 1 and again["steps"] == 3 * SPE


def test_fresh_run_leaves_the_jax_checkpoint(tmp_path):
    """A run that does not resume removes its own ``checkpoint.pth`` and
    leaves the JAX package's ``checkpoint.ckpt`` and its meta, as the JAX
    package's own reset leaves ``checkpoint.pth``."""
    ckpt = Checkpoint("m", str(tmp_path))
    jax_files = (ckpt.jax_checkpoint_file, ckpt.jax_checkpoint_file + ".meta")
    for path in (ckpt.checkpoint_file, *jax_files):
        open(path, "wb").close()
    ckpt.reset()
    assert sorted(os.listdir(ckpt.model_dir)) == sorted(
        os.path.basename(p) for p in jax_files)
    ckpt.reset()  # nothing of its own left to remove
    os.remove(ckpt.jax_checkpoint_file)
    model = init_model(Config().replace(**UNET))
    opt, sched = make_optimizer(Config(), model, SPE)
    assert ckpt.load(model, opt, sched, Config()) is None


@pytest.mark.parametrize("newer", ["checkpoint.pth", "checkpoint.ckpt"])
def test_resume_takes_the_newer_checkpoint(tmp_path, newer):
    """Where the model directory holds both packages' checkpoints (a port
    run, then the JAX package's run there, or the other way round),
    ``Checkpoint.load`` restores the one written last, whatever the
    iterations they hold."""
    cfg = Config().replace(**UNET)
    ckpt = Checkpoint("m", str(tmp_path))
    model = init_model(cfg, seed=1)
    opt, sched = make_optimizer(cfg, model, SPE)
    ckpt.save(model, opt, sched, cfg, 3, 6)
    convert.save_ckpt_checkpoint(ckpt.jax_checkpoint_file, cfg, model, opt,
                                 sched, 1, 0)
    older = {"checkpoint.pth": ckpt.jax_checkpoint_file,
             "checkpoint.ckpt": ckpt.checkpoint_file}[newer]
    t = os.path.getmtime(ckpt.checkpoint_file)
    os.utime(older, (t - 60, t - 60))
    fresh = init_model(cfg, seed=2)
    opt2, sched2 = make_optimizer(cfg, fresh, SPE)
    restored = ckpt.load(fresh, opt2, sched2, cfg)
    assert restored["file"] == os.path.join(ckpt.model_dir, newer)
    want = {"checkpoint.pth": (3, 6), "checkpoint.ckpt": (1, 0)}[newer]
    assert (restored["epoch"], restored["iter"]) == want


def _port_run_db(seed=9):
    rng = np.random.default_rng(seed)
    return {"img": rng.integers(0, 256, (6, 3, 32, 32), dtype=np.uint8),
            "mask": rng.integers(0, 9, (6, 32, 32), dtype=np.uint8),
            "meta": Config().replace(tile_size=32, id="_db_port").to_meta()}


@pytest.mark.parametrize("optim", ["adam", "sgd"])
def test_jax_package_reads_a_port_training_run(tmp_path, capsys, optim):
    """``trainer.train`` (2 epochs of SPE steps) writes the JAX package's
    files beside its own, with no call of ``convert``: the JAX
    ``Checkpoint.load`` restores the port's epoch, step, every parameter
    and statistic and the whole optimizer tree bit for bit against the
    port's ``checkpoint.pth``; ``load_model_file`` reads the best model,
    and the JAX Segmenter on it agrees with the port's on ``<id>.pth``
    within tests/test_torch_infer.py's tolerance.  Then, with both
    checkpoints' modification times set equal, the port's ``--resume``
    takes its own ``checkpoint.pth``."""
    from pylc_tpu.checkpoint import load_model_file
    from pylc_tpu.infer import Segmenter as JaxSegmenter
    from pylc_tpu.train_state import make_predict as jax_make_predict
    from pylc_tpu_torch.infer import Segmenter
    from pylc_tpu_torch.tester import load_model

    kw = dict(UNET, **_optim_kw(optim, 1.0), shuffle=False,
              partition=2.5 / 6, save_dir=str(tmp_path / "save"))
    cfg = Config().replace(**kw, n_epochs=2)
    summary = ttrainer.train(cfg, _port_run_db(), None, False, device="cpu")
    mid = summary["model_id"]
    model_dir = tmp_path / "save" / mid
    assert sorted(os.listdir(model_dir)) == sorted([
        "checkpoint.ckpt", "checkpoint.ckpt.meta", "checkpoint.pth",
        f"{mid}.ckpt", f"{mid}.ckpt.meta", f"{mid}.pth", "losses.json"])
    assert [set(s) for s in summary["save_s"]] == [{"ckpt", "pth"}] * 3

    # the port's own state, from its own file
    ckpt = Checkpoint(mid, str(tmp_path / "save"))
    model = init_model(cfg, seed=3)
    opt, sched = make_optimizer(cfg, model, SPE)
    own = ckpt.load(model, opt, sched, cfg)
    assert own["file"] == ckpt.checkpoint_file
    assert (own["epoch"], own["iter"]) == (2, 2 * SPE)

    jcfg = JaxConfig().replace(**kw, n_epochs=2)
    template, _ = init_state(jcfg, jax.random.PRNGKey(1), SPE)
    restored = JaxCheckpoint(mid, str(tmp_path / "save")).load(template)
    assert restored["epoch"] == 2
    assert int(restored["state"].step) == 2 * SPE
    state = restored["state"]
    params, stats = convert.jax_trees_from_state_dict(model.state_dict(),
                                                      cfg)
    _assert_trees_equal(_np_tree(state.params), params)
    _assert_trees_equal(_np_tree(state.batch_stats), stats)
    _assert_trees_equal(
        _np_tree(serialization.to_state_dict(state.opt_state)),
        convert.optimizer_to_jax(cfg, model, opt, sched))

    # the best model in both testers
    best, meta = load_model_file(str(model_dir / f"{mid}.ckpt"), template)
    assert meta["arch"] == "unet"
    photo = np.random.default_rng(4).integers(0, 256, (64, 96, 3),
                                              dtype=np.uint8)
    want = JaxSegmenter(jcfg, best, jax_make_predict(
        jcfg, jax_build_model(jcfg)), batch_size=8).segment_array(photo, 16)
    pcfg, _, predict = load_model(str(model_dir / f"{mid}.pth"), cfg,
                                  torch.device("cpu"))
    got = Segmenter(pcfg, predict, torch.device("cpu"),
                    batch_size=8).segment_array(photo, 16)
    np.testing.assert_allclose(got["probs"].numpy(),
                               np.asarray(want["probs"]), atol=1e-4)
    differ = np.mean(got["class_map"] != np.asarray(want["class_map"]))
    assert differ <= 1e-3, f"class maps differ on {differ:.4%} of pixels"

    # equal times: the port resumes from its own file
    t = os.path.getmtime(ckpt.checkpoint_file)
    for path in (ckpt.checkpoint_file, ckpt.jax_checkpoint_file):
        os.utime(path, (t, t))
    capsys.readouterr()
    again = ttrainer.train(cfg.replace(n_epochs=3, resume_checkpoint=True),
                           _port_run_db(), None, True, device="cpu")
    assert f"Resumed from epoch 2 (iter {2 * SPE}) of " \
        f"{ckpt.checkpoint_file}." in capsys.readouterr().out
    assert again["epochs"] == 1 and again["steps"] == 3 * SPE


def test_trainer_without_msgpack_fails_before_its_first_step(tmp_path):
    """Every save writes the JAX package's ``.ckpt`` files, which need
    msgpack: without it ``trainer.train`` raises by name before it opens
    the DB, builds the model or takes a step, and writes nothing."""
    code = (
        "import sys\n"
        "sys.modules['msgpack'] = None\n"
        "import numpy as np\n"
        "from pylc_tpu_torch import trainer\n"
        "from pylc_tpu_torch.config import Config\n"
        "def never(*a, **k):\n"
        "    raise SystemExit('reached ' + never.what)\n"
        "for name in ('TileDB', 'init_model', 'make_train_step'):\n"
        "    setattr(trainer, name, never)\n"
        "never.what = 'the run'\n"
        "cfg = Config().replace(tile_size=32, save_dir=sys.argv[1])\n"
        "db = {'img': np.zeros((6, 3, 32, 32), np.uint8),\n"
        "      'mask': np.zeros((6, 32, 32), np.uint8),\n"
        "      'meta': cfg.to_meta()}\n"
        "try:\n"
        "    trainer.train(cfg, db, verbose=False, device='cpu')\n"
        "except ImportError as e:\n"
        "    assert 'msgpack' in str(e), e\n"
        "else:\n"
        "    raise SystemExit('no ImportError')\n"
        "print('ok')\n")
    save = tmp_path / "save"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code, str(save)], cwd=repo,
                         env=dict(os.environ, PYTHONPATH=repo,
                                  OMP_NUM_THREADS="1"),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr + out.stdout
    assert out.stdout.strip() == "ok"
    assert not save.exists()
