"""``remat_backbone``: a DeepLab's backbone blocks rematerialized in
training (``torch.utils.checkpoint``, non-reentrant), against the port's
own plain step and against the JAX package's ``nn.remat`` step, in f32 on
the CPU at 32 px tiles and batch 2.

On one thread the recompute replays the same operations on the same
inputs, so a remat step equals a plain step exactly: the losses, every
clipped gradient, every parameter after the update, every running
statistic and ``num_batches_tracked`` (the recompute moves no running
statistic: ``models.layers.recompute_context``).  Against JAX the remat
step is held as tests/test_torch_train.py holds the plain one (every
bottleneck's bn3 scale at 0.03; the first step's gradient from AdamW's
moments within MOMENT_RTOL plus the port's own f32-to-f64 distance), with
JAX's fused loss off: the loss lies outside the backbone, and the
Pallas loss in interpret mode would double the compile."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from pylc_tpu.config import Config as JaxConfig
from pylc_tpu.models.registry import build_model as jax_build_model
from pylc_tpu.train_state import init_state
from pylc_tpu.train_state import make_train_step as jax_make_train_step
from pylc_tpu_torch.config import Config
from pylc_tpu_torch.convert import state_dict_from_jax
from pylc_tpu_torch.models import layers
from pylc_tpu_torch.models.registry import build_model
from pylc_tpu_torch.train_state import (init_model, make_eval_step,
                                        make_optimizer, make_train_step)
from test_torch_ddp import (LOSS_RTOL, PRELUDE, _assert_updates_close,
                            _updates, run_ranks)
from test_torch_train import (BATCH, METRIC_RTOL, MOMENT_RTOL, NOISE_FACTOR,
                              SPE, STAT_RTOL, STEP_KEYS, TILE, _InF64,
                              _assert_metrics_close, _batch, _condition,
                              _flip_of, _jax_moments, _jax_tree,
                              _no_dropout, _np_tree, _port_model,
                              _port_moments)

torch.set_num_threads(1)

# the blocks the JAX package wraps in nn.remat, per backbone
REMAT_BLOCKS = {"resnet": 3 + 4 + 23 + 3,    # Bottleneck
                "xception": 20,              # XBlock
                "mobilenet": 17,             # InvertedResidual
                "drn": 3 + 4 + 6 + 3}        # Bottleneck of layer3..6
RESIDUAL_GAIN = 0.03
RANKS_UPDATE_RTOL = 1e-4


class _Counted:
    """Counts the checkpointed block calls and the recomputes."""

    def __init__(self, monkeypatch, guard=True):
        self.blocks = self.recomputes = 0
        real_checkpoint = layers.checkpoint
        real_context = layers.recompute_context if guard else \
            contextlib.nullcontext

        def checkpoint(*args, **kwargs):
            self.blocks += 1
            return real_checkpoint(*args, **kwargs)

        @contextlib.contextmanager
        def recompute_context():
            self.recomputes += 1
            with real_context():
                yield
        monkeypatch.setattr(layers, "checkpoint", checkpoint)
        monkeypatch.setattr(layers, "recompute_context", recompute_context)


def _cfg(**kw):
    return Config().replace(**{"tile_size": TILE, "batch_size": BATCH,
                               "compute_dtype": "float32", **kw})


def _no_dropout_p(model):
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    return model


def _one_step(cfg, sd, img, mask):
    """One train step of a model built from ``cfg`` with weights ``sd``
    -> (metrics, clipped gradients, state_dict after the step)."""
    model = _no_dropout_p(build_model(cfg))
    model.load_state_dict(sd)
    opt, sched = make_optimizer(cfg, model, SPE)
    m = make_train_step(cfg, model, opt, sched)(
        torch.from_numpy(img), torch.from_numpy(mask), flip=True)
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    return ({k: float(v) for k, v in m.items()}, grads,
            {k: v.clone() for k, v in model.state_dict().items()})


def _assert_steps_equal(got, want):
    (gm, gg, gs), (wm, wg, ws) = got, want
    assert gm == wm
    assert gg.keys() == wg.keys()
    for k in wg:
        torch.testing.assert_close(gg[k], wg[k], rtol=0, atol=0,
                                   msg=f"gradient of {k}")
    assert gs.keys() == ws.keys()
    for k in ws:
        torch.testing.assert_close(gs[k], ws[k], rtol=0, atol=0,
                                   msg=f"{k} after the step")


@pytest.mark.parametrize("backbone,guard", [
    ("resnet", True), ("xception", True), ("mobilenet", True),
    ("drn", True),
    # the recompute's guard taken away: the running statistics move twice
    ("mobilenet", False)])
def test_remat_step_equals_plain_step(backbone, guard, monkeypatch):
    """One AdamW step with ``remat_backbone`` against one without, from
    the same weights and batch: equal losses, gradients, parameters,
    running statistics and ``num_batches_tracked`` (1 in every
    BatchNorm).  Exactly the JAX package's remat blocks are checkpointed,
    and the backward recomputes each once.  With the recompute's guard
    taken away, every BatchNorm of a block counts 2 and the comparison
    fails."""
    img, mask = _batch(100)
    sd = init_model(_cfg(backbone=backbone), seed=0).state_dict()
    count = _Counted(monkeypatch, guard)
    plain = _one_step(_cfg(backbone=backbone), sd, img, mask)
    assert count.blocks == count.recomputes == 0
    remat = _one_step(_cfg(backbone=backbone, remat_backbone=True), sd, img,
                      mask)
    assert count.blocks == count.recomputes == REMAT_BLOCKS[backbone]
    tracked = {k: int(v) for k, v in remat[2].items()
               if k.endswith("num_batches_tracked")}
    assert tracked and {int(plain[2][k]) for k in tracked} == {1}
    if guard:
        assert set(tracked.values()) == {1}
        _assert_steps_equal(remat, plain)
    else:
        assert set(tracked.values()) == {1, 2}
        with pytest.raises(AssertionError):
            _assert_steps_equal(remat, plain)


@pytest.mark.parametrize("arch", ["unet", "resunet"])
def test_unets_ignore_remat_backbone(arch, monkeypatch):
    """The JAX registry passes ``remat`` to the DeepLab alone: a U-Net or
    ResUNet with the flag checkpoints nothing and steps as without it."""
    kw = dict(arch=arch, unet_depth=2, unet_wf=2, input_size=TILE,
              output_size=16)
    img, mask = _batch(101)
    sd = init_model(_cfg(**kw), seed=0).state_dict()
    count = _Counted(monkeypatch)
    _assert_steps_equal(_one_step(_cfg(**kw, remat_backbone=True), sd, img,
                                  mask),
                        _one_step(_cfg(**kw), sd, img, mask))
    assert count.blocks == 0


def test_eval_and_inference_are_untouched(monkeypatch):
    """A remat DeepLab checkpoints only in train mode with gradients on:
    not in the eval step, not under ``no_grad`` in train mode."""
    cfg = _cfg(backbone="mobilenet", remat_backbone=True)
    model = init_model(cfg)
    img, mask = _batch(102)
    count = _Counted(monkeypatch)
    make_eval_step(cfg, model)(torch.from_numpy(img), torch.from_numpy(mask))
    with torch.no_grad():
        model.train()(torch.zeros(1, 3, TILE, TILE))
    assert count.blocks == 0
    assert model.backbone.remat


# --------------------------------------------------------------------- #
# against the JAX package's remat step
# --------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def jax_remat_step():
    """JAX's first step (fused loss off) with and without ``nn.remat``,
    from JAX's initialization and from the conditioned weights, and the
    port's remat step in f32 and in f64 from the conditioned weights."""
    cfg = JaxConfig().replace(tile_size=TILE, batch_size=BATCH,
                              compute_dtype="float32", fused_loss="off",
                              remat_backbone=True)
    state, _ = init_state(cfg, jax.random.PRNGKey(0), SPE)
    init = _np_tree(state.params)
    params = _condition(init)
    stats = _np_tree(state.batch_stats)
    opt0 = _np_tree(state.opt_state)
    img, mask = _batch(100)
    key = jax.random.PRNGKey(STEP_KEYS[0])
    jax_steps = {}
    for remat in (True, False):
        c = cfg.replace(remat_backbone=remat)
        jstep = jax_make_train_step(c, jax_build_model(c, train=True))
        for name, p in (("conditioned", params), ("init", init)):
            # a fresh state each time: the step donates the one it takes
            jstate = state.replace(step=jnp.zeros((), jnp.int32),
                                   params=_jax_tree(p),
                                   batch_stats=_jax_tree(stats),
                                   opt_state=_jax_tree(opt0))
            with fnn.intercept_methods(_no_dropout):
                jstate, jm = jstep(jstate, jnp.asarray(img),
                                   jnp.asarray(mask), key)
            jax_steps[remat, name] = (_np_tree(jstate),
                                      {k: float(v) for k, v in jm.items()})
    jstate, jm = jax_steps[True, "conditioned"]
    runs = []
    for dtype in (torch.float32, torch.float64):
        model = _port_model(cfg, params, stats).to(dtype)
        assert model.backbone.remat
        opt, sched = make_optimizer(cfg, model, SPE)
        step = make_train_step(cfg, model if dtype == torch.float32
                               else _InF64(model), opt, sched)
        m = step(torch.from_numpy(img), torch.from_numpy(mask),
                 flip=_flip_of(key))
        runs.append((m, model, opt))
    return runs, jm, jstate, stats, jax_steps


@pytest.mark.parametrize("weights", ["init", "conditioned"])
def test_jax_remat_step_equals_its_plain_step(jax_remat_step, weights):
    """The reference's property that the port's remat is held to: flax's
    ``nn.remat`` gives the same losses and the same ``batch_stats`` (it
    keeps the first forward's), and the same parameters but where AdamW's
    first step, about lr * sign(g), meets a gradient within rounding of 0
    (at most 2 lr apart).  Printed with ``-s``: the measured distances."""
    steps = jax_remat_step[4]
    (remat, rm), (plain, pm) = steps[True, weights], steps[False, weights]
    for k in pm:
        np.testing.assert_allclose(rm[k], pm[k], rtol=1e-6, err_msg=k)
    stat_diff = max(float(np.abs(a - b).max()) for a, b in zip(
        jax.tree_util.tree_leaves(remat.batch_stats),
        jax.tree_util.tree_leaves(plain.batch_stats)))
    diffs = [np.abs(a - b) for a, b in zip(
        jax.tree_util.tree_leaves(remat.params),
        jax.tree_util.tree_leaves(plain.params))]
    param_diff = max(float(d.max()) for d in diffs)
    moved = sum(int((d > 0).sum()) for d in diffs)
    lr = JaxConfig().lr
    print(f"\nJAX remat against plain, {weights} weights: losses "
          f"{rm['total']!r} / {pm['total']!r}; batch_stats max diff "
          f"{stat_diff:.3e}; params max diff {param_diff:.3e} (2 lr = "
          f"{2 * lr:.1e}) in {moved} of "
          f"{sum(d.size for d in diffs)} entries")
    assert stat_diff <= 1e-6
    assert param_diff <= 2 * lr * (1 + 1e-3)


def test_remat_step_matches_jax_remat_step(jax_remat_step):
    """The losses at METRIC_RTOL; the first step's clipped gradient
    (AdamW's moments, 0.1 g and 0.001 g^2) per tensor within MOMENT_RTOL
    of JAX's norm plus the f32 noise floor; the running statistics after
    the step at STAT_RTOL plus that floor: flax's ``nn.remat`` updates
    ``batch_stats`` once, and so does the port."""
    (m, model, opt), (_, model64, opt64) = jax_remat_step[0]
    jm, jstate, stats = jax_remat_step[1:4]
    _assert_metrics_close(m, jm, rtol=METRIC_RTOL)
    jmu, jnu = _jax_moments(jstate.opt_state)
    for got, ref, want in zip(_port_moments(model, opt),
                              _port_moments(model64, opt64),
                              (state_dict_from_jax(t, stats)
                               for t in (jmu, jnu))):
        assert set(got) <= set(want)  # want also holds the statistics
        assert len(got) == len(list(model.parameters()))
        for k in got:
            err = float((got[k].double() - want[k].double()).norm())
            floor = float((got[k].double() - ref[k]).norm())
            scale = float(want[k].double().norm())
            assert err <= MOMENT_RTOL * scale + NOISE_FACTOR * floor, \
                (k, err, scale, floor)
    want = state_dict_from_jax(jstate.params, jstate.batch_stats)
    got, f64 = model.state_dict(), model64.state_dict()
    keys = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert keys
    for k in keys:
        floor = float((got[k].double() - f64[k]).abs().max())
        np.testing.assert_allclose(got[k].double().numpy(),
                                   want[k].double().numpy(), rtol=STAT_RTOL,
                                   atol=NOISE_FACTOR * floor, err_msg=k)


# --------------------------------------------------------------------- #
# several ranks
# --------------------------------------------------------------------- #

RANK_STEPS = PRELUDE + """
from pylc_tpu_torch.models.registry import build_model
from pylc_tpu_torch.train_state import make_optimizer, make_train_step
rows = slice(2 * r, 2 * r + 2)
out = {}
for remat in (True, False):
    cfg = d["cfg"].replace(remat_backbone=remat)
    model = build_model(cfg)
    model.load_state_dict(d["sd"])
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    opt, sched = make_optimizer(cfg, model, 10)
    m = make_train_step(cfg, model, opt, sched)(
        d["img"][rows], d["mask"][rows], flip=True)
    out[remat] = {"metrics": {k: float(v) for k, v in m.items()},
                  "sd": model.state_dict()}
torch.save(out, f"{work}/out{r}.pt")
"""


def test_remat_on_two_ranks_matches_one_process(tmp_path):
    """DeepLab/ResNet101 with SyncBatchNorm on 2 gloo ranks of 2 images:
    the recompute all-reduces each BatchNorm's moments again inside the
    backward, beside DDP's gradient buckets.  The remat step equals the
    same ranks' plain step exactly, and matches one process's remat step
    on the 4 images (losses at rtol LOSS_RTOL, each update within
    RANKS_UPDATE_RTOL of its norm plus the whole update's, running
    statistics within 1e-5), with every bn3 scale at RESIDUAL_GAIN and
    SGD, as tests/test_torch_ddp.py holds the plain step."""
    cfg = _cfg(batch_size=4, optim_type="sgd", lr=1e-2, remat_backbone=True)
    model = _no_dropout_p(init_model(cfg, seed=0))
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bn3.weight"):
                p.mul_(RESIDUAL_GAIN)
    sd0 = {k: v.clone() for k, v in model.state_dict().items()}
    img, mask = _batch(103, 4)
    timg, tmask = torch.from_numpy(img), torch.from_numpy(mask)
    torch.save({"cfg": cfg.replace(remat_backbone=False), "sd": sd0,
                "img": timg, "mask": tmask}, tmp_path / "in.pt")
    run_ranks(RANK_STEPS, 2, tmp_path)
    out = [torch.load(tmp_path / f"out{r}.pt", weights_only=False)
           for r in range(2)]

    opt, sched = make_optimizer(cfg, model, 10)
    m1 = make_train_step(cfg, model, opt, sched)(timg, tmask, flip=True)
    one = model.state_dict()
    for o in out:
        assert o[True]["metrics"] == o[False]["metrics"]
        for k, v in o[True]["sd"].items():
            torch.testing.assert_close(v, o[False]["sd"][k], rtol=0, atol=0,
                                       msg=k)
        for k in ("ce", "dice", "focal", "total"):
            np.testing.assert_allclose(o[True]["metrics"][k], float(m1[k]),
                                       rtol=LOSS_RTOL, err_msg=k)
    for k, v in out[0][True]["sd"].items():  # the ranks step alike
        torch.testing.assert_close(v, out[1][True]["sd"][k], rtol=0, atol=0)
    got = out[0][True]["sd"]
    _assert_updates_close(_updates(got, sd0), _updates(one, sd0),
                          RANKS_UPDATE_RTOL)
    for k in got:
        if "running" in k:
            np.testing.assert_allclose(got[k], one[k], rtol=1e-5, atol=1e-6,
                                       err_msg=k)
        if k.endswith("num_batches_tracked"):
            assert int(got[k]) == int(one[k]) == 1
