"""The port's training step against the JAX package's, in f32 on the CPU.

Full-depth DeepLabV3+/ResNet101 at 32 px tiles and batch 2.  The JAX
weights are built once for the module (``init_state``) and reach the
port through ``state_dict_from_jax``; the JAX train step (fused loss on:
the Pallas kernels in interpret mode) is compiled once and reused.
Dropout is off on both sides (``p = 0`` in the port; on the JAX side an
interceptor returns the input of every ``nn.Dropout``), and the port's
flip is forced to the value the JAX key draws.

The weights are JAX's initialization with the scale of the last
BatchNorm of every bottleneck (``bn3``) multiplied by RESIDUAL_GAMMA.  At
the plain initialization (that scale at 1 in all 33 residual branches)
the train-mode network amplifies rounding so much that f32 does not fix
its own result: the port in f32 against itself in f64 (measured on the
CPU) differs by 4e-2 in the logits and 50% in the backbone gradients at
32 px and batch 2, and still by 7% in the backbone gradients at 64 and
128 px, so the small tiles are not the cause.  With the branch scale at
0.03 (near the usual zero-initialized residual branches) the logits
agree to 6e-6 and the gradients to 3e-4 per layer group, 3e-3 in the
worst tensor.

AdamW's first step moves each parameter by lr * g / (|g| + 1e-8), about
lr * sign(g): a gradient entry within rounding of zero moves its
parameter by up to 2 lr either way, in any package, however close the
gradients.  So each parameter tensor is held by its root mean square
against NOISE_FACTOR times PARAM_ATOL (1% of one step at lr 1e-4) plus
the same distance between the port in f32 and the port in f64 after the
same steps, both through ``make_train_step``: the noise floor f32 sets
for that tensor.  The first step's clipped gradient (AdamW's moments,
continuous in the gradient) is held the same way, and the BatchNorm
running statistics after a train-mode forward in f64 on both sides.
The optimizer's arithmetic alone is held against optax on
well-conditioned gradients (``test_optimizer_step_matches_optax``), and
the BatchNorm layer alone at rtol 1e-5 in tests/test_torch_layers.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from pylc_tpu.config import Config
from pylc_tpu.models.registry import build_model as jax_build_model
from pylc_tpu.train_state import init_state
from pylc_tpu.train_state import make_eval_step as jax_make_eval_step
from pylc_tpu.train_state import make_lr_schedule as jax_make_lr_schedule
from pylc_tpu.train_state import make_optimizer as jax_make_optimizer
from pylc_tpu.train_state import make_train_step as jax_make_train_step
from pylc_tpu_torch.convert import state_dict_from_jax
from pylc_tpu_torch.models.registry import build_model
from pylc_tpu_torch.train_state import (
    make_eval_step, make_lr_schedule, make_optimizer, make_train_step)

torch.set_num_threads(1)

TILE, BATCH, SPE = 32, 2, 2     # 2 steps per epoch: step_lr decays at 2
N_STEPS = 3
STEP_KEYS = (3, 0, 11)          # their flips: True, False, True
RESIDUAL_GAMMA = 0.03
N_BOTTLENECKS = 3 + 4 + 23 + 3
METRIC_RTOL = 1e-4
PARAM_ATOL = 1e-6               # RMS per tensor: 1% of one step at lr 1e-4
MOMENT_RTOL = 1e-4              # relative to the tensor's norm
STAT_RTOL = 1e-5
NOISE_FACTOR = 4.0
EVAL_RTOL = 1e-5


def _no_dropout(next_fun, args, kwargs, context):
    if isinstance(context.module, fnn.Dropout) and \
            context.method_name == "__call__":
        return args[0]
    return next_fun(*args, **kwargs)


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


def _jax_tree(tree):
    return jax.tree_util.tree_map(jnp.array, tree)


def _condition(params):
    """The scale of every bottleneck's last BatchNorm times
    RESIDUAL_GAMMA."""
    hits = []

    def scale(path, a):
        if [getattr(k, "key", None) for k in path][-2:] == ["bn3", "scale"]:
            hits.append(path)
            return a * np.float32(RESIDUAL_GAMMA)
        return a
    out = jax.tree_util.tree_map_with_path(scale, params)
    assert len(hits) == N_BOTTLENECKS
    return out


def _port_model(cfg, params, stats):
    model = build_model(cfg)
    model.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    return model


def _batch(seed, n=BATCH):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (n, 3, TILE, TILE)).astype(np.uint8)
    mask = rng.integers(0, 9, (n, TILE, TILE)).astype(np.uint8)
    return img, mask


def _flip_of(key):
    flip_rng, _ = jax.random.split(key)
    return bool(jax.random.bernoulli(flip_rng))


def _assert_metrics_close(got, want, rtol):
    for k in ("ce", "dice", "focal", "total"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=rtol,
                                   err_msg=k)


def _rms(a, b):
    return float((a.double() - b.double()).pow(2).mean().sqrt())


def _jax_moments(opt_state):
    """AdamW's (mu, nu) trees from an optax chain state."""
    found = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: hasattr(x, "mu")) if hasattr(s, "mu")]
    assert len(found) == 1
    return found[0].mu, found[0].nu


class _InF64(torch.nn.Module):
    """A model in f64, fed the f32 batch the train step prepares."""

    def __init__(self, model):
        super().__init__()
        self.model = model.double()

    def forward(self, x):
        return self.model(x.double())


def _port_moments(model, opt):
    return ({n: opt.state[p]["exp_avg"].clone()
             for n, p in model.named_parameters()},
            {n: opt.state[p]["exp_avg_sq"].clone()
             for n, p in model.named_parameters()})


@pytest.fixture(scope="module")
def jax_init():
    cfg = Config().replace(tile_size=TILE, batch_size=BATCH,
                           compute_dtype="float32", fused_loss="on")
    state, _ = init_state(cfg, jax.random.PRNGKey(0), SPE)
    params = _condition(_np_tree(state.params))
    state = state.replace(params=_jax_tree(params))
    return cfg, state, params, _np_tree(state.batch_stats)


@pytest.fixture(scope="module")
def trained(jax_init):
    """N_STEPS steps of JAX, the port in f32 and the port in f64 from the
    same weights; state dicts after each step, moments after the first."""
    cfg, state, params, stats = jax_init
    jstep = jax_make_train_step(cfg, jax_build_model(cfg, train=True))
    model = _port_model(cfg, params, stats)
    opt, sched = make_optimizer(cfg, model, SPE)
    step = make_train_step(cfg, model, opt, sched)
    model64 = _port_model(cfg, params, stats).double()
    opt64, sched64 = make_optimizer(cfg, model64, SPE)
    step64 = make_train_step(cfg, _InF64(model64), opt64, sched64)
    jstate = state.replace(params=_jax_tree(params),
                           batch_stats=_jax_tree(stats),
                           opt_state=_jax_tree(_np_tree(state.opt_state)))
    runs = []
    for i in range(N_STEPS):
        img, mask = _batch(100 + i)
        key = jax.random.PRNGKey(STEP_KEYS[i])
        with fnn.intercept_methods(_no_dropout):
            jstate, jm = jstep(jstate, jnp.asarray(img), jnp.asarray(mask),
                               key)
        m = step(torch.from_numpy(img), torch.from_numpy(mask),
                 flip=_flip_of(key))
        step64(torch.from_numpy(img), torch.from_numpy(mask),
               flip=_flip_of(key))
        runs.append({
            "metrics": ({k: float(v) for k, v in m.items()},
                        {k: float(v) for k, v in jm.items()}),
            "port": {k: v.clone() for k, v in model.state_dict().items()},
            "f64": {k: v.clone() for k, v in model64.state_dict().items()},
            "jax": state_dict_from_jax(_np_tree(jstate.params),
                                       _np_tree(jstate.batch_stats)),
            "flip": _flip_of(key),
        })
        if i == 0:
            jmu, jnu = _jax_moments(_np_tree(jstate.opt_state))
            moments = (_port_moments(model, opt),
                       _port_moments(model64, opt64),
                       tuple(state_dict_from_jax(t, stats)
                             for t in (jmu, jnu)))
    return cfg, runs, moments


def _assert_within_noise(got, f64, want, keys, what):
    """Per tensor: RMS(got - want) <= NOISE_FACTOR * (PARAM_ATOL +
    RMS(got - f64)).  PARAM_ATOL stands in for JAX's own f32 noise, which
    is larger than the port's (flax's one-pass batch variance) and has no
    f64 twin to measure it by: the JAX model casts its logits to f32."""
    for k in keys:
        err, floor = _rms(got[k], want[k]), _rms(got[k], f64[k])
        assert err <= NOISE_FACTOR * (PARAM_ATOL + floor), \
            (what, k, err, floor)


@pytest.mark.parametrize("n_steps", [1, N_STEPS])
def test_adamw_steps_match_jax(trained, n_steps):
    """Metrics of every step at METRIC_RTOL; every parameter tensor and
    every BatchNorm running statistic after n steps within f32's noise
    floor of JAX's."""
    _, runs, _ = trained
    assert {r["flip"] for r in runs} == {False, True}  # both flips ran
    for r in runs[:n_steps]:
        _assert_metrics_close(*r["metrics"], rtol=METRIC_RTOL)
    run = runs[n_steps - 1]
    params = [k for k in run["jax"]
              if not k.endswith(("running_mean", "running_var"))]
    assert len(params) == len(list(build_model(Config()).parameters()))
    _assert_within_noise(run["port"], run["f64"], run["jax"], params,
                         f"params after {n_steps} steps")
    for k in run["jax"]:
        if k.endswith(("running_mean", "running_var")):
            got, want = run["port"][k].double(), run["jax"][k].double()
            floor = float((got - run["f64"][k]).abs().max())
            np.testing.assert_allclose(
                got.numpy(), want.numpy(), rtol=STAT_RTOL,
                atol=NOISE_FACTOR * floor, err_msg=k)


def test_first_step_gradient_matches_jax(trained):
    """The first step's clipped gradient g, read from AdamW's moments
    (0.1 g and 0.001 g^2 in both packages), so it holds the global-norm
    clip as well.  Per tensor within MOMENT_RTOL of JAX's norm plus the
    f32 noise floor."""
    _, _, (port, f64, jax_moments) = trained
    for got, floor_ref, want in zip(port, f64, jax_moments):
        assert set(got) <= set(want)
        for k in got:
            err = float((got[k].double() - want[k].double()).norm())
            floor = float((got[k].double() - floor_ref[k]).norm())
            scale = float(want[k].double().norm())
            assert err <= MOMENT_RTOL * scale + NOISE_FACTOR * floor, \
                (k, err, scale, floor)


@pytest.mark.parametrize("sched_type", ["step_lr", "cyclic_lr", "anneal"])
def test_lr_schedule_matches_jax(sched_type):
    """The schedule at the steps around the epoch edges and the cyclic
    peak, and the lr the optimizer uses at step k is the schedule's
    value at k (optax's count)."""
    cfg = Config().replace(sched_type=sched_type)
    spe = 7
    steps = [0, 1, 6, 7, 8, 13, 14, 15, 1999, 2000, 2001, 3999, 4000, 4001]
    got = make_lr_schedule(cfg, spe)
    want = jax_make_lr_schedule(cfg, spe)
    for k in steps:
        # JAX computes in f32: 1 - x near a cycle's edge keeps few bits
        np.testing.assert_allclose(got(k), float(want(np.int32(k))),
                                   rtol=1e-5,
                                   atol=4 * np.finfo(np.float32).eps
                                   * cfg.lr_max, err_msg=str(k))
    model = torch.nn.Linear(2, 2)
    opt, sched = make_optimizer(cfg, model, spe)
    for k in range(16):
        np.testing.assert_allclose(opt.param_groups[0]["lr"], got(k),
                                   rtol=1e-12)
        opt.step()
        sched.step()


class _TinyNet(torch.nn.Module):
    """A backbone and a head, named as DeepLab's parameter groups are."""

    def __init__(self, p):
        super().__init__()
        self.backbone = torch.nn.Linear(3, 4)
        self.aspp = torch.nn.Linear(4, 2)
        with torch.no_grad():
            for mod, name in ((self.backbone, "backbone"),
                              (self.aspp, "aspp")):
                mod.weight.copy_(torch.from_numpy(p[name]["kernel"].T))
                mod.bias.copy_(torch.from_numpy(p[name]["bias"]))


@pytest.mark.parametrize("optim,head_lr_mult", [("sgd", 1.0),
                                                ("adam", 10.0),
                                                ("adam", 1.0)])
def test_optimizer_step_matches_optax(optim, head_lr_mult):
    """One update (global-norm clip at 0.5, then the optimizer at the
    schedule's lr, per parameter group) from the same gradients as
    JAX ``make_optimizer``; the gradient norm is above the clip."""
    cfg = Config().replace(optim_type=optim, head_lr_mult=head_lr_mult,
                           lr=1e-2)
    rng = np.random.default_rng(9)
    params = {"backbone": {"kernel": rng.normal(size=(3, 4)),
                           "bias": rng.normal(size=4)},
              "aspp": {"kernel": rng.normal(size=(4, 2)),
                       "bias": rng.normal(size=2)}}
    params = jax.tree_util.tree_map(lambda a: a.astype(np.float32), params)
    grads = jax.tree_util.tree_map(
        lambda a: rng.normal(size=a.shape).astype(np.float32), params)
    tx = jax_make_optimizer(cfg, 10)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    opt_state = tx.init(jp)
    import optax
    for _ in range(2):
        upd, opt_state = tx.update(grads, opt_state, jp)
        jp = optax.apply_updates(jp, upd)

    from pylc_tpu_torch.train_state import clip_by_global_norm_
    net = _TinyNet(params)
    opt, sched = make_optimizer(cfg, net, 10)
    for _ in range(2):
        for mod, name in ((net.backbone, "backbone"), (net.aspp, "aspp")):
            mod.weight.grad = torch.from_numpy(grads[name]["kernel"].T.copy())
            mod.bias.grad = torch.from_numpy(grads[name]["bias"].copy())
        norm = clip_by_global_norm_(list(net.parameters()), cfg.grad_clip)
        assert float(norm) > cfg.grad_clip
        opt.step()
        sched.step()
    for mod, name in ((net.backbone, "backbone"), (net.aspp, "aspp")):
        np.testing.assert_allclose(mod.weight.detach().numpy(),
                                   np.asarray(jp[name]["kernel"]).T,
                                   rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(mod.bias.detach().numpy(),
                                   np.asarray(jp[name]["bias"]),
                                   rtol=1e-5, atol=1e-7)


def test_eval_step_matches_jax_on_partial_batch(jax_init):
    """JAX pads a partial batch to the compiled shape and masks it out;
    the port runs the real rows and reports their count."""
    cfg, state, params, stats = jax_init
    img, mask = _batch(200)
    jm = jax_make_eval_step(cfg, jax_build_model(cfg, train=False))(
        state, jnp.asarray(img), jnp.asarray(mask), np.int32(1))
    model = _port_model(cfg, params, stats)
    m = make_eval_step(cfg, model)(torch.from_numpy(img[:1]),
                                   torch.from_numpy(mask[:1]))
    _assert_metrics_close(m, jm, rtol=EVAL_RTOL)
    assert float(m["n_valid"]) == float(jm["n_valid"]) == 1.0


@pytest.mark.parametrize("batch", [2, 1])
def test_batchnorm_running_stats_match_jax(jax_init, batch):
    """One train-mode forward from the same weights moves every
    BatchNorm's running mean and variance as flax does, including the
    ASPP image-pool BN (``aspp.global_avg_pool.2``), whose n is the batch
    size: the biased variance, and at batch 1 the bias as output.  Torch's
    unbiased update would miss there by a factor n/(n-1) of the update.

    Both packages run in f64 (the statistics lie before the logits' cast
    to f32), so the comparison is free of f32's noise: rtol STAT_RTOL,
    and as atol STAT_RTOL of the tensor's largest entry, for running
    means that cross zero (a few f32 constants remain: 1e-9 apart at a
    scale of 0.06 in the decoder)."""
    cfg, _, params, stats = jax_init
    img, _ = _batch(300, batch)
    from pylc_tpu.train_state import _prepare_batch
    x, _ = _prepare_batch(cfg, jnp.asarray(img), None, None)
    jmodel = jax_build_model(cfg, train=True)
    f64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                 (params, stats))
    with jax.enable_x64(True):
        with fnn.intercept_methods(_no_dropout):
            _, upd = jax.jit(lambda p, s, xx: jmodel.apply(
                {"params": p, "batch_stats": s}, xx, train=True,
                mutable=["batch_stats"]))(*_jax_tree(f64), x)
        new_stats = _np_tree(upd["batch_stats"])
    assert jax.tree_util.tree_leaves(new_stats)[0].dtype == np.float64
    want = state_dict_from_jax(f64[0], new_stats)
    model = _port_model(cfg, params, stats).double().train()
    with torch.no_grad():
        out = model(torch.from_numpy(np.array(x)).permute(0, 3, 1, 2)
                    .double())
    assert torch.isfinite(out).all()
    got = model.state_dict()
    keys = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert "aspp.global_avg_pool.2.running_var" in keys
    for k in keys:
        w = want[k].numpy()
        np.testing.assert_allclose(got[k].numpy(), w, rtol=STAT_RTOL,
                                   atol=STAT_RTOL * np.abs(w).max(),
                                   err_msg=k)
    # the repair is what agrees: torch's unbiased update of the image-pool
    # BN (n = batch) lands far from flax's at batch 2
    if batch == 2:
        k = "aspp.global_avg_pool.2.running_var"
        old = torch.from_numpy(f64[1]["aspp"]["gap_bn"]["var"])
        unbiased = 0.9 * old + (got[k] - 0.9 * old) * 2
        assert (got[k] - want[k]).norm() < 1e-6 * (unbiased - want[k]).norm()


def test_remat_backbone_is_not_ported():
    model = torch.nn.Linear(1, 1)
    opt, sched = make_optimizer(Config(), model, 1)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_train_step(Config().replace(remat_backbone=True), model, opt,
                        sched)


def test_fused_loss_off_step_matches_jax(jax_init, monkeypatch):
    """``fused_loss="off"`` takes the plain ``multi_loss`` in both
    packages (the fused loss is not called): one step from the same
    weights and batch, held as ``test_adamw_steps_match_jax`` holds the
    fused steps (metrics at METRIC_RTOL, every parameter within f32's
    noise floor of JAX's)."""
    from pylc_tpu_torch import train_state

    def refuse(*args):
        raise AssertionError("fused_loss='off' ran the fused loss")
    monkeypatch.setattr(train_state, "fused_multi_loss", refuse)
    cfg, state, params, stats = jax_init
    cfg = cfg.replace(fused_loss="off")
    jstep = jax_make_train_step(cfg, jax_build_model(cfg, train=True))
    steps, models = [], []
    for dtype in (torch.float32, torch.float64):
        model = _port_model(cfg, params, stats).to(dtype)
        opt, sched = make_optimizer(cfg, model, SPE)
        wrapped = model if dtype == torch.float32 else _InF64(model)
        steps.append(make_train_step(cfg, wrapped, opt, sched))
        models.append(model)
    # a fresh step counter: the ``trained`` fixture's steps took the
    # initial state's as a donated buffer
    jstate = state.replace(step=jnp.zeros((), jnp.int32),
                           params=_jax_tree(params),
                           batch_stats=_jax_tree(stats),
                           opt_state=_jax_tree(_np_tree(state.opt_state)))
    img, mask = _batch(100)
    key = jax.random.PRNGKey(STEP_KEYS[0])
    with fnn.intercept_methods(_no_dropout):
        jstate, jm = jstep(jstate, jnp.asarray(img), jnp.asarray(mask), key)
    m = steps[0](torch.from_numpy(img), torch.from_numpy(mask),
                 flip=_flip_of(key))
    m64 = steps[1](torch.from_numpy(img), torch.from_numpy(mask),
                   flip=_flip_of(key))
    _assert_metrics_close(m, jm, rtol=METRIC_RTOL)
    want = state_dict_from_jax(_np_tree(jstate.params),
                               _np_tree(jstate.batch_stats))
    keys = [k for k in want
            if not k.endswith(("running_mean", "running_var"))]
    _assert_within_noise(models[0].state_dict(), models[1].state_dict(),
                         want, keys, "params after one 'off' step")


def test_unet_target_crop_passes_the_loss_kernels_check():
    """The U-Net's target is the mask's center window.  Kernels K2a/K2b
    read the target by pixel index, so their operand check refuses a
    strided view; ``prepare_batch`` hands over a contiguous crop."""
    from pylc_tpu_torch.config import Config as PortConfig
    from pylc_tpu_torch.ops.kernels.fused_loss import _check
    from pylc_tpu_torch.train_state import prepare_batch
    cfg = PortConfig().replace(arch="unet")
    assert cfg.crop_window == (94, 418)
    rng = np.random.default_rng(0)
    img = torch.from_numpy(rng.integers(0, 256, (2, 512, 512, 3),
                                        dtype=np.uint8))
    mask = torch.from_numpy(rng.integers(0, 9, (2, 512, 512),
                                         dtype=np.uint8))
    logits = torch.zeros(2, 9, 324, 324).contiguous(
        memory_format=torch.channels_last)
    _, target = prepare_batch(cfg, img, mask, flip=True)
    assert torch.equal(target, mask.flip(2)[:, 94:418, 94:418])
    C, N, HW, *_ = _check(logits, target, None, "K2")
    assert (C, N, HW) == (9, 2 * 324 * 324, 324 * 324)
    with pytest.raises(ValueError, match="contiguous uint8"):
        _check(logits, mask[:, 94:418, 94:418], None, "K2")
    # DeepLab keeps the whole mask
    _, whole = prepare_batch(PortConfig(), img, mask)
    assert whole.shape == (2, 512, 512)
