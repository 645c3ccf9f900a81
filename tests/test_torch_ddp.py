"""The port's data-parallel training on several ranks (gloo on the CPU)
against the JAX package's mesh step and against the port's own
one-process results.

Every rank is a process of its own.  The ranks of a test are either
``python -c`` processes given the environment ``torchrun`` gives a rank,
joining through ``parallel.mesh.init_distributed`` (the ``--multihost``
path), or the ranks ``trainer.train(n_devices=2)`` spawns
(``parallel.mesh.spawn``, the ``--n_devices`` path).  Each job has a
timeout that fails the test and ends every rank.

The model is the small U-Net of tests/test_syncbn.py (depth 2, width
2**2, 32 px tiles, 16 px logits, no dropout) with SGD.  Tolerances: the
two ranks sum their statistics and gradients in another order than one
process does, f32 throughout, so losses agree to rtol 1e-5 and each
parameter's update to 1e-4 of its norm (``_assert_updates_close``);
across packages (another conv library) the losses to rtol 1e-4 and the
updates to 2e-3,
the tolerance of tests/test_syncbn.py's one-device-against-mesh check
being 5e-3."""

import json
import os
import socket
import subprocess
import sys
import time
from datetime import timedelta

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from pylc_tpu.config import Config as JaxConfig
from pylc_tpu.parallel.mesh import batch_sharding as jax_batch_sharding
from pylc_tpu.parallel.mesh import get_mesh as jax_get_mesh
from pylc_tpu.train_state import init_state
from pylc_tpu.train_state import make_train_step as jax_make_train_step
from pylc_tpu_torch import cli as tcli
from pylc_tpu_torch import trainer as ttrainer
from pylc_tpu_torch.config import Config
from pylc_tpu_torch.convert import state_dict_from_jax
from pylc_tpu_torch.models.layers import BatchNorm2d
from pylc_tpu_torch.models.registry import build_model
from pylc_tpu_torch.parallel import mesh as pmesh
from pylc_tpu_torch.train_state import (init_model, make_eval_step,
                                        make_optimizer, make_train_step)
from test_torch_trainer import drop_jax_files

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 120          # one multi-rank job, start to end
UNET = dict(arch="unet", ch=3, tile_size=32, input_size=32, output_size=16,
            unet_depth=2, unet_wf=2, dropout=0.0, optim_type="sgd",
            compute_dtype="float32", lr=1e-2)
LOSS_RTOL, UPDATE_RTOL = 1e-5, 1e-4
JAX_LOSS_RTOL, JAX_UPDATE_RTOL = 1e-4, 2e-3


@pytest.fixture(autouse=True)
def _bounded_spawn(monkeypatch):
    """``spawn`` (trainer.train with n_devices > 1) waits TIMEOUT_S."""
    monkeypatch.setattr(pmesh, "JOIN_TIMEOUT_S", TIMEOUT_S)


def run_ranks(code: str, n: int, workdir, env=None):
    """Run ``code`` as n ranks with torchrun's environment; argv[1] is
    ``workdir``.  Fails the test, ending every rank, on a timeout or a
    rank's error.

    As torchrun's agent does, this process hosts the group's store, on a
    port it binds before any rank learns the number, and tells the ranks
    so (``TORCHELASTIC_USE_AGENT_STORE``): no other job can take the port
    between its choice and rank 0's start."""
    store = dist.TCPStore("127.0.0.1", 0, is_master=True,
                          wait_for_workers=False,
                          timeout=timedelta(seconds=TIMEOUT_S))
    procs = []
    for r in range(n):
        e = dict(os.environ, PYTHONPATH=REPO, RANK=str(r),
                 WORLD_SIZE=str(n), LOCAL_RANK=str(r),
                 MASTER_ADDR="127.0.0.1", MASTER_PORT=str(store.port),
                 TORCHELASTIC_USE_AGENT_STORE="True",
                 OMP_NUM_THREADS="1", **(env or {}))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code, str(workdir)], env=e,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    deadline = time.monotonic() + TIMEOUT_S
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(
                timeout=max(1.0, deadline - time.monotonic())))
    except subprocess.TimeoutExpired:
        pytest.fail(f"{n} ranks did not finish within {TIMEOUT_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    del store
    for r, (p, (_, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{err[-3000:]}"
    return [o for o, _ in outs]


PRELUDE = """
import sys
import torch
from pylc_tpu_torch.parallel.mesh import init_distributed, rank
assert init_distributed(device="cpu")
torch.set_num_threads(1)
work = sys.argv[1]
d = torch.load(work + "/in.pt", weights_only=False)
r = rank()
"""


# --------------------------------------------------------------------- #
# BatchNorm statistics
# --------------------------------------------------------------------- #

SYNCBN_RANK = PRELUDE + """
from pylc_tpu_torch.parallel.syncbn import (
    SyncBatchNorm2d, cross_replica_moments, sync_batch_norm_apply)
x = d["x"][2 * r:2 * r + 2].clone().requires_grad_(True)
mean, var, n = cross_replica_moments(x.detach())
bn = SyncBatchNorm2d(x.shape[1], momentum=0.1)
with torch.no_grad():
    bn.weight.copy_(d["w"])
    bn.bias.copy_(d["b"])
y = bn(x)
(y * d["g"][2 * r:2 * r + 2]).sum().backward()
y2 = sync_batch_norm_apply(x.detach(), d["w"], d["b"])
torch.save({"mean": mean, "var": var, "n": n, "y": y.detach(), "y2": y2,
            "dx": x.grad, "dw": bn.weight.grad, "rm": bn.running_mean,
            "rv": bn.running_var}, f"{work}/out{r}.pt")
"""


def test_cross_replica_moments_and_sync_batchnorm(tmp_path):
    """2 ranks of 2 images each against the moments of the 4 images:
    the mean, the biased variance, the count, the normalized output, the
    input's gradient (the all-reduce's backward), the scale's gradient
    summed over the ranks (as DDP sums it), and the running variance
    moved toward the biased variance over the global count of 60 values
    per channel (``nn.SyncBatchNorm`` would take 60/59 of it)."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(2.0, 3.0, (4, 6, 5, 3)).astype(
        np.float32))
    g = torch.from_numpy(rng.normal(0, 1, x.shape).astype(np.float32))
    w = torch.from_numpy(rng.uniform(0.5, 1.5, 6).astype(np.float32))
    b = torch.from_numpy(rng.normal(0, 1, 6).astype(np.float32))
    torch.save({"x": x, "g": g, "w": w, "b": b}, tmp_path / "in.pt")
    run_ranks(SYNCBN_RANK, 2, tmp_path)
    out = [torch.load(tmp_path / f"out{r}.pt") for r in range(2)]

    xd = x.double()
    mean = xd.mean(dim=(0, 2, 3))
    var = xd.var(dim=(0, 2, 3), unbiased=False)
    ref = BatchNorm2d(6, momentum=0.1).double()
    with torch.no_grad():
        ref.weight.copy_(w)
        ref.bias.copy_(b)
    xr = xd.clone().requires_grad_(True)
    yr = ref(xr)
    (yr * g.double()).sum().backward()
    for o in out:
        assert float(o["n"]) == 60.0
        np.testing.assert_allclose(o["mean"], mean, rtol=1e-6)
        np.testing.assert_allclose(o["var"], var, rtol=1e-5)
        np.testing.assert_allclose(o["rm"], 0.1 * mean, rtol=1e-6)
        np.testing.assert_allclose(o["rv"], 0.9 + 0.1 * var, rtol=1e-6)
        np.testing.assert_allclose(o["rv"], ref.running_var, rtol=1e-6)
    np.testing.assert_allclose(out[0]["dw"] + out[1]["dw"],
                               ref.weight.grad, rtol=1e-4)
    for name, want in (("y", yr.detach()), ("y2", yr.detach()),
                       ("dx", xr.grad)):
        got = torch.cat([o[name] for o in out]).double()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5,
                                   err_msg=name)


def test_make_norm_takes_global_statistics_on_several_ranks(tmp_path):
    """``batch`` and ``syncbatch`` both build ``SyncBatchNorm2d`` in a
    world of 2 and ``BatchNorm2d`` in a world of 1, with equal
    state_dict keys."""
    from pylc_tpu_torch.models.layers import make_norm
    code = PRELUDE + """
from pylc_tpu_torch.models.layers import make_norm
print(type(make_norm("batch")(4)).__name__,
      type(make_norm("syncbatch")(4)).__name__)
"""
    torch.save({}, tmp_path / "in.pt")
    outs = run_ranks(code, 2, tmp_path)
    assert [o.split() for o in outs] == [["SyncBatchNorm2d"] * 2] * 2
    one = make_norm("syncbatch")(4)
    assert type(one) is BatchNorm2d
    from pylc_tpu_torch.parallel.syncbn import SyncBatchNorm2d
    assert list(SyncBatchNorm2d(4).state_dict()) == list(one.state_dict())


# --------------------------------------------------------------------- #
# the train step
# --------------------------------------------------------------------- #

STEP_RANK = PRELUDE + """
from pylc_tpu_torch.models.registry import build_model
from pylc_tpu_torch.train_state import make_optimizer, make_train_step
model = build_model(d["cfg"])
model.load_state_dict(d["sd"])
opt, sched = make_optimizer(d["cfg"], model, 10)
step = make_train_step(d["cfg"], model, opt, sched)
rows = slice(4 * r, 4 * r + 4)
m = step(d["img"][rows], d["mask"][rows], flip=d["flip"])
torch.save({"metrics": {k: float(v) for k, v in m.items()},
            "sd": model.state_dict()}, f"{work}/out{r}.pt")
"""


@pytest.fixture(scope="module")
def unet_state():
    jcfg = JaxConfig().replace(batch_size=8, **UNET)
    state, jmodel = init_state(jcfg, jax.random.PRNGKey(0), 10)
    # host copies: the JAX step donates the state it is given
    state = jax.tree_util.tree_map(np.asarray, state)
    rng = np.random.default_rng(4)
    img = rng.integers(0, 255, (8, 32, 32, 3)).astype(np.uint8)
    mask = rng.integers(0, jcfg.n_classes, (8, 32, 32)).astype(np.uint8)
    return jcfg, state, jmodel, img, mask


def _updates(after, before):
    return {k: after[k].double() - before[k].double() for k in before
            if before[k].is_floating_point()}


def _assert_updates_close(got, want, rtol):
    """Each parameter's update within ``rtol`` of its norm plus ``rtol``
    of the whole update's norm: a conv bias before a train-mode BatchNorm
    has an exact gradient of 0, and its update is rounding alone."""
    keys = [k for k in want if "running" not in k]
    total = float(torch.cat([want[k].flatten() for k in keys]).norm())
    for k in keys:
        err = float((got[k] - want[k]).norm())
        scale = float(want[k].norm())
        assert err <= rtol * (scale + total), (k, err, scale, total)


@pytest.mark.parametrize("fused", ["on", "off"])
def test_train_step_on_two_ranks(fused, unet_state, tmp_path):
    """One SGD step on 2 ranks of 4 images against the JAX package's
    step on a 2-device mesh, and against the port's step on the 8 images
    in one process.  ``fused_loss`` "on": K2a's statistics all-reduced
    and the upstream gradient times the world size (a missing or doubled
    factor moves every update 2x); "off": the plain statistics through
    the differentiable all-reduce."""
    jcfg, state, jmodel, img, mask = unet_state
    jcfg = jcfg.replace(fused_loss=fused)
    cfg = Config().replace(batch_size=8, fused_loss=fused, **UNET)
    key = jax.random.PRNGKey(3)
    flip = bool(jax.random.bernoulli(jax.random.split(key)[0]))
    jmesh = jax_get_mesh(2)
    jstate, jm = jax_make_train_step(jcfg, jmodel, mesh=jmesh)(
        jax.tree_util.tree_map(jnp.asarray, state),
        jax.device_put(img, jax_batch_sharding(jmesh, 4)),
        jax.device_put(mask, jax_batch_sharding(jmesh, 3)), key)
    jstate = jax.tree_util.tree_map(np.asarray, jstate)
    sd0 = state_dict_from_jax(state.params, state.batch_stats, cfg)
    want_jax = state_dict_from_jax(jstate.params, jstate.batch_stats, cfg)

    timg = torch.from_numpy(img).permute(0, 3, 1, 2).contiguous()
    tmask = torch.from_numpy(mask)
    torch.save({"cfg": cfg, "sd": sd0, "img": timg, "mask": tmask,
                "flip": flip}, tmp_path / "in.pt")
    run_ranks(STEP_RANK, 2, tmp_path)
    out = [torch.load(tmp_path / f"out{r}.pt", weights_only=False)
           for r in range(2)]

    model = build_model(cfg)
    model.load_state_dict(sd0)
    opt, sched = make_optimizer(cfg, model, 10)
    m1 = make_train_step(cfg, model, opt, sched)(timg, tmask, flip=flip)

    for k in ("ce", "dice", "focal", "total"):
        for o in out:
            assert o["metrics"][k] == out[0]["metrics"][k]
            np.testing.assert_allclose(o["metrics"][k], float(m1[k]),
                                       rtol=LOSS_RTOL, err_msg=k)
        np.testing.assert_allclose(out[0]["metrics"][k], float(jm[k]),
                                   rtol=JAX_LOSS_RTOL, err_msg=k)
    for k, v in out[0]["sd"].items():  # the ranks step alike
        torch.testing.assert_close(v, out[1]["sd"][k], rtol=0, atol=0)
    got = _updates(out[0]["sd"], sd0)
    _assert_updates_close(got, _updates(model.state_dict(), sd0),
                          UPDATE_RTOL)
    _assert_updates_close(got, _updates(want_jax, sd0), JAX_UPDATE_RTOL)
    for k in got:  # the running statistics over the global batch
        if "running" in k:
            np.testing.assert_allclose(out[0]["sd"][k],
                                       model.state_dict()[k], rtol=1e-5,
                                       atol=1e-6, err_msg=k)


# --------------------------------------------------------------------- #
# trainer.train
# --------------------------------------------------------------------- #

def _db(n, seed=0):
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (n, 3, 32, 32), dtype=np.uint8)
    masks = rng.integers(0, 9, (n, 32, 32), dtype=np.uint8)
    cfg = Config().replace(tile_size=32)
    return {"img": imgs, "mask": masks,
            "meta": cfg.replace(id="mem").to_meta()}


def _train_cfg(save_dir, n_tiles, n_valid, **kw):
    return Config().replace(**{
        **UNET, "batch_size": 4, "n_epochs": 2, "shuffle": False,
        "save_dir": str(save_dir), "partition": (n_valid + 0.5) / n_tiles,
        **kw})


TRAIN_RANK = PRELUDE + """
from pylc_tpu_torch.trainer import train
cfg = d["cfg"].replace(save_dir=f"{work}/save{r}")
s = train(cfg, d["db"], None, False, device="cpu")
torch.save({"sd": s["model"].state_dict(), "best_dice": s["best_dice"],
            "steps": s["steps"], "model_id": s["model_id"]},
           f"{work}/out{r}.pt")
"""


def test_trainer_ranks_match_one_process(tmp_path):
    """The conditions of tests/test_multiprocess_train.py: no shuffle, a
    train split of one global batch (4 tiles), and a validation split
    of 3 tiles that fits one global step (shards of 2 and 1).  The ranks
    hold equal parameters, equal to one process's; rank 0 alone writes;
    best_dice agrees."""
    db = _db(7)
    cfg = _train_cfg(tmp_path / "save", 7, 3)
    torch.save({"cfg": cfg, "db": db}, tmp_path / "in.pt")
    run_ranks(TRAIN_RANK, 2, tmp_path)
    out = [torch.load(tmp_path / f"out{r}.pt", weights_only=False)
           for r in range(2)]
    one = ttrainer.train(cfg.replace(save_dir=str(tmp_path / "one")), db,
                         None, False, device="cpu")
    assert out[0]["steps"] == out[1]["steps"] == one["steps"] == 2
    for k, v in out[0]["sd"].items():
        torch.testing.assert_close(v, out[1]["sd"][k], rtol=0, atol=0)
    sd1 = one["model"].state_dict()
    for k, v in out[0]["sd"].items():
        np.testing.assert_allclose(v.double(), sd1[k].double(), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    assert out[0]["best_dice"] == out[1]["best_dice"]
    np.testing.assert_allclose(out[0]["best_dice"], one["best_dice"],
                               rtol=LOSS_RTOL)
    mid = out[0]["model_id"]
    assert sorted(os.listdir(tmp_path / "save0" / mid)) == sorted([
        "checkpoint.ckpt", "checkpoint.ckpt.meta", "checkpoint.pth",
        "losses.json", f"{mid}.ckpt", f"{mid}.ckpt.meta", f"{mid}.pth"])
    assert not os.path.exists(tmp_path / "save1" / mid) or \
        os.listdir(tmp_path / "save1" / mid) == []


def test_spawned_ranks_shard_validation_with_padding_steps(tmp_path):
    """``train(n_devices=2)`` spawns the ranks.  5 validation tiles in
    global steps of 4 rows: rank 0 holds 3 tiles and rank 1 2, so the
    second step is rank 0's third tile beside an all-padding batch on
    rank 1.  Every validation in losses.json equals the one-process eval
    step on the same groups of rows ({0, 1, 3, 4} and {2}) weighted by
    their real counts."""
    db = _db(9, seed=1)
    cfg = _train_cfg(tmp_path, 9, 5, n_epochs=1)
    summary = ttrainer.train(cfg, db, 2, False, device="cpu")
    assert summary["steps"] == 1
    mid = summary["model_id"]
    valid = json.loads((tmp_path / mid / "losses.json").read_text())["valid"]
    assert len(valid) == 2
    rows = slice(4, 9)
    img = torch.from_numpy(db["img"][rows])
    mask = torch.from_numpy(db["mask"][rows])
    groups = ([0, 1, 3, 4], [2])

    def expect(model):
        step = make_eval_step(cfg, model)
        ms = [step(img[g], mask[g]) for g in groups]
        w = np.array([len(g) for g in groups], np.float64)
        return [float(np.dot(w, [float(m[k]) for m in ms]) / w.sum())
                for k in ("ce", "dice", "focal")]

    cfg = summary["config"]  # with the DB's meta
    np.testing.assert_allclose(valid[0][1:], expect(init_model(cfg)),
                               rtol=1e-5)
    np.testing.assert_allclose(valid[1][1:], expect(summary["model"].cpu()),
                               rtol=1e-5)


def test_train_refuses_a_device_count_unlike_the_group():
    with pytest.raises(ValueError, match="process group of 1"):
        ttrainer.train(Config(), _db(4), 0, device="cpu")


# --------------------------------------------------------------------- #
# the rank launcher
# --------------------------------------------------------------------- #

def _meet():
    """A spawned rank: the sum of rank + 1 over the group."""
    t = torch.tensor([dist.get_rank() + 1.0])
    dist.all_reduce(t)
    return dist.get_world_size(), float(t)


def _rank_1_fails():
    """A spawned rank: rank 1 raises right after joining while rank 0
    waits for it at a barrier."""
    if dist.get_rank() == 1:
        raise ValueError("rank-1-own")
    dist.barrier()


def test_spawned_ranks_meet_while_a_chosen_port_is_taken(monkeypatch):
    """``spawn``'s ranks meet through a file of their own, not a port
    chosen ahead of time: with ``free_port`` (a launcher's port picker,
    set here whether the module has one or not) giving a port that another
    process listens on, as another job's group may take a port between
    its choice and rank 0's start, two gloo ranks still meet."""
    with socket.socket() as foreign:
        foreign.bind(("127.0.0.1", 0))
        foreign.listen()
        taken = foreign.getsockname()[1]
        monkeypatch.setattr(pmesh, "free_port", lambda: taken, raising=False)
        assert pmesh.spawn(_meet, 2, timeout_s=TIMEOUT_S) == (2, 3.0)


def test_a_failed_spawn_carries_each_failed_ranks_own_error():
    """Rank 1 fails right after joining and rank 0, waiting at a barrier,
    fails on the closed connection: the exception holds rank 1's own
    error, whichever rank ended first."""
    with pytest.raises(pmesh.RanksFailed) as info:
        pmesh.spawn(_rank_1_fails, 2, timeout_s=TIMEOUT_S)
    assert "rank-1-own" in info.value.errors[1]
    assert "rank-1-own" in str(info.value)
    assert "-- rank 1:" in str(info.value)


# --------------------------------------------------------------------- #
# the CLI
# --------------------------------------------------------------------- #

def test_cli_train_spawns_ranks_on_the_cpu(tmp_path, monkeypatch, capsys):
    """``train --n_devices 2 --device cpu`` from an .h5 DB; a stale
    WORLD_SIZE without --multihost is reported and ignored."""
    from pylc_tpu.db.database import TileDB as JaxTileDB
    db = _db(7)
    path = str(tmp_path / "tiles.h5")
    JaxTileDB.save(path, db["img"], db["mask"],
                   JaxConfig().replace(tile_size=32, id="_db_ranks"))
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("WORLD_SIZE", "1")
    tcli.main(["train", "--db", path, "--batch_size", "4", "--n_epochs",
               "1", "--n_devices", "2", "--device", "cpu"])
    printed = capsys.readouterr().out
    assert "WORLD_SIZE is set but --multihost was not given" in printed
    assert "Training done: 1 steps" in printed
    drop_jax_files(tmp_path)


def test_cli_test_runs_on_a_mesh_on_the_cpu(tmp_path, monkeypatch, capsys):
    import cv2
    cfg = Config().replace(tile_size=64)
    pth = str(tmp_path / "m.pth")
    torch.save({"model": init_model(cfg).state_dict(),
                "meta": cfg.to_meta()}, pth)
    photo = str(tmp_path / "p.jpg")
    cv2.imwrite(photo, np.random.default_rng(2).integers(
        0, 256, (128, 192, 3), dtype=np.uint8))
    monkeypatch.chdir(tmp_path)
    base = ["test", "-l", pth, "-i", photo, "--crf", "--device", "cpu"]
    tcli.main(base + ["--n_devices", "2"])
    printed = capsys.readouterr().out
    assert "Inference mesh: 2 devices" in printed
    assert "forward_stitch banded, crf banded" in printed
    masks = tmp_path / "data" / "outputs"
    written = sorted(str(p) for p in masks.rglob("*.png"))
    assert len(written) == 1
    on_mesh = cv2.imread(written[0])
    tcli.main(base)
    assert "Inference mesh" not in capsys.readouterr().out
    np.testing.assert_array_equal(cv2.imread(written[0]), on_mesh)


def test_cli_multihost_needs_torchruns_environment(monkeypatch):
    for name in pmesh.TORCHRUN_ENV:
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        tcli.main(["train", "--db", "x.h5", "--multihost", "--device",
                   "cpu"])
