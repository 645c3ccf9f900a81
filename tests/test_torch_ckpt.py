"""The ``.ckpt`` bridge: the JAX package's best-model file (flax msgpack
of {params, batch_stats} beside a ``.meta`` JSON) into the port and back,
without flax on the port's side."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pylc_tpu.checkpoint import Checkpoint as JaxCheckpoint
from pylc_tpu.checkpoint import load_model_file
from pylc_tpu.config import Config as JaxConfig
from pylc_tpu.models.registry import build_model as jax_build_model
from pylc_tpu.train_state import init_state
from pylc_tpu_torch import convert
from pylc_tpu_torch.config import Config
from pylc_tpu_torch.tester import load_model
from pylc_tpu_torch.train_state import init_model

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TILE = 64
UNET = dict(arch="unet", unet_depth=3, unet_wf=3, input_size=TILE,
            output_size=24)
CASES = {
    "mobilenet": dict(backbone="mobilenet"),
    "unet_upconv": dict(UNET, up_mode="upconv"),
    "resunet_instance": dict(UNET, arch="resunet", norm_type="instance"),
}


def _cfgs(name):
    kw = dict(CASES[name], tile_size=TILE, compute_dtype="float32")
    return JaxConfig().replace(**kw), Config().replace(**kw)


def _jax_logits(jcfg, state, x):
    return np.asarray(jax_build_model(jcfg, train=False).apply(
        {"params": state.params, "batch_stats": state.batch_stats},
        jnp.asarray(x), train=False))


def _port_logits(model, x):
    with torch.no_grad():
        return model.eval()(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(
            0, 2, 3, 1).numpy()


def _assert_logits_close(got, want):
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=1e-3,
                               atol=max(5e-4, 1e-5 * scale))


@pytest.mark.parametrize("name", sorted(CASES))
def test_jax_ckpt_loads_in_the_port(name, tmp_path):
    """A best model written by the JAX package's ``Checkpoint.save`` loads
    through ``tester.load_model`` with the logits of the JAX model."""
    jcfg, cfg = _cfgs(name)
    state, _ = init_state(jcfg, jax.random.PRNGKey(4))
    ckpt = JaxCheckpoint(jcfg.gen_model_id(), str(tmp_path))
    ckpt.save(state, jcfg, epoch=1, is_best=True)
    assert os.path.exists(ckpt.model_file + ".meta")

    # arch and backbone ride in the meta; the rest comes from the base
    base = Config().replace(**{k: v for k, v in CASES[name].items()
                               if k not in ("arch", "backbone")},
                            compute_dtype="float32")
    got_cfg, model, predict = load_model(ckpt.model_file, base, "cpu")
    assert (got_cfg.arch, got_cfg.backbone, got_cfg.tile_size) == (
        cfg.arch, cfg.backbone, TILE)
    x = np.random.default_rng(0).standard_normal(
        (2, TILE, TILE, 3)).astype(np.float32)
    _assert_logits_close(_port_logits(model, x), _jax_logits(jcfg, state, x))
    img = np.random.default_rng(1).integers(0, 256, (1, TILE, TILE, 3),
                                            dtype=np.uint8)
    assert predict(torch.from_numpy(img)).shape[-1] == cfg.n_classes


@pytest.mark.parametrize("name", sorted(CASES))
def test_port_ckpt_loads_in_jax(name, tmp_path):
    """A model the port wrote with ``save_ckpt_model`` loads through
    ``pylc_tpu.checkpoint.load_model_file`` with the port's logits, and
    comes back into the port bit for bit."""
    jcfg, cfg = _cfgs(name)
    model = init_model(cfg, seed=5)
    with torch.no_grad():  # statistics other than the initial 0 and 1
        for k, v in model.state_dict().items():
            if k.endswith("running_var"):
                v.uniform_(0.5, 1.5, generator=torch.Generator(
                    ).manual_seed(len(k)))
    path = convert.save_ckpt_model(model, cfg, str(tmp_path / "m.ckpt"))
    template, _ = init_state(jcfg, jax.random.PRNGKey(0))
    state, meta = load_model_file(path, template)
    assert meta["arch"] == cfg.arch and meta["tile_size"] == TILE
    got = jax.tree_util.tree_structure(state.params)
    assert got == jax.tree_util.tree_structure(template.params)
    x = np.random.default_rng(2).standard_normal(
        (2, TILE, TILE, 3)).astype(np.float32)
    _assert_logits_close(_jax_logits(jcfg, state, x), _port_logits(model, x))

    _, again = convert.load_ckpt_model(path, cfg)
    for (k, a), b in zip(model.state_dict().items(),
                         again.state_dict().values()):
        assert torch.equal(a, b), k


def test_ckpt_without_meta_takes_the_base_config(tmp_path):
    _, cfg = _cfgs("unet_upconv")
    model = init_model(cfg, seed=0)
    path = convert.save_ckpt_model(model, cfg, str(tmp_path / "m.ckpt"))
    os.remove(path + ".meta")
    got_cfg, again = convert.load_ckpt_model(path, cfg)
    assert got_cfg.arch == "unet"
    assert torch.equal(again.head.weight, model.head.weight)
    with pytest.raises(KeyError, match="no parameters at backbone"):
        convert.load_ckpt_model(path, Config())  # the default DeepLab


@pytest.mark.parametrize("content,match", [
    (b"", "not a msgpack model file"),
    (b"\x81\xa1a\x01", "no 'params' tree"),
    (b"\xc7\x01\x07x", "msgpack extension type 7"),
])
def test_ckpt_that_is_no_model_file_is_refused(content, match, tmp_path):
    path = tmp_path / "m.ckpt"
    path.write_bytes(content)
    with pytest.raises(ValueError, match=match):
        load_model(str(path), Config(), "cpu")


def test_ckpt_bridge_names_missing_msgpack(tmp_path):
    """Without msgpack the two functions raise by name, and the rest of
    the port imports and loads a ``.pth`` all the same."""
    code = (
        "import sys\n"
        "sys.modules['msgpack'] = None\n"
        "import torch\n"
        "from pylc_tpu_torch import convert, tester\n"
        "from pylc_tpu_torch.config import Config\n"
        "for call in (lambda: convert.load_ckpt_model(sys.argv[1]),\n"
        "             lambda: convert.save_ckpt_model(\n"
        "                 torch.nn.Linear(1, 1), Config(), sys.argv[1])):\n"
        "    try:\n"
        "        call()\n"
        "    except ImportError as e:\n"
        "        assert 'msgpack' in str(e), e\n"
        "    else:\n"
        "        raise SystemExit('no ImportError')\n"
        "print('ok')\n")
    path = tmp_path / "m.ckpt"
    path.write_bytes(b"\x80")
    out = subprocess.run([sys.executable, "-c", code, str(path)], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO,
                                  OMP_NUM_THREADS="1"),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
