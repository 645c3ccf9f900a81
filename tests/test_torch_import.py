"""The PyTorch port imports with the JAX package (``pylc_tpu``), jax,
flax, optax and h5py blocked (the card's machine has no flax or h5py),
extracts, augments and trains from an in-memory DB there, and its
sources import neither jax nor anything of ``pylc_tpu``."""

import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "pylc_tpu_torch")

MODULES = [
    "pylc_tpu_torch", "pylc_tpu_torch.models", "pylc_tpu_torch.ops",
    "pylc_tpu_torch.ops.kernels", "pylc_tpu_torch.utils",
    "pylc_tpu_torch.__main__", "pylc_tpu_torch.cli",
    "pylc_tpu_torch.config", "pylc_tpu_torch.convert",
    "pylc_tpu_torch.device",
    "pylc_tpu_torch.evaluate", "pylc_tpu_torch.infer",
    "pylc_tpu_torch.native",
    "pylc_tpu_torch.tester", "pylc_tpu_torch.train_state",
    "pylc_tpu_torch.models.layers", "pylc_tpu_torch.models.resnet",
    "pylc_tpu_torch.models.aspp", "pylc_tpu_torch.models.deeplab",
    "pylc_tpu_torch.models.registry", "pylc_tpu_torch.models.xception",
    "pylc_tpu_torch.models.mobilenet", "pylc_tpu_torch.models.drn",
    "pylc_tpu_torch.models.unet", "pylc_tpu_torch.models.res_unet",
    "pylc_tpu_torch.ops.normalize",
    "pylc_tpu_torch.ops.tiles", "pylc_tpu_torch.ops.crf",
    "pylc_tpu_torch.ops.kernels.crf_kernel",
    "pylc_tpu_torch.utils.imageio",
    "pylc_tpu_torch.ops.losses", "pylc_tpu_torch.ops.kernels._build",
    "pylc_tpu_torch.ops.kernels.fused_loss", "pylc_tpu_torch.db",
    "pylc_tpu_torch.db.database", "pylc_tpu_torch.db.dataset",
    "pylc_tpu_torch.checkpoint", "pylc_tpu_torch.trainer",
    "pylc_tpu_torch.tools", "pylc_tpu_torch.tools.time_kernels",
    "pylc_tpu_torch.tools.k1_variants", "pylc_tpu_torch.tools.k2_variants",
    "pylc_tpu_torch.utils.balance", "pylc_tpu_torch.utils.synthetic",
    "pylc_tpu_torch.ops.palette", "pylc_tpu_torch.ops.profile",
    "pylc_tpu_torch.ops.augment_ops", "pylc_tpu_torch.extract",
    "pylc_tpu_torch.augment", "pylc_tpu_torch.utils.tracing",
    "pylc_tpu_torch.utils.analyze", "pylc_tpu_torch.export",
    "pylc_tpu_torch.server", "pylc_tpu_torch.gui",
    "pylc_tpu_torch.parallel", "pylc_tpu_torch.parallel.mesh",
    "pylc_tpu_torch.parallel.sharded_stitch",
    "pylc_tpu_torch.parallel.banded_infer",
    "pylc_tpu_torch.parallel.sharded_crf", "pylc_tpu_torch.parallel.syncbn",
    "pylc_tpu_torch.quant", "pylc_tpu_torch.ops.kernels.int8_conv",
]
BLOCKED = ("pylc_tpu", "jax", "jaxlib", "flax", "optax", "h5py")


def test_module_list_names_every_module_of_the_port():
    found = set()
    for root, dirs, files in os.walk(PKG):
        dirs[:] = [d for d in dirs if d not in ("_build", "__pycache__")]
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(root, f), REPO)[:-3]
                found.add(rel.replace(os.sep, ".").removesuffix(".__init__"))
    assert found - set(MODULES) == set()


def test_port_imports_without_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {BLOCKED!r}:\n"
        "    sys.modules[m] = None\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m, v in sys.modules.items() if v is not None\n"
        f"             and m.split('.')[0] in {BLOCKED + ('cv2', 'triton')!r})\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_port_sources_never_import_jax():
    # pylc_tpu, and not pylc_tpu_torch: the name ends at a dot, a space or
    # the end of the line
    pat = re.compile(r"^\s*(import|from)\s+((jax|jaxlib|flax|optax)\b"
                     r"|pylc_tpu(\.|\s|$))", re.M)
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PKG):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    assert len(paths) > 20
    found = []
    for path in paths:
        with open(path) as fh:
            if pat.search(fh.read()):
                found.append(os.path.relpath(path, REPO))
    assert not found, found
    assert pat.search("  from pylc_tpu.config import Config\n")
    assert pat.search("import pylc_tpu\n")
    assert not pat.search("from pylc_tpu_torch.config import Config\n")


def test_in_memory_train_runs_without_jax_flax_h5py(tmp_path):
    """The card's machine's situation: an in-memory DB trains for one
    epoch (32 px, 10 tiles, batch 2, on the CPU) and writes its best
    model, with jax, flax and h5py all absent."""
    code = (
        "import json, os, sys\n"
        f"for m in {BLOCKED!r}:\n"
        "    sys.modules[m] = None\n"
        "import numpy as np, torch\n"
        "torch.set_num_threads(1)\n"
        "from pylc_tpu_torch.config import Config\n"
        "from pylc_tpu_torch.trainer import train\n"
        "cfg = Config().replace(tile_size=32, batch_size=2, n_epochs=1,\n"
        "                       compute_dtype='float32',\n"
        f"                       save_dir={str(tmp_path)!r})\n"
        "rng = np.random.default_rng(0)\n"
        "db = {'img': rng.integers(0, 256, (10, 3, 32, 32), dtype=np.uint8),\n"
        "      'mask': rng.integers(0, 9, (10, 32, 32), dtype=np.uint8),\n"
        "      'meta': cfg.replace(id='mem').to_meta()}\n"
        "s = train(cfg, db, verbose=False, device='cpu')\n"
        "d = os.path.join(cfg.save_dir, s['model_id'])\n"
        "assert os.path.exists(os.path.join(d, s['model_id'] + '.pth'))\n"
        "assert json.load(open(os.path.join(d, 'losses.json')))['valid']\n"
        f"assert not [m for m in {BLOCKED!r} if sys.modules.get(m)]\n"
        "print('ok', s['steps'])\n")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "ok 4"
    from test_torch_trainer import drop_jax_files
    drop_jax_files(tmp_path)


def test_in_memory_data_path_runs_without_jax_flax_h5py(tmp_path):
    """The card's machine's situation for the data path: two seeded
    photos and masks on disk through ``Extractor`` into an in-memory DB,
    ``Augmentor`` on it, and one epoch of ``trainer.train`` on the
    result (a small U-Net on 64 px tiles, on the CPU), with jax, flax and
    h5py absent."""
    code = (
        "import sys\n"
        f"for m in {BLOCKED!r}:\n"
        "    sys.modules[m] = None\n"
        "import os, cv2, numpy as np, torch\n"
        "torch.set_num_threads(1)\n"
        "from pylc_tpu_torch.augment import Augmentor\n"
        "from pylc_tpu_torch.config import Config\n"
        "from pylc_tpu_torch.extract import Extractor\n"
        "from pylc_tpu_torch.trainer import train\n"
        "from pylc_tpu_torch.utils.synthetic import textured_scene\n"
        "cfg = Config().replace(tile_size=64, stride=64, batch_size=2,\n"
        "                       n_epochs=1, compute_dtype='float32',\n"
        "                       save_dir='save', arch='unet', unet_depth=3,\n"
        "                       unet_wf=3, input_size=64, output_size=24)\n"
        "pal = np.asarray(cfg.palette_rgb, np.uint8)\n"
        "rng = np.random.default_rng(0)\n"
        "for d in ('img', 'mask'):\n"
        "    os.makedirs(d)\n"
        "for i in range(2):\n"
        "    true, photo, _ = textured_scene(128, 192, 9, rng)\n"
        "    cv2.imwrite(f'img/p{i}.jpg', photo[..., ::-1])\n"
        "    cv2.imwrite(f'mask/p{i}.png', pal[true][..., ::-1])\n"
        "ex = Extractor(cfg, 'cpu').load('img', 'mask')\n"
        "db = ex.extract(verbose=False).coshuffle().profile().get_data()\n"
        "aug = Augmentor(cfg, 'cpu').load(db).optimize().oversample()\n"
        "data = aug.get_data().data\n"
        "assert len(data['img']) == 12 + aug.rates.sum() > 12\n"
        "s = train(cfg, data, None, False, device='cpu')\n"
        f"assert not [m for m in {BLOCKED!r} if sys.modules.get(m)]\n"
        "print('ok', s['steps'] > 0)\n")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "ok True"
