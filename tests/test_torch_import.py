"""The PyTorch port imports with jax, flax and optax blocked, and its
sources never import them."""

import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "pylc_tpu_torch")

MODULES = [
    "pylc_tpu_torch", "pylc_tpu_torch.__main__", "pylc_tpu_torch.cli",
    "pylc_tpu_torch.config", "pylc_tpu_torch.convert",
    "pylc_tpu_torch.device",
    "pylc_tpu_torch.evaluate", "pylc_tpu_torch.infer",
    "pylc_tpu_torch.tester", "pylc_tpu_torch.train_state",
    "pylc_tpu_torch.models.layers", "pylc_tpu_torch.models.resnet",
    "pylc_tpu_torch.models.aspp", "pylc_tpu_torch.models.deeplab",
    "pylc_tpu_torch.models.registry", "pylc_tpu_torch.ops.normalize",
    "pylc_tpu_torch.ops.tiles", "pylc_tpu_torch.ops.crf",
    "pylc_tpu_torch.ops.kernels.crf_kernel",
    "pylc_tpu_torch.utils.imageio",
]


def test_port_imports_without_jax():
    code = (
        "import importlib, sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'optax'):\n"
        "    sys.modules[m] = None\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m, v in sys.modules.items() if v is not None\n"
        "             and m.split('.')[0] in ('jax', 'jaxlib', 'flax',\n"
        "                                     'optax', 'cv2', 'triton'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_port_sources_never_import_jax():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|optax)\b", re.M)
    found = []
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(root, f)
                with open(path) as fh:
                    if pat.search(fh.read()):
                        found.append(os.path.relpath(path, REPO))
    assert not found, found
