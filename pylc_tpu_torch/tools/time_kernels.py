"""Time the port's hand-written kernels at the main paths' shapes, for
one checkout or for two in turns.

    python -m pylc_tpu_torch.tools.time_kernels
    python -m pylc_tpu_torch.tools.time_kernels --against DIR [--rounds N]

Without ``--against`` it times this checkout's K1 (``crf_iteration`` at
C=9, G=3, 1024x1792, r=3), K2a and K2b (``fused_loss_forward`` and
``fused_loss_backward`` at [8, 9, 512, 512] channels_last, unweighted)
on CUDA device 0, each as the mean of 200 launches from a loop on the host
(where a launch costs the host more than the kernel costs the card, this
is the host's time), and prints one JSON line.  With ``--against DIR`` (another
checkout of this repository, say the parent commit unpacked by ``git
archive``) it times DIR, this, this, DIR, ``--rounds`` times over, each in
a process of its own on the same card, and prints every line and the
medians.  Each process builds its checkout's kernels first (nvcc, a few
seconds).  Only the wrappers' public signatures are used, which the two
checkouts must share.  It needs a card and fails without one.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# Runs in the checkout that is the working directory: nothing of this
# module is imported there, so an older checkout can run it too.
WORKER = r'''
import json, subprocess
import numpy as np, torch
from pylc_tpu_torch.ops.kernels.crf_kernel import crf_iteration
from pylc_tpu_torch.ops.kernels.fused_loss import (fused_loss_backward,
                                                   fused_loss_forward)
from pylc_tpu_torch.ops.losses import LossWeights

def ms(fn, n=200, warmup=5):
    for _ in range(warmup):
        fn()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize(); a.record()
    for _ in range(n):
        fn()
    b.record(); torch.cuda.synchronize()
    return a.elapsed_time(b) / n

dev = torch.device("cuda", 0)
rng = np.random.default_rng(0)
q = rng.random((9, 1024, 1792)).astype(np.float32); q /= q.sum(0, keepdims=True)
g = rng.integers(0, 256, (3, 1024, 1792)).astype(np.float32)
u = np.log(q + 1e-8)
q, g, u = (torch.from_numpy(a).to(dev) for a in (q, g, u))
sig = (3.0, 13.0, 1.5, 3.0, 1.0, 1e-8)
x = torch.from_numpy(rng.normal(size=(8, 9, 512, 512)).astype(np.float32) * 3
                     ).to(dev).contiguous(memory_format=torch.channels_last)
t = torch.from_numpy(rng.integers(0, 9, (8, 512, 512)).astype(np.uint8)).to(dev)
w = LossWeights()
cw = torch.ones(9, device=dev)  # given, so that no launch makes them
acc = fused_loss_forward(x, t, cw, w)
ct = torch.tensor(0.75, device=dev)
out = {"k1_ms": ms(lambda: crf_iteration(q, g, u, 3, *sig)),
       "k2a_ms": ms(lambda: fused_loss_forward(x, t, cw, w)),
       "k2b_ms": ms(lambda: fused_loss_backward(x, t, cw, acc, ct, w)),
       "card": subprocess.run(
           ["nvidia-smi", "--query-gpu=name,power.limit",
            "--format=csv,noheader"], capture_output=True, text=True,
           check=True).stdout.strip().splitlines()[0]}
print(json.dumps(out))
'''


def time_checkout(path: str) -> dict:
    """One process in ``path``; its JSON line as a dict."""
    env = dict(os.environ, PYTHONPATH=path)
    proc = subprocess.run([sys.executable, "-c", WORKER], cwd=path, env=env,
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"timing {path} failed:\n{proc.stderr}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", metavar="DIR",
                    help="another checkout to time in turns with this one")
    ap.add_argument("--rounds", type=int, default=2,
                    help="rounds of DIR, this, this, DIR (default 2)")
    args = ap.parse_args(argv)
    if not args.against:
        print(json.dumps(time_checkout(HERE)))
        return 0
    other = os.path.abspath(args.against)
    runs = {"other": [], "this": []}
    for _ in range(args.rounds):
        for side in ("other", "this", "this", "other"):
            res = time_checkout(other if side == "other" else HERE)
            runs[side].append(res)
            print(json.dumps({"checkout": side, **res}), flush=True)
    keys = ("k1_ms", "k2a_ms", "k2b_ms")
    print(json.dumps({"medians": {
        side: {k: statistics.median(r[k] for r in rs) for k in keys}
        for side, rs in runs.items()}, "other": other,
        "card": runs["this"][0]["card"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
