"""Time the port's hand-written kernels at the main paths' shapes, for
one checkout or for two in turns.

    python -m pylc_tpu_torch.tools.time_kernels
    python -m pylc_tpu_torch.tools.time_kernels --against DIR [--rounds N]

Without ``--against`` it times this checkout's K1 (``crf_iteration`` at
C=9, G=3, 1024x1792, r=3), K2a and K2b (``fused_loss_forward`` and
``fused_loss_backward`` at [8, 9, 512, 512] channels_last, unweighted)
on CUDA device 0, each as the mean of 200 launches from a loop on the host
(``*_ms``: where a launch costs the host more than the kernel costs the
card, this is the host's time) and as the mean of 50 launches replayed
from a CUDA graph (``*_g_ms``: the card's time); then, from graphs only,
the wide kernels of a schema past 16 classes: K1 at C=20 on the same grid
and at C=128 on 512x512, K2a and K2b at [8, 20, 512, 512] and
[8, 128, 512, 512], channels_last; and K1 at narrow sizes on the same grid
(``k1_c<C>g<G>r<r>``: C=9, G=3 at r = 2, 4, 5; C=11, G=1 at r=5; C=16
and C=6, G=3 at r=3); and from a host loop and graphs both, K1 at
r = 6 to 8 (``k1_c<C>g<G>r<r>``: C=9, G=3 at r = 6, 7, 8; C=11, G=1 and
C=20, G=3 at r=8; C=20, G=3 at r=6) on the same grid and at C=128, G=3,
r=8 on 512x512 (``k1_wide128r8``).  It prints one JSON line.  With
``--against DIR`` (another checkout of this repository, say the parent
commit unpacked by ``git archive``) it times DIR, this, this, DIR,
``--rounds`` times over, each in
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

def g_ms(fn, n=50):
    fn(); torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize(); a.record()
    graph.replay()
    b.record(); torch.cuda.synchronize()
    return a.elapsed_time(b) / n

dev = torch.device("cuda", 0)
rng = np.random.default_rng(0)
sig = (3.0, 13.0, 1.5, 3.0, 1.0, 1e-8)
w = LossWeights()
ct = torch.tensor(0.75, device=dev)
out = {}

def k1(key, C, H, W, loop, G=3, r=3):
    q = rng.random((C, H, W)).astype(np.float32); q /= q.sum(0, keepdims=True)
    g = rng.integers(0, 256, (G, H, W)).astype(np.float32)
    u = np.log(q + 1e-8)
    q, g, u = (torch.from_numpy(a).to(dev) for a in (q, g, u))
    fn = lambda: crf_iteration(q, g, u, r, *sig)
    if loop:
        out[key + "_ms"] = ms(fn)
    out[key + "_g_ms"] = g_ms(fn)

def k2(key, C, loop):
    x = torch.from_numpy(rng.normal(size=(8, C, 512, 512)).astype(np.float32)
                         * 3).to(dev).contiguous(memory_format=torch.channels_last)
    t = torch.from_numpy(rng.integers(0, C, (8, 512, 512)).astype(np.uint8)
                         ).to(dev)
    cw = torch.ones(C, device=dev)  # given, so that no launch makes them
    acc = fused_loss_forward(x, t, cw, w)
    fns = {"k2b" + key: lambda: fused_loss_backward(x, t, cw, acc, ct, w),
           "k2a" + key: lambda: fused_loss_forward(x, t, cw, w)}
    for name, fn in sorted(fns.items()):
        if loop:
            out[name + "_ms"] = ms(fn)
        out[name + "_g_ms"] = g_ms(fn)

k1("k1", 9, 1024, 1792, True)
k2("", 9, True)
k1("k1_wide20", 20, 1024, 1792, False)
k1("k1_wide128", 128, 512, 512, False)
for C, G, r in ((9, 3, 2), (9, 3, 4), (9, 3, 5), (11, 1, 5), (16, 3, 3),
                (6, 3, 3)):
    k1(f"k1_c{C}g{G}r{r}", C, 1024, 1792, False, G, r)
for C, G, r in ((9, 3, 6), (9, 3, 7), (9, 3, 8), (11, 1, 8), (20, 3, 6),
                (20, 3, 8)):
    k1(f"k1_c{C}g{G}r{r}", C, 1024, 1792, True, G, r)
k1("k1_wide128r8", 128, 512, 512, True, 3, 8)
k2("_wide20", 20, False)
k2("_wide128", 128, False)
out = {"card": subprocess.run(
           ["nvidia-smi", "--query-gpu=name,power.limit",
            "--format=csv,noheader"], capture_output=True, text=True,
           check=True).stdout.strip().splitlines()[0], **out}
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
    keys = [k for k in runs["this"][0] if k.endswith("_ms")]
    print(json.dumps({"medians": {
        side: {k: statistics.median(r[k] for r in rs) for k in keys}
        for side, rs in runs.items()}, "other": other,
        "card": runs["this"][0]["card"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
