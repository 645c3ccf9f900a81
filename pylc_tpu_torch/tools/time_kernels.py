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
r=8 on 512x512 (``k1_wide128r8``); and from a host loop and graphs both,
K2a and K2b at [8, C, 512, 512] channels_last for users' schemas of
C = 6, 8, 12 and 16 classes (``k2a_c<C>``, ``k2b_c<C>``).  It prints one
JSON line.  With
``--against DIR`` (another checkout of this repository, say the parent
commit unpacked by ``git archive``) it times DIR, this, this, DIR,
``--rounds`` times over, each in
a process of its own on the same card, and prints every line and the
medians.  Each process builds its checkout's kernels first (nvcc, a few
seconds).  Only the wrappers' public signatures are used, which the two
checkouts must share.  It needs a card and fails without one.

    python -m pylc_tpu_torch.tools.time_kernels --int8

times this checkout's int8 kernels at the flagship's shapes instead:
DeepLabV3+/ResNet101 (OS16, schema_a, 512 px tiles, bf16 autocast) with
seeded weights, calibrated on 32 seeded tiles, each distinct calibrated
conv of one batch of 16 tiles (``int8_rows``) and a MobileNetV2
depthwise conv (``DEPTHWISE``): KQ and Q from a CUDA graph of 50
launches and from a host loop of 50, each beside its bound, the plain
version (once), ``torch._int_mm`` on an im2col (``library_ms``; none
for a grouped conv) and cuDNN's bf16 convolution of the same layer.  It
prints one JSON line per shape and one with the sums per batch of 16.
``--int8-bounds`` prints the same shapes' bounds alone, from a pass on
fake tensors, and needs no card.
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
for C in (6, 8, 12, 16):
    k2(f"_c{C}", C, True)
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


# The card's peaks (NVIDIA's data sheet, H100 SXM, dense): the int8 tensor
# cores, fp32 outside the tensor cores, device memory.
PEAK_INT8_OPS_PER_S = 1979e12
PEAK_FP32_FLOP_PER_S = 67e12
PEAK_BYTES_PER_S = 3.35e12
# a depthwise conv of DeepLab/MobileNetV2 at 512 px tiles (features.4's
# 3x3 over 144 channels at 128x128), batch 16: (B, C, H, W, stride)
DEPTHWISE = (16, 144, 128, 128, 1)


def cuda_ms(fn, n: int, warmup: int = 2) -> float:
    """Mean device milliseconds of ``fn`` over ``n`` back-to-back calls
    from a loop on the host."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def graph_ms(fn, n: int) -> float:
    """Mean device milliseconds of ``fn`` over ``n`` calls replayed from
    one CUDA graph: what the launches take on the card with no host time
    between them.  A loop on the host measures the host instead wherever
    a launch costs it more than the kernel costs the card, which for the
    loss kernels (tens of microseconds) depends on the machine."""
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def capture_conv_inputs(model, run):
    """``run()`` once with a pre-hook on every ``quant.Int8Conv2d`` of
    ``model``; returns one entry per distinct conv geometry, in the order
    of first use: {"conv": the first module, "x": a copy of its input,
    "out_dtype", "count": how many convs of the run have it}."""
    import torch
    from pylc_tpu_torch.quant import Int8Conv2d
    found = {}

    def hook(conv, args):
        x = args[0]
        dev = x.device.type
        out_dtype = torch.get_autocast_dtype(dev) \
            if torch.is_autocast_enabled(dev) else x.dtype
        key = (tuple(x.shape), x.dtype, conv.weight_shape, conv.stride,
               conv.padding, conv.dilation, conv.groups, out_dtype)
        if key in found:
            found[key]["count"] += 1
        else:
            found[key] = {"conv": conv, "x": x.detach().clone(
                memory_format=torch.channels_last), "out_dtype": out_dtype,
                "count": 1}

    handles = [m.register_forward_pre_hook(hook) for m in model.modules()
               if isinstance(m, Int8Conv2d)]
    try:
        run()
    finally:
        for h in handles:
            h.remove()
    return list(found.values())


def _im2col_int8(qx, conv):
    """(A, B) for ``torch._int_mm``: the int8 im2col of ``qx`` [M, K] and
    the weights [K, O], K (and O) padded with zeros to multiples of 8 and M
    to more than 16 rows, as its cuBLAS path asks."""
    import torch
    import torch.nn.functional as F
    O, kh, kw, C = conv.weight_shape
    B = qx.shape[0]
    cols = F.unfold(qx.permute(0, 3, 1, 2).float(), (kh, kw), conv.dilation,
                    conv.padding, conv.stride)              # [B, C*kh*kw, L]
    M, K = B * cols.shape[2], cols.shape[1]
    m, k, o = max(17, -(-M // 8) * 8), -(-K // 8) * 8, -(-O // 8) * 8
    a = torch.zeros((m, k), dtype=torch.int8, device=qx.device)
    a[:M, :K] = cols.permute(0, 2, 1).reshape(M, K).to(torch.int8)
    w = torch.zeros((o, k), dtype=torch.int8, device=qx.device)
    w[:O, :K] = conv.qweight.view(O, kh, kw, C).permute(0, 3, 1, 2).reshape(
        O, K)
    return a, w.t()


def int8_bound(x_shape, x_itemsize: int, weight_shape, out_hw,
               out_itemsize: int, has_bias: bool) -> dict:
    """The least time the card could take for KQ and Q on one conv:
    KQ's 2 x multiply-adds at the int8 tensor cores' peak against its
    bytes (the int8 input and weights, the scales and bias, the output,
    each once), Q's bytes (its input read, the int8 written) against 2
    operations an element at the fp32 peak."""
    B, C, H, W = x_shape
    O, kh, kw, Cg = weight_shape
    Ho, Wo = out_hw
    macs = B * Ho * Wo * O * kh * kw * Cg
    kq_bytes = B * H * W * C + O * kh * kw * Cg + 4 * O * (1 + has_bias) \
        + B * Ho * Wo * O * out_itemsize
    ops_ms = 2 * macs / PEAK_INT8_OPS_PER_S * 1e3
    bytes_ms = kq_bytes / PEAK_BYTES_PER_S * 1e3
    n = B * C * H * W
    return {"macs": macs, "kq_ops_ms": ops_ms, "kq_bytes_ms": bytes_ms,
            "kq_bound_ms": max(ops_ms, bytes_ms),
            "kq_bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "q_bound_ms": max(n * (x_itemsize + 1) / PEAK_BYTES_PER_S,
                              2 * n / PEAK_FP32_FLOP_PER_S) * 1e3}


def conv_geometry(model, x_shape):
    """Every ``nn.Conv2d`` of ``model``'s forward on a channels_last
    input of ``x_shape``, under bf16 autocast as the predict runs it,
    from a pass on fake tensors (shapes and dtypes only: no memory, no
    arithmetic; the dtypes are CPU autocast's).  One entry per distinct
    geometry, in the order of first use, with ``count``."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    found = {}

    def hook(conv, args):
        x = args[0]
        key = (tuple(x.shape), x.dtype, tuple(conv.weight.shape),
               tuple(conv.stride), tuple(conv.padding),
               tuple(conv.dilation), conv.groups, conv.bias is not None)
        found[key] = found.get(key, 0) + 1

    handles = [m.register_forward_pre_hook(hook) for m in model.modules()
               if isinstance(m, torch.nn.Conv2d)]
    try:
        with FakeTensorMode(allow_non_fake_inputs=True) as mode, \
                torch.no_grad(), torch.autocast("cpu", dtype=torch.bfloat16):
            model(mode.from_tensor(torch.empty(x_shape).contiguous(
                memory_format=torch.channels_last)))
    finally:
        for h in handles:
            h.remove()
    return [{"x": list(x), "x_dtype": str(dt).split(".")[-1],
             "w": [w[0], w[2], w[3], w[1]], "stride": list(s),
             "padding": list(p), "dilation": list(d), "groups": g,
             "bias": b, "count": n}
            for (x, dt, w, s, p, d, g, b), n in found.items()]


def flagship_int8_bounds(batch: int = 16) -> dict:
    """``--int8-bounds``: KQ's and Q's bounds at each distinct conv of the
    flagship's forward on a batch of ``batch`` 512 px tiles
    (``conv_geometry``, ``int8_bound``; every output bf16, as under the
    predict's autocast), and their sums.  Needs no card."""
    import torch
    from pylc_tpu_torch.config import Config
    from pylc_tpu_torch.ops.kernels.int8_conv import output_hw
    from pylc_tpu_torch.train_state import init_model
    cfg = Config()
    model = init_model(cfg, seed=0).eval().to(
        memory_format=torch.channels_last)
    t = cfg.tile_size
    rows = []
    for e in conv_geometry(model, (batch, 3, t, t)):
        B, C, H, W = e["x"]
        O, kh, kw, _ = e["w"]
        hw = output_hw(H, W, (kh, kw), e["stride"], e["padding"],
                       e["dilation"])
        rows.append({**e, **int8_bound(e["x"], 4 if e["x_dtype"] ==
                                       "float32" else 2, e["w"], hw, 2,
                                       e["bias"])})
    return {"rows": rows, "per_batch": int8_sums(rows)}


def int8_rows(entries, n_graph: int = 50, n_loop: int = 50):
    """Q and KQ on each captured conv input (``capture_conv_inputs``):
    both held bit for bit to their plain versions, then timed.  Returns a
    row per entry with the conv's geometry, ``count``, the kernels' form,
    their errors against the plain versions (0 when bit-equal), and ms:
    KQ and Q from a CUDA graph of ``n_graph`` launches (``kq_g_ms``,
    ``q_g_ms``) and a host loop of ``n_loop`` (``kq_h_ms``, ``q_h_ms``),
    the plain versions once each, ``torch._int_mm`` on the im2col
    (``library_ms``, groups = 1 only), cuDNN's bf16 conv of the layer and
    ``torch.quantize_per_tensor`` on an f32 input (``q_library_ms``) from
    graphs, and the bounds (``kq_bound_ms`` from 2 x multiply-adds at
    the int8 tensor-core peak against the bytes, ``q_bound_ms``)."""
    import torch
    import torch.nn.functional as F
    from pylc_tpu_torch.ops.kernels.int8_conv import (
        form, int8_conv2d, int8_conv2d_plain, quantize_int8,
        quantize_int8_plain)
    rows = []
    for e in entries:
        conv, x, out_dtype = e["conv"], e["x"], e["out_dtype"]
        args = (conv.qweight.view(conv.weight_shape), conv.w_scale,
                conv.bias, conv.s_x, conv.stride, conv.padding,
                conv.dilation, conv.groups, out_dtype)
        qx = quantize_int8(x, conv.s_x)
        q_plain = quantize_int8_plain(x, conv.s_x)
        y = int8_conv2d(qx, *args)
        y_plain = int8_conv2d_plain(qx, *args)
        torch.cuda.synchronize()
        q_err = float((qx.int() - q_plain.int()).abs().max())
        kq_err = float((y.float() - y_plain.float()).abs().max())
        if not (torch.equal(qx, q_plain) and torch.equal(y, y_plain)):
            raise AssertionError(
                f"int8 kernels differ from their plain versions at "
                f"{tuple(x.shape)} {conv}: Q {q_err}, KQ {kq_err}")
        B, C, H, W = x.shape
        row = {"x": [B, C, H, W], "x_dtype": str(x.dtype).split(".")[-1],
               "w": list(conv.weight_shape), "stride": list(conv.stride),
               "padding": list(conv.padding),
               "dilation": list(conv.dilation), "groups": conv.groups,
               "out_dtype": str(out_dtype).split(".")[-1],
               "count": e["count"], "form": form(qx, args[0], conv.groups),
               "kq_err": kq_err, "q_err": q_err,
               **int8_bound(x.shape, x.element_size(), conv.weight_shape,
                            y.shape[1:3], y.element_size(),
                            conv.bias is not None)}
        row["kq_g_ms"] = graph_ms(lambda: int8_conv2d(qx, *args), n_graph)
        row["kq_h_ms"] = cuda_ms(lambda: int8_conv2d(qx, *args), n_loop)
        row["q_g_ms"] = graph_ms(lambda: quantize_int8(x, conv.s_x),
                                  n_graph)
        row["q_h_ms"] = cuda_ms(lambda: quantize_int8(x, conv.s_x), n_loop)
        row["kq_plain_ms"] = cuda_ms(lambda: int8_conv2d_plain(qx, *args),
                                      1, warmup=0)
        row["q_plain_ms"] = cuda_ms(
            lambda: quantize_int8_plain(x, conv.s_x), 1, warmup=0)
        # one PyTorch call that quantizes per tensor (it divides by the
        # scale and clamps to -128, so it is a yardstick, not the same
        # numbers), on the same activation
        row["q_library_ms"] = graph_ms(lambda: torch.quantize_per_tensor(
            x, conv.s_x, 0, torch.qint8), n_graph) \
            if x.dtype == torch.float32 else None
        if conv.groups == 1:
            a, b = _im2col_int8(qx, conv)
            row["library_ms"] = graph_ms(lambda: torch._int_mm(a, b),
                                          n_graph)
            del a, b
        else:
            row["library_ms"] = None  # _int_mm has no groups
        xb = x.to(torch.bfloat16)
        wb = conv.weight.to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        row["cudnn_bf16_ms"] = graph_ms(lambda: F.conv2d(
            xb, wb, None, conv.stride, conv.padding, conv.dilation,
            conv.groups), n_graph)
        rows.append(row)
        del qx, q_plain, y, y_plain, xb, wb
    return rows


def int8_sums(rows):
    """Each timed key of ``int8_rows`` summed over the rows, each row
    ``count`` times: the kernels' work per captured run.  ``library_ms``
    is None where a row has none."""
    keys = ("kq_g_ms", "kq_h_ms", "q_g_ms", "q_h_ms", "kq_plain_ms",
            "q_plain_ms", "kq_bound_ms", "q_bound_ms", "cudnn_bf16_ms",
            "library_ms", "q_library_ms")
    out = {}
    for k in (k for k in keys if k in rows[0]):
        vals = [r[k] * r["count"] for r in rows if r[k] is not None]
        out[k] = sum(vals) if len(vals) == len(rows) else None
    out["kq_bound_by"] = "operations" if sum(
        r["kq_ops_ms"] * r["count"] for r in rows) >= sum(
        r["kq_bytes_ms"] * r["count"] for r in rows) else "bytes"
    out["convs"] = sum(r["count"] for r in rows)
    out["macs"] = sum(r["macs"] * r["count"] for r in rows)
    for k in ("kq_err", "q_err"):
        if k in rows[0]:
            out[k] = max(r[k] for r in rows)
    return out


def seeded_int8_predict(cfg, model, device, tiles: int = 32, seed=0):
    """``quant.make_predict_int8`` of ``model`` with scales calibrated on
    ``tiles`` seeded uint8 tiles of an in-memory DB, in batches of 8 under
    the predict's bf16 autocast.  Returns (predict_q, scales, seconds of
    the calibration, seconds of the weights' quantization)."""
    import time

    import numpy as np
    import torch
    from pylc_tpu_torch.db.database import TileDB
    from pylc_tpu_torch.quant import (calibrate_absmax,
                                      calibration_batches_from_db,
                                      make_predict_int8)
    rng = np.random.default_rng(seed)
    t = cfg.tile_size
    db = TileDB(data={"img": rng.integers(0, 255, (tiles, 3, t, t),
                                          dtype=np.uint8),
                      "mask": np.zeros((tiles, t, t), np.uint8),
                      "meta": {}})
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    with torch.autocast(device.type, dtype=torch.bfloat16):
        scales = calibrate_absmax(model, calibration_batches_from_db(
            db, cfg, n_tiles=tiles, batch=8, device=str(device)))
    t1 = time.perf_counter()
    predict_q = make_predict_int8(cfg, model, scales)
    return predict_q, scales, t1 - t0, time.perf_counter() - t1


def flagship_int8(device, batch: int = 16, calib_tiles: int = 32, seed=0):
    """The flagship's int8 predict with seeded weights
    (``seeded_int8_predict``): (cfg, predict_q, a seeded uint8 batch of
    ``batch`` 512 px tiles on ``device``)."""
    import numpy as np
    import torch
    from pylc_tpu_torch.config import Config
    from pylc_tpu_torch.train_state import init_model
    cfg = Config()
    model = init_model(cfg, seed=seed).to(device)
    predict_q = seeded_int8_predict(cfg, model, device, calib_tiles,
                                    seed)[0]
    t = cfg.tile_size
    tiles = torch.from_numpy(np.random.default_rng(seed + 1).integers(
        0, 255, (batch, t, t, 3), dtype=np.uint8)).to(device)
    return cfg, predict_q, tiles


def depthwise_entry(device, seed: int = 0):
    """A captured-style entry for ``DEPTHWISE``: a seeded depthwise 3x3
    ``Int8Conv2d`` and an f32 channels_last input, output bf16 (a conv
    under bf16 autocast fed by a BatchNorm, which stays f32)."""
    import torch
    from pylc_tpu_torch.quant import Int8Conv2d
    B, C, H, W, stride = DEPTHWISE
    gen = torch.Generator().manual_seed(seed)
    conv = torch.nn.Conv2d(C, C, 3, stride, 1, groups=C, bias=False)
    with torch.no_grad():
        conv.weight.copy_(torch.randn(conv.weight.shape, generator=gen))
    x = torch.randn((B, C, H, W), generator=gen).clamp_min(0).to(device)
    return {"conv": Int8Conv2d(conv, float(x.abs().max())).to(device),
            "x": x.contiguous(memory_format=torch.channels_last),
            "out_dtype": torch.bfloat16, "count": 1}


def time_int8() -> dict:
    """``--int8``: the rows and sums of the flagship's convs at batch 16
    and of ``DEPTHWISE``, with the card's name and power limit."""
    import torch
    device = torch.device("cuda", 0)
    _, predict_q, tiles = flagship_int8(device)
    entries = capture_conv_inputs(predict_q.model, lambda: predict_q(tiles))
    rows = int8_rows(entries)
    depthwise = int8_rows([depthwise_entry(device)])
    return {"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0],
        "rows": rows, "per_batch_of_16": int8_sums(rows),
        "depthwise": depthwise}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", metavar="DIR",
                    help="another checkout to time in turns with this one")
    ap.add_argument("--rounds", type=int, default=2,
                    help="rounds of DIR, this, this, DIR (default 2)")
    ap.add_argument("--int8", action="store_true",
                    help="time the int8 kernels at the flagship's shapes")
    ap.add_argument("--int8-bounds", action="store_true",
                    help="print the int8 kernels' bounds at the flagship's "
                    "shapes (no card needed)")
    args = ap.parse_args(argv)
    if args.int8_bounds:
        out = flagship_int8_bounds()
        for row in out["rows"]:
            print(json.dumps(row))
        print(json.dumps({"per_batch_of_16": out["per_batch"]}))
        return 0
    if args.int8:
        out = time_int8()
        for row in out["rows"] + out["depthwise"]:
            print(json.dumps(row))
        print(json.dumps({"card": out["card"],
                          "per_batch_of_16": out["per_batch_of_16"]}))
        return 0
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
