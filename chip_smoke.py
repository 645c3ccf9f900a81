"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds kernel K1 (the dense-CRF mean-field iteration,
pylc_tpu_torch/csrc/crf_iteration.cu) from the checkout's source, holds
it against its plain torch version at the serving shape and at a ragged
one, then drives the port's main path, ``Segmenter`` with the CRF on, at
full width: DeepLabV3+/ResNet101 (OS16, schema_a, 512 px tiles at
stride 256) on a seeded 3584x2048 photo, with random weights from a
seeded ``torch.Generator`` that go through a reference-schema ``.pth``
and ``load_pth_model``.  Last comes the ``test`` CLI on a 3872x2592
JPEG.  Any failed check raises, and the script exits non-zero.

Output: per-phase lines, then one JSON line with every kernel, the
card's ``name, power.limit`` line, and last a JSON line
{"ok": true, "device": {...}}.  Without a CUDA device it prints no result
and exits non-zero.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
SLICE_HW = (2048, 3584)        # bench.py's 3872x2592 photo, fitted
CLI_PHOTO_HW = (2592, 3872)
K1_SHAPES = [                  # (C, G, H, W, r)
    (9, 3, 1024, 1792, 3),     # the slice: schema_a on the 2x-pooled grid
    (11, 3, 37, 70, 2),        # ragged, schema_b's class count
]
K1_ATOL = 1e-5                 # f32, no fast math; measured ~2e-7
CRF_AGREEMENT = 0.999          # class maps, kernel CRF vs plain CRF
N_PHOTOS = 3                   # timed runs of the slice after one warm-up


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, n: int, warmup: int = 2) -> float:
    """Mean device milliseconds of ``fn`` over ``n`` back-to-back calls."""
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


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def random_deeplab(cfg, seed: int):
    """DeepLabV3+/ResNet101 with He-normal conv weights drawn from a
    seeded generator; BatchNorm starts as identity."""
    from pylc_tpu_torch.models.registry import build_model
    model = build_model(cfg)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.Conv2d):
                fan_in = m.weight[0].numel()
                m.weight.copy_(torch.randn(m.weight.shape, generator=gen)
                               * (2.0 / fan_in) ** 0.5)
                if m.bias is not None:
                    m.bias.zero_()
    return model


def plain_crf(params):
    """The CRF of ``ops/crf.py`` step by step, with every iteration done
    by the plain torch version instead of the kernel."""
    from pylc_tpu_torch.ops.crf import _pool, _upsample
    from pylc_tpu_torch.ops.kernels.crf_kernel import crf_iteration_reference

    def crf(canvas, guide):
        H, W, _ = canvas.shape
        k = params.downsample
        q, g = _pool(canvas.float(), k), _pool(guide.float(), k)
        u = torch.log(q + params.eps).permute(2, 0, 1).contiguous()
        q = q.permute(2, 0, 1).contiguous()
        g = g.permute(2, 0, 1).contiguous()
        for _ in range(params.n_iters):
            q = crf_iteration_reference(
                q, g, u, params.radius, params.sigma_spatial_app,
                params.sigma_color, params.sigma_spatial_sm,
                params.w_appearance, params.w_smoothness, params.eps)
        q = _upsample(q.permute(1, 2, 0), H, W, k)
        return q / q.sum(dim=-1, keepdim=True)

    return crf


def phase_build():
    from pylc_tpu_torch.ops.kernels import crf_kernel
    t0 = time.perf_counter()
    path, report = crf_kernel.build(force=True)
    log(f"[build] nvcc {' '.join(crf_kernel.NVCC_FLAGS)} -> "
        f"{os.path.relpath(path, REPO)} in {time.perf_counter() - t0:.2f} s")
    for line in report.splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build]   {line.strip()}")


def phase_k1(device):
    """K1 against crf_iteration_reference on the card."""
    from pylc_tpu_torch.ops.kernels.crf_kernel import (
        crf_iteration, crf_iteration_reference)
    sig = (3.0, 13.0, 1.5, 3.0, 1.0, 1e-8)
    worst, slice_ms, slice_plain_ms = 0.0, None, None
    for C, G, H, W, r in K1_SHAPES:
        rng = np.random.default_rng(C * 1000 + H)
        q = rng.random((C, H, W)).astype(np.float32)
        q /= q.sum(0, keepdims=True)
        g = rng.integers(0, 256, (G, H, W)).astype(np.float32)
        u = np.log(q + 1e-8)
        q, g, u = (torch.from_numpy(a).to(device) for a in (q, g, u))
        got = crf_iteration(q, g, u, r, *sig)
        want = crf_iteration_reference(q, g, u, r, *sig)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        ms = cuda_ms(lambda: crf_iteration(q, g, u, r, *sig), 50)
        plain_ms = cuda_ms(lambda: crf_iteration_reference(q, g, u, r, *sig),
                           10)
        log(f"[k1] C={C} G={G} {H}x{W} r={r}: max_abs_err {err:.3e} "
            f"(limit {K1_ATOL:g}); kernel {ms:.4f} ms/iter, plain "
            f"{plain_ms:.4f} ms/iter")
        if not err <= K1_ATOL:
            raise AssertionError(f"K1 disagrees with its plain version: "
                                 f"{err} > {K1_ATOL}")
        worst = max(worst, err)
        if slice_ms is None:
            slice_ms, slice_plain_ms = ms, plain_ms
    return worst, slice_ms, slice_plain_ms


def phase_network_check(model, cfg, device):
    """The network on the card in true f32 against the same network on
    the CPU, on two tiles: the tolerance of tests/test_golden_parity.py."""
    import copy

    from pylc_tpu_torch.train_state import make_predict
    f32 = cfg.replace(compute_dtype="float32")
    tiles = np.random.default_rng(7).integers(
        0, 255, (2, cfg.tile_size, cfg.tile_size, 3), dtype=np.uint8)
    want = make_predict(f32, copy.deepcopy(model).cpu())(
        torch.from_numpy(tiles)).numpy()
    got = make_predict(f32, model)(torch.from_numpy(tiles).to(device))
    got = got.cpu().numpy()
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    agree = float(np.mean(got.argmax(-1) == want.argmax(-1)))
    log(f"[net] f32 card vs CPU on 2 tiles: max_abs_err {err:.3e} at logit "
        f"scale {scale:.3e}; argmax agreement {agree:.5f}")
    np.testing.assert_allclose(got, want, rtol=1e-3,
                               atol=max(5e-4, 1e-5 * scale))
    if agree < 0.999:
        raise AssertionError(f"f32 argmax agreement {agree} < 0.999")


def phase_slice(device, workdir, cfg_base=None, hw=SLICE_HW):
    """The main path: .pth round trip, Segmenter with the CRF on."""
    from pylc_tpu_torch.config import Config
    from pylc_tpu_torch.infer import Segmenter
    from pylc_tpu_torch.ops.crf import make_crf
    from pylc_tpu_torch.ops.kernels.crf_kernel import crf_iteration
    from pylc_tpu_torch.tester import load_model

    cfg = cfg_base or Config()
    pth = os.path.join(workdir, "deeplab_resnet101_random.pth")
    model = random_deeplab(cfg, seed=0)
    torch.save({"model": model.state_dict(), "meta": cfg.to_meta()}, pth)
    del model
    cfg, model, _ = load_model(pth, cfg, device)
    phase_network_check(model, cfg, device)
    from pylc_tpu_torch.train_state import make_predict
    predict = make_predict(cfg, model)  # compute_dtype bf16: autocast
    crf = make_crf(cfg)
    seg = Segmenter(cfg, predict, device, batch_size=16, crf=crf)
    photo = np.random.default_rng(0).integers(0, 255, (*hw, 3),
                                              dtype=np.uint8)
    n_classes = cfg.n_classes

    torch.cuda.reset_peak_memory_stats(device)
    crf_iteration.launches = 0
    runs = [seg.segment_array_staged(photo) for _ in range(1 + N_PHOTOS)]
    launches = crf_iteration.launches
    expect = len(runs) * crf.params.n_iters
    log(f"[slice] K1 launches {launches} over {len(runs)} photos "
        f"(expected {expect} = photos x crf_iters)")
    if launches != expect:
        raise AssertionError(f"K1 launched {launches} times, not {expect}")
    peak = torch.cuda.max_memory_allocated(device)

    res = runs[-1]
    cm, canvas = res["class_map"], res["probs"]
    if cm.shape != hw or cm.dtype != np.uint8 or int(cm.max()) >= n_classes:
        raise AssertionError(f"class map {cm.shape} {cm.dtype} max "
                             f"{int(cm.max())}")
    if canvas.shape != (*hw, n_classes) or not torch.isfinite(canvas).all():
        raise AssertionError("canvas shape or NaN/inf")
    row_err = (canvas.sum(-1) - 1).abs().max().item()
    if not row_err <= 1e-3:
        raise AssertionError(f"canvas rows sum to 1 +- {row_err}")
    mp = res["megapixels"]
    for i, r in enumerate(runs[1:]):
        st = " ".join(f"{k} {v * 1e3:.2f} ms" for k, v in r["stages"].items())
        log(f"[slice] photo {i}: {r['seconds']:.4f} s, "
            f"{mp / r['seconds']:.3f} MP/s ({st})")
    secs = sorted(r["seconds"] for r in runs[1:])
    median = secs[len(secs) // 2]
    log(f"[slice] {hw[1]}x{hw[0]} ({mp:.3f} MP), {cfg.n_classes} classes, "
        f"compute {cfg.compute_dtype}: median {median:.4f} s = "
        f"{mp / median:.3f} MP/s; peak device memory "
        f"{peak / 2 ** 30:.3f} GiB; canvas rows sum to 1 +- {row_err:.2e}")

    plain = Segmenter(cfg, predict, device, batch_size=16,
                      crf=plain_crf(crf.params))
    plain_res = [plain.segment_array_staged(photo) for _ in range(2)][-1]
    if crf_iteration.launches != launches:
        raise AssertionError("the plain CRF run launched K1")
    agree = float(np.mean(plain_res["class_map"] == cm))
    diff = (plain_res["probs"] - canvas).abs().max().item()
    log(f"[slice] plain-CRF rerun: crf stage "
        f"{plain_res['stages']['crf'] * 1e3:.2f} ms vs kernel "
        f"{res['stages']['crf'] * 1e3:.2f} ms; class-map agreement "
        f"{agree:.6f} (limit {CRF_AGREEMENT}); canvas max_abs_diff "
        f"{diff:.3e}")
    if agree < CRF_AGREEMENT:
        raise AssertionError(f"class maps agree on {agree} < {CRF_AGREEMENT}")
    return launches, pth


def _png_size(path):
    with open(path, "rb") as f:
        head = f.read(24)
    if head[:8] != b"\x89PNG\r\n\x1a\n":
        raise AssertionError(f"{path} is not a PNG")
    return int.from_bytes(head[16:20], "big"), int.from_bytes(head[20:24],
                                                             "big")


def phase_cli(pth, workdir):
    """``python -m pylc_tpu_torch test -l m.pth -i photo.jpg --crf`` on
    the card, on a JPEG written by a child process (the CLI decodes with
    cv2; this script does not import it)."""
    env = dict(os.environ, PYTHONPATH=REPO)
    photo = os.path.join(workdir, "photo.jpg")
    h, w = CLI_PHOTO_HW
    subprocess.run(
        [sys.executable, "-c",
         "import sys, cv2, numpy as np; "
         f"img = np.random.default_rng(1).integers(0, 255, ({h}, {w}, 3), "
         "dtype=np.uint8); sys.exit(0 if cv2.imwrite(sys.argv[1], img) "
         "else 1)", photo], check=True, env=env, timeout=120)
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "pylc_tpu_torch", "test", "-l", pth, "-i",
         photo, "--crf"], cwd=workdir, env=env, capture_output=True,
        text=True, timeout=600)
    if out.returncode != 0:
        raise AssertionError(f"CLI failed:\n{out.stdout}\n{out.stderr}")
    mask = os.path.join(workdir, "data", "outputs",
                        "pylc_deeplab_ch3_schema_a", "masks",
                        "photo_jpg_scale_1.0.png")
    size = _png_size(mask)
    if size != (w, h):
        raise AssertionError(f"CLI mask is {size}, photo is {(w, h)}")
    for line in out.stdout.strip().splitlines()[-1:]:
        log(f"[cli] {line.strip()}")
    log(f"[cli] mask {size[0]}x{size[1]} PNG written; process wall "
        f"{time.perf_counter() - t0:.1f} s (interpreter start, weights, "
        "kernel load, one photo)")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    import pylc_tpu_torch  # noqa: F401  (fails outside a checkout)

    device = torch.device("cuda", 0)
    card = card_line()
    log(f"[card] {card}; {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}; torch {torch.__version__} CUDA "
        f"{torch.version.cuda}; python {sys.version.split()[0]}")
    phase_build()
    err, ms, plain_ms = phase_k1(device)
    build_root = os.path.join(REPO, "pylc_tpu_torch", "_build")
    os.makedirs(build_root, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_root) as workdir:
        launches, pth = phase_slice(device, workdir)
        phase_cli(pth, workdir)
    print(json.dumps({"kernels": [{
        "name": "crf_iteration",
        "route": "cuda",
        "source": "pylc_tpu_torch/csrc/crf_iteration.cu",
        "replaces": "pylc_tpu/ops/pallas/crf_kernel.py:120",
        "launches": launches,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
    }]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
