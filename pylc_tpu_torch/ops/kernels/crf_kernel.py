"""One dense-CRF mean-field iteration: CUDA kernel K1 and its plain form.

Port of the TPU kernel ``pylc_tpu/ops/pallas/crf_kernel.py::crf_iteration``.
The kernel is ``pylc_tpu_torch/csrc/crf_iteration.cu`` (its header says
what bounds it and what its design does about that): a register-tiled
kernel with compile-time sizes for the (C, G, r) of ``TILED_SIZES``, the
sizes the package uses, and a generic one-thread-per-pixel kernel for
every other size within the bounds.  ``variant`` says which of the two a
size gets.  The library is compiled by ``_build`` (nvcc, ``sm_90a``) into
``pylc_tpu_torch/_build/`` on first use, from the checkout's own source,
and called through ``ctypes`` on PyTorch's current stream.

``crf_iteration`` takes the plain torch version for a tensor on the CPU,
and launches the kernel for a CUDA tensor; there is no other choice
between the two.  ``crf_iteration.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

from pylc_tpu_torch.ops.kernels import _build

SOURCE = _build.source_path("crf_iteration")

# bounds compiled into the kernel (kMaxC, kMaxG, kMaxR in the source)
MAX_CLASSES = 16
MAX_GUIDE = 4
MAX_RADIUS = 8
# (C, G, r) with a tiled instantiation (PYLC_K1_TILED_SIZES in the source):
# both schemas' class counts, an RGB or a grayscale guide, the default radius
TILED_SIZES = frozenset({(9, 3, 3), (11, 3, 3), (9, 1, 3), (11, 1, 3)})


def variant(C: int, G: int, r: int) -> str:
    """Name of the kernel that a [C, H, W] distribution with a G-channel
    guide and radius r runs on."""
    return f"tiled<C={C},G={G},R={r}>" if (C, G, r) in TILED_SIZES \
        else "generic"


def build(force: bool = False):
    """Compile the kernel library if it is missing or older than its
    source.  Returns (library path, nvcc's ``-Xptxas -v`` report; empty
    when nothing was built)."""
    return _build.build("crf_iteration", force)


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = _build.load("crf_iteration")
    vp, ci, cf, cd = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
        ctypes.c_double
    lib.crf_iteration_f32.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci,
                                      cd, cf, cd, cf, cf, cf, ci, vp]
    lib.crf_iteration_f32.restype = ci
    lib.crf_iteration_is_tiled.argtypes = [ci, ci, ci]
    lib.crf_iteration_is_tiled.restype = ci
    for C in range(1, MAX_CLASSES + 1):
        for G in range(1, MAX_GUIDE + 1):
            for r in range(MAX_RADIUS + 1):
                if bool(lib.crf_iteration_is_tiled(C, G, r)) != \
                        ((C, G, r) in TILED_SIZES):
                    raise RuntimeError(
                        "crf_iteration.cu's PYLC_K1_TILED_SIZES disagrees "
                        f"with TILED_SIZES at (C, G, r) = {(C, G, r)}")
    return lib


def crf_iteration_reference(q: torch.Tensor, g: torch.Tensor,
                            u: torch.Tensor, r: int,
                            sigma_spatial_app: float, sigma_color: float,
                            sigma_spatial_sm: float, w_app: float,
                            w_sm: float, eps: float = 1e-8) -> torch.Tensor:
    """Plain torch form of the kernel, channel-major: q, u [C, H, W] and
    g [G, H, W] f32 -> [C, H, W].  Neighbours are edge-replicated; the
    bilateral weight is the product of two exps, as in the kernel."""
    C, H, W = q.shape
    inv2_sp_app = 1.0 / (2.0 * sigma_spatial_app ** 2)
    inv2_col = 1.0 / (2.0 * sigma_color ** 2)
    inv2_sp_sm = 1.0 / (2.0 * sigma_spatial_sm ** 2)
    qp = F.pad(q[None], (r, r, r, r), mode="replicate")[0]
    gp = F.pad(g[None], (r, r, r, r), mode="replicate")[0]
    m_app = torch.zeros_like(q)
    m_sm = torch.zeros_like(q)
    wsum = torch.zeros((1, H, W), dtype=q.dtype, device=q.device)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            if dy == 0 and dx == 0:
                continue
            d2 = float(dy * dy + dx * dx)
            qs = qp[:, r + dy:r + dy + H, r + dx:r + dx + W]
            gs = gp[:, r + dy:r + dy + H, r + dx:r + dx + W]
            col = torch.sum(torch.square(g - gs), dim=0, keepdim=True)
            aw = math.exp(-d2 * inv2_sp_app) * torch.exp(-col * inv2_col)
            m_app += aw * qs
            m_sm += math.exp(-d2 * inv2_sp_sm) * qs
            wsum += aw
    logits = u + w_app * m_app / (wsum + eps) + w_sm * m_sm
    return torch.softmax(logits, dim=0)


def _check(q: torch.Tensor, g: torch.Tensor, u: torch.Tensor, r: int):
    """Validate the kernel's operands; returns (C, G, H, W)."""
    for name, t in (("q", q), ("g", g), ("u", u)):
        if t.device != q.device:
            raise ValueError(f"crf_iteration: {name} on {t.device}, "
                             f"q on {q.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"crf_iteration: {name} is {t.dtype}, "
                             "the kernel takes float32")
        if t.dim() != 3 or not t.is_contiguous():
            raise ValueError(f"crf_iteration: {name} must be a contiguous "
                             f"[channels, H, W] tensor, got "
                             f"{tuple(t.shape)}")
    C, H, W = q.shape
    G = g.shape[0]
    if u.shape != q.shape or g.shape[1:] != q.shape[1:]:
        raise ValueError(f"crf_iteration: shapes q {tuple(q.shape)}, "
                         f"g {tuple(g.shape)}, u {tuple(u.shape)} disagree")
    if not (1 <= C <= MAX_CLASSES and 1 <= G <= MAX_GUIDE
            and 0 <= r <= MAX_RADIUS):
        raise ValueError(
            f"crf_iteration: C={C}, G={G}, r={r} outside the kernel's "
            f"bounds (C <= {MAX_CLASSES}, G <= {MAX_GUIDE}, "
            f"r <= {MAX_RADIUS})")
    return C, G, H, W


def _launch(q, g, u, r, sigma_spatial_app, sigma_color, sigma_spatial_sm,
            w_app, w_sm, eps, generic: bool) -> torch.Tensor:
    if q.device.type != "cuda":
        raise ValueError(f"crf_iteration: no kernel for device {q.device}")
    C, G, H, W = _check(q, g, u, r)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _library().crf_iteration_f32(
            q.data_ptr(), g.data_ptr(), u.data_ptr(), out.data_ptr(),
            C, G, H, W, r,
            1.0 / (2.0 * sigma_spatial_app ** 2),
            1.0 / (2.0 * sigma_color ** 2),
            1.0 / (2.0 * sigma_spatial_sm ** 2),
            w_app, w_sm, eps, int(generic), stream)
    if err != 0:
        raise RuntimeError(f"crf_iteration kernel launch failed: CUDA "
                           f"error {err}")
    return out


def crf_iteration(q: torch.Tensor, g: torch.Tensor, u: torch.Tensor, r: int,
                  sigma_spatial_app: float, sigma_color: float,
                  sigma_spatial_sm: float, w_app: float, w_sm: float,
                  eps: float = 1e-8) -> torch.Tensor:
    """One mean-field iteration, channel-major: q, u [C, H, W] and
    g [G, H, W] f32 -> [C, H, W] f32.

    A CPU tensor goes through ``crf_iteration_reference``; a CUDA tensor
    through the kernel ``variant(C, G, r)`` names, or this raises."""
    if q.device.type == "cpu":
        return crf_iteration_reference(q, g, u, r, sigma_spatial_app,
                                       sigma_color, sigma_spatial_sm, w_app,
                                       w_sm, eps)
    out = _launch(q, g, u, r, sigma_spatial_app, sigma_color,
                  sigma_spatial_sm, w_app, w_sm, eps, generic=False)
    crf_iteration.launches += 1
    return out


crf_iteration.launches = 0


def crf_iteration_generic(q: torch.Tensor, g: torch.Tensor, u: torch.Tensor,
                          r: int, sigma_spatial_app: float,
                          sigma_color: float, sigma_spatial_sm: float,
                          w_app: float, w_sm: float, eps: float = 1e-8
                          ) -> torch.Tensor:
    """``crf_iteration`` on the generic kernel whatever the sizes, CUDA
    tensors only: the yardstick the tiled kernel is timed against.  The
    package's paths do not call it, and it counts no launch."""
    return _launch(q, g, u, r, sigma_spatial_app, sigma_color,
                   sigma_spatial_sm, w_app, w_sm, eps, generic=True)
