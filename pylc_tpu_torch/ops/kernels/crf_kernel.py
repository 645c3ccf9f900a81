"""One dense-CRF mean-field iteration: CUDA kernel K1 and its plain form.

Port of the TPU kernel ``pylc_tpu/ops/pallas/crf_kernel.py::crf_iteration``.
The kernel is ``pylc_tpu_torch/csrc/crf_iteration.cu`` (its header says
what bounds it and what its design does about that): a register-tiled
kernel with compile-time sizes for the (C, G, r) of ``TILED_SIZES``, the
sizes the package uses; for every other size at 1 <= r <=
``WIDE_MAX_RADIUS`` (every radius the kernel takes) the wide kernel, which
makes each pixel's weights once and keeps the tile's logits on chip while
it walks the classes in chunks (the narrow sizes, at most
``GENERIC_CLASSES`` classes, ``narrow_fits``; 17 to ``MAX_CLASSES``
classes, ``wide_fits``, and there at r = 0 too).  Up to r = 5 a thread of
it holds a pair of window rows' coefficients on an 8-row tile; at r = 6 to
8 one window row on a 4-row tile, and the parts' sums meet through every
thread of the block.  A generic one-thread-per-pixel kernel takes r = 0 up
to ``GENERIC_CLASSES`` classes.  ``variant`` says which one a size gets.
The generic kernel, and the simple wide kernel above ``GENERIC_CLASSES``,
are every size's yardstick (``crf_iteration_generic``).  The library is
compiled by ``_build`` (nvcc, ``sm_90a``) into ``pylc_tpu_torch/_build/``
on first use, from the checkout's own source, and called through
``ctypes`` on PyTorch's current stream.

The iteration is the custom operator ``torch.ops.pylc.crf_iteration``
(``torch.library``), so that ``torch.export`` records it as one call in a
serving program (``pylc_tpu_torch/export.py``) where it cannot trace a
``ctypes`` call.  Its CPU implementation is the plain torch version and
its CUDA implementation launches the kernel; there is no other choice
between the two, and no other device.  ``crf_iteration.launches`` counts
kernel launches, inside the CUDA implementation, so that the launches of
an exported program count too.  Importing this module registers the
operator, which is all a process needs to load such a program.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

from pylc_tpu_torch.ops.kernels import _build

SOURCE = _build.source_path("crf_iteration")

# bounds compiled into the kernel (kMaxC, kMaxG, kMaxR in the source); the
# JAX package's Pallas kernel takes any C, its fused loss at most 128
MAX_CLASSES = 128
MAX_GUIDE = 4
MAX_RADIUS = 8
# most classes the generic kernel holds (kGenericC): the narrow sizes; more
# run on the wide kernels
GENERIC_CLASSES = 16
# (C, G, r) with a tiled instantiation (PYLC_K1_TILED_SIZES in the source):
# both schemas' class counts, an RGB or a grayscale guide, the default radius
TILED_SIZES = frozenset({(9, 3, 3), (11, 3, 3), (9, 1, 3), (11, 1, 3)})
# the largest radius the wide kernel is built for (kWideMaxR in the
# source): every radius the kernel takes
WIDE_MAX_RADIUS = 8


def wide_fits(C: int, r: int) -> bool:
    """Whether C classes at radius r run on the wide kernel."""
    return C > GENERIC_CLASSES and r <= WIDE_MAX_RADIUS


def narrow_fits(C: int, G: int, r: int) -> bool:
    """Whether C classes with a G-channel guide at radius r are a narrow
    size: at most ``GENERIC_CLASSES`` classes outside ``TILED_SIZES`` that
    the wide kernel takes (``variant`` names them ``narrow<R=r>``); at
    r = 0 (no window) the generic kernel is the faster and keeps them."""
    return (C <= GENERIC_CLASSES and (C, G, r) not in TILED_SIZES
            and 1 <= r <= WIDE_MAX_RADIUS)


def variant(C: int, G: int, r: int) -> str:
    """Name of the kernel that a [C, H, W] distribution with a G-channel
    guide and radius r runs on: ``narrow<R=r>`` is the wide kernel's
    instantiation for radius r at a narrow size."""
    if (C, G, r) in TILED_SIZES:
        return f"tiled<C={C},G={G},R={r}>"
    if C <= GENERIC_CLASSES:
        return f"narrow<R={r}>" if narrow_fits(C, G, r) else "generic"
    return f"wide<R={r}>" if wide_fits(C, r) else "wide-simple"


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
    lib.crf_iteration_max_classes.argtypes = []
    lib.crf_iteration_max_classes.restype = ci
    lib.crf_iteration_wide_fits.argtypes = [ci, ci]
    lib.crf_iteration_wide_fits.restype = ci
    lib.crf_iteration_is_narrow.argtypes = [ci, ci, ci]
    lib.crf_iteration_is_narrow.restype = ci
    if lib.crf_iteration_max_classes() != MAX_CLASSES:
        raise RuntimeError("crf_iteration.cu's kMaxC disagrees with "
                           "MAX_CLASSES")
    for C in range(GENERIC_CLASSES + 1, MAX_CLASSES + 1):
        for r in range(MAX_RADIUS + 1):
            if bool(lib.crf_iteration_wide_fits(C, r)) != wide_fits(C, r):
                raise RuntimeError(
                    "crf_iteration.cu's wide_fits disagrees with wide_fits "
                    f"at (C, r) = {(C, r)}")
    for C in range(1, GENERIC_CLASSES + 1):
        for G in range(1, MAX_GUIDE + 1):
            for r in range(MAX_RADIUS + 1):
                if bool(lib.crf_iteration_is_tiled(C, G, r)) != \
                        ((C, G, r) in TILED_SIZES):
                    raise RuntimeError(
                        "crf_iteration.cu's PYLC_K1_TILED_SIZES disagrees "
                        f"with TILED_SIZES at (C, G, r) = {(C, G, r)}")
                if bool(lib.crf_iteration_is_narrow(C, G, r)) != \
                        narrow_fits(C, G, r):
                    raise RuntimeError(
                        "crf_iteration.cu's crf_iteration_is_narrow "
                        "disagrees with narrow_fits at (C, G, r) = "
                        f"{(C, G, r)}")
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
    if not 1 <= C <= MAX_CLASSES:
        raise ValueError(
            f"crf_iteration: C={C} classes, outside the kernel's bounds: "
            f"it takes 1 to MAX_CLASSES = {MAX_CLASSES}, the JAX package's "
            "own limit on classes (its fused loss asserts C <= 128)")
    if not (1 <= G <= MAX_GUIDE and 0 <= r <= MAX_RADIUS):
        raise ValueError(
            f"crf_iteration: G={G}, r={r} outside the kernel's bounds "
            f"(G <= {MAX_GUIDE}, r <= {MAX_RADIUS})")
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


@torch.library.custom_op("pylc::crf_iteration", mutates_args=(),
                         device_types="cpu")
def _crf_iteration_op(q: torch.Tensor, g: torch.Tensor, u: torch.Tensor,
                      r: int, sigma_spatial_app: float, sigma_color: float,
                      sigma_spatial_sm: float, w_app: float, w_sm: float,
                      eps: float) -> torch.Tensor:
    return crf_iteration_reference(q, g, u, r, sigma_spatial_app,
                                   sigma_color, sigma_spatial_sm, w_app,
                                   w_sm, eps)


@_crf_iteration_op.register_kernel("cuda")
def _crf_iteration_cuda(q, g, u, r, sigma_spatial_app, sigma_color,
                        sigma_spatial_sm, w_app, w_sm, eps):
    out = _launch(q, g, u, r, sigma_spatial_app, sigma_color,
                  sigma_spatial_sm, w_app, w_sm, eps, generic=False)
    crf_iteration.launches += 1
    return out


@_crf_iteration_op.register_fake
def _crf_iteration_fake(q, g, u, r, sigma_spatial_app, sigma_color,
                        sigma_spatial_sm, w_app, w_sm, eps):
    return torch.empty_like(q)


def crf_iteration(q: torch.Tensor, g: torch.Tensor, u: torch.Tensor, r: int,
                  sigma_spatial_app: float, sigma_color: float,
                  sigma_spatial_sm: float, w_app: float, w_sm: float,
                  eps: float = 1e-8) -> torch.Tensor:
    """One mean-field iteration, channel-major: q, u [C, H, W] and
    g [G, H, W] f32 -> [C, H, W] f32, through ``torch.ops.pylc.
    crf_iteration``.

    A CPU tensor goes through ``crf_iteration_reference``; a CUDA tensor
    through the kernel ``variant(C, G, r)`` names, or this raises."""
    return _crf_iteration_op(q, g, u, int(r), float(sigma_spatial_app),
                             float(sigma_color), float(sigma_spatial_sm),
                             float(w_app), float(w_sm), float(eps))


crf_iteration.launches = 0


def crf_iteration_generic(q: torch.Tensor, g: torch.Tensor, u: torch.Tensor,
                          r: int, sigma_spatial_app: float,
                          sigma_color: float, sigma_spatial_sm: float,
                          w_app: float, w_sm: float, eps: float = 1e-8
                          ) -> torch.Tensor:
    """``crf_iteration`` on the simple form of its size whatever the
    sizes, CUDA tensors only: the generic kernel up to ``GENERIC_CLASSES``
    classes, the simple wide kernel above.  The yardstick the tiled,
    narrow and wide kernels are timed against; the package's paths do not
    call it, and it counts no launch."""
    return _launch(q, g, u, r, sigma_spatial_app, sigma_color,
                   sigma_spatial_sm, w_app, w_sm, eps, generic=True)
