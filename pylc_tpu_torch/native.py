"""Host-side palette look-ups: ``colourize`` (class map -> RGB mask) and
``class_encode`` (RGB mask -> class map).

The C++ forms are ``pylc_tpu_torch/csrc/host_lut.cpp``, built with g++ on
first use by ``ops/kernels/_build.py`` into ``pylc_tpu_torch/_build/`` and
bound with ctypes; the numpy forms beside them compute the same and run
on a host that has no g++.  ``available()`` says which of the two runs.
A g++ that is there but fails on the source raises: it is never taken
for a missing one.  This is host code, not a GPU kernel; the semantics
are those of the JAX package's ``pylc_tpu/native.py``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np

from pylc_tpu_torch.ops.kernels import _build

SOURCE = _build.source_path("host_lut")


def build(force: bool = False):
    """Compile the host library if it is missing or older than its
    source.  Returns (library path, g++'s output)."""
    return _build.build("host_lut", force)


@functools.lru_cache(maxsize=1)
def _library() -> Optional[ctypes.CDLL]:
    """The C++ library, or None on a host without g++."""
    if not _build.gxx():
        return None
    lib = _build.load("host_lut")
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.host_colourize_u8.argtypes = [u8p, ctypes.c_int64, u8p,
                                      ctypes.c_int32, u8p]
    lib.host_colourize_u8.restype = None
    lib.host_class_encode_u8.argtypes = [u8p, ctypes.c_int64, u8p,
                                         ctypes.c_int32, ctypes.c_uint8, u8p]
    lib.host_class_encode_u8.restype = None
    return lib


def available() -> bool:
    """True when the C++ forms run (built now if need be), False when the
    numpy forms do."""
    return _library() is not None


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _palette(palette: np.ndarray) -> np.ndarray:
    palette = np.ascontiguousarray(palette, np.uint8)
    if palette.ndim != 2 or palette.shape[1] != 3 \
            or not 1 <= len(palette) <= 256:
        raise ValueError(f"palette must be [1..256, 3] uint8, got "
                         f"{palette.shape}")
    return palette


def colourize_numpy(class_map: np.ndarray, palette: np.ndarray
                    ) -> np.ndarray:
    """[...] u8 class map -> [..., 3] u8; a class outside the palette
    takes colour 0, as in the C++ form."""
    class_map = np.asarray(class_map, np.uint8)
    palette = _palette(palette)
    return palette[np.where(class_map < len(palette), class_map, 0)]


def class_encode_numpy(rgb: np.ndarray, palette: np.ndarray,
                       default_class: int = 1) -> np.ndarray:
    """[..., 3] u8 RGB -> [...] u8 class map; a colour that is not in the
    palette gets ``default_class`` (the reference's class-1 quirk)."""
    rgb = np.asarray(rgb, np.uint8)
    palette = _palette(palette)

    def keys(a):
        a = a.astype(np.int32)
        return (a[..., 0] << 16) | (a[..., 1] << 8) | a[..., 2]

    eq = keys(rgb)[..., None] == keys(palette)
    return np.where(eq.any(-1), eq.argmax(-1), default_class
                    ).astype(np.uint8)


def colourize(class_map: np.ndarray, palette: np.ndarray) -> np.ndarray:
    """[...] u8 class map -> [..., 3] u8 RGB mask, on the host."""
    lib = _library()
    if lib is None:
        return colourize_numpy(class_map, palette)
    class_map = np.ascontiguousarray(class_map, np.uint8)
    palette = _palette(palette)
    out = np.empty(class_map.shape + (3,), np.uint8)
    lib.host_colourize_u8(_u8p(class_map), class_map.size, _u8p(palette),
                          len(palette), _u8p(out))
    return out


def class_encode(rgb: np.ndarray, palette: np.ndarray,
                 default_class: int = 1) -> np.ndarray:
    """[..., 3] u8 RGB mask -> [...] u8 class map, on the host."""
    lib = _library()
    if lib is None:
        return class_encode_numpy(rgb, palette, default_class)
    rgb = np.ascontiguousarray(rgb, np.uint8)
    if rgb.ndim < 1 or rgb.shape[-1] != 3:
        raise ValueError(f"rgb must be [..., 3] uint8, got {rgb.shape}")
    palette = _palette(palette)
    out = np.empty(rgb.shape[:-1], np.uint8)
    lib.host_class_encode_u8(_u8p(rgb), out.size, _u8p(palette),
                             len(palette), default_class, _u8p(out))
    return out
