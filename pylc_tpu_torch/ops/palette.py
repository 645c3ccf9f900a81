"""Palette (class <-> colour) codecs as device-side torch ops.

Port of ``pylc_tpu/ops/palette.py``; the host forms are ``native.py``'s.

  - ``class_encode``: RGB mask -> class indices.  Each RGB triple is
    packed into one int32 (r << 16 | g << 8 | b) and compared with the
    packed palette; the first matching class wins.  A pixel that matches
    no colour takes class 1 (``default_class``), the reference's
    ``np.ones`` initialization (utils/tools.py:437), kept on purpose: a
    mask with stray anti-aliased colours maps them to class 1 there.
  - ``colourize``: class-index map -> RGB, one gather from the palette.
    A class outside the palette takes colour 0, as in ``native.py``
    (the JAX function fills such a pixel with 255).
  - ``map_palette``: class indices remapped by a key array (schema_b ->
    schema_a by its 'b-to-a' map), one gather.

Every function runs on the device of the tensor it is given.
"""

from __future__ import annotations

import numpy as np
import torch


def _pack_rgb(rgb: torch.Tensor) -> torch.Tensor:
    """Pack [..., 3] uint8 RGB into [...] int32 keys."""
    rgb = rgb.to(torch.int32)
    return (rgb[..., 0] << 16) | (rgb[..., 1] << 8) | rgb[..., 2]


def palette_lut(palette_rgb, device) -> torch.Tensor:
    """The palette as a [C, 3] uint8 tensor on ``device``."""
    return torch.as_tensor(np.asarray(palette_rgb, dtype=np.uint8),
                           device=device)


def class_encode(rgb_mask: torch.Tensor, palette_rgb,
                 default_class: int = 1) -> torch.Tensor:
    """[..., 3] uint8 RGB mask -> [...] uint8 class indices on the mask's
    device; an unmatched pixel gets ``default_class``."""
    keys = _pack_rgb(rgb_mask)
    pal = _pack_rgb(palette_lut(palette_rgb, rgb_mask.device)).tolist()
    out = torch.full(keys.shape, default_class, dtype=torch.uint8,
                     device=keys.device)
    # last class first, so that the first match is the one left standing
    for c in reversed(range(len(pal))):
        out.masked_fill_(keys == pal[c], c)
    return out


def colourize(class_map: torch.Tensor, palette_rgb) -> torch.Tensor:
    """[...] class map -> [..., 3] uint8 RGB on the map's device."""
    palette = palette_lut(palette_rgb, class_map.device)
    idx = class_map.long()
    return palette[torch.where(idx < len(palette), idx, 0)]


def map_palette(class_map: torch.Tensor, key) -> torch.Tensor:
    """Remap class indices by ``key`` (class i -> key[i]), on the map's
    device.  An index outside the key raises."""
    key = torch.as_tensor(np.asarray(key), device=class_map.device)
    idx = class_map.long()
    if idx.numel() and not 0 <= int(idx.min()) <= int(idx.max()) < len(key):
        raise ValueError(f"class indices outside the key's {len(key)} "
                         "entries")
    return key[idx]
