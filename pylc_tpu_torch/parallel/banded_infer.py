"""Fully-banded inference over a mesh: each device uploads, unfolds,
forwards and stitches only its own row band of the photo.

Port of ``pylc_tpu/parallel/banded_infer.py``.  The host splits the
fitted photo into ``n_dev`` OVERLAPPING row bands: each carries its
``nL`` tile rows plus the ``tile - stride`` rows it shares with the next
band, and a grid padded to a multiple of the mesh gets zero rows at the
bottom.  Band d goes to ``mesh.devices[d]``, which runs

  band [band_h, W, ch]
    -> unfold (its own tiles, row-major)
    -> the batched forward
    -> overlap-add and the spill to the next band's device
       (``sharded_stitch.local_stitch_with_halo``)

and the canvas stays row-banded for the CRF (``sharded_crf``).  The
halo rows are uploaded twice: (k-1) * stride rows per seam.  Geometry
support is exactly ``sharded_stitch.can_shard``; the Segmenter takes the
tile-split program otherwise.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from pylc_tpu_torch.ops.tiles import unfold_tiles
from pylc_tpu_torch.parallel.mesh import Mesh
from pylc_tpu_torch.parallel.sharded_stitch import (
    assemble_canvas, can_shard, local_stitch_with_halo, trim_rows)


class BandPlan(NamedTuple):
    """Host-side banding geometry of one canvas shape."""
    n_dev: int
    n_rows: int      # tile-grid rows
    n_rows_p: int    # padded to a multiple of the mesh
    nL: int          # tile rows per band
    band_h: int      # image rows per band, halo included
    H: int
    W: int
    stride: int


def plan_bands(H: int, W: int, tile: int, stride: int, n_dev: int
               ) -> BandPlan:
    n_rows = (H - tile) // stride + 1
    n_rows_p = -(-n_rows // n_dev) * n_dev
    nL = n_rows_p // n_dev
    band_h = (nL - 1) * stride + tile
    return BandPlan(n_dev, n_rows, n_rows_p, nL, band_h, H, W, stride)


def can_band(H: int, W: int, tile: int, stride: int, n_dev: int) -> bool:
    n_rows = (H - tile) // stride + 1
    return can_shard(n_rows, tile, stride, n_dev)


def split_bands(img: np.ndarray, plan: BandPlan,
                out: Optional[np.ndarray] = None) -> np.ndarray:
    """[H, W, C] -> [n_dev, band_h, W, C] overlapping row bands; the
    grid's padding rows at the bottom are zero (their tiles weigh 0 in the
    stitch).  Band d is what device d uploads.  ``out``: an array of that
    shape to write the bands into (a pinned buffer that is used again),
    else a new one."""
    n_dev, _, _, nL, band_h, H, W, stride = plan
    if out is None:
        out = np.empty((n_dev, band_h, W, img.shape[2]), img.dtype)
    for d in range(n_dev):
        top = d * nL * stride
        rows = min(max(H - top, 0), band_h)
        out[d, :rows] = img[top:top + rows]
        out[d, rows:] = 0
    return out


def banded_guide(bands: Sequence[torch.Tensor], plan: BandPlan
                 ) -> List[torch.Tensor]:
    """The [H, W, C] photo as a row-banded list, from the uploaded bands
    and without moving them: each band gives the ``nL * stride`` rows it
    owns, and the last the ``tile - stride`` rows of its halo tail."""
    _, _, _, nL, band_h, H, _, stride = plan
    parts = [b[:nL * stride] for b in bands]
    parts.append(bands[-1][nL * stride:band_h])
    return trim_rows(parts, H)


def run_banded(bands: Sequence[torch.Tensor],
               tile_probs: Callable[[torch.Tensor], torch.Tensor],
               n_cols: int, tile: int, stride: int, mesh: Mesh,
               plan: BandPlan) -> List[torch.Tensor]:
    """Unfold, forward and stitch each band on its device.

    ``bands[d]`` [band_h, W, ch] on ``mesh.devices[d]``;
    ``tile_probs(tiles)`` -> [N, t, t, C] class probabilities of a tile
    batch on its own device.  Returns the [H, W_canvas, C] canvas as a
    row-banded list (``sharded_stitch``)."""
    n_rows, nL = plan.n_rows, plan.nL
    stitched, halo = [], None
    for d, band in enumerate(bands):
        nxt = mesh.devices[d + 1] if d + 1 < mesh.size else None
        probs = tile_probs(unfold_tiles(band, tile, stride))
        out, halo = local_stitch_with_halo(probs, nL, n_cols, tile, stride,
                                           d, n_rows, halo, nxt)
        stitched.append(out)
    return assemble_canvas(stitched, halo, n_rows, stride, tile)
