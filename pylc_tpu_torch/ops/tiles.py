"""Tile-grid geometry: fit, unfold, and overlap-stitch.

Port of ``pylc_tpu/ops/tiles.py``.  A photo is cut into an overlapping
grid of square tiles (row-major, as torch ``unfold`` gives), each tile's
class probabilities come back from the network, and the stitch averages
them over every tile that covers a pixel.  With k = tile / stride
sub-blocks per tile side, sub-block (a, b) of grid tile (i, j) lands on
canvas block (i + a, j + b), so the stitch is k^2 shifted adds.
"""

from __future__ import annotations

from math import ceil
from typing import Tuple

import torch


def adjust_to_tile_dims(w: int, h: int, tile_size: int, stride: int
                        ) -> Tuple[int, int, int]:
    """Target (w_fitted, h_fitted, h_crop) for fitting an image onto the
    tile grid: width floored to a tile multiple, height scaled to keep
    the aspect then floored, crop off the top (always 0 with this
    formula; kept for metadata parity)."""
    if stride > tile_size or tile_size % stride:
        raise ValueError("Tile size must be multiple of stride.")
    aspect = w / h
    w_scaled = (w // tile_size) * tile_size
    h_scaled = (ceil(w_scaled / aspect) // tile_size) * tile_size
    h_tgt = int(h_scaled / tile_size) * tile_size
    h_crop = h_scaled - h_tgt
    return w_scaled, h_scaled - h_crop, h_crop


def grid_dims(w: int, h: int, tile_size: int, stride: int
              ) -> Tuple[int, int]:
    """Number of tile-grid (rows, cols)."""
    n_cols = w // stride - 1 if stride < tile_size else w // stride
    n_rows = h // stride - 1 if stride < tile_size else h // stride
    return n_rows, n_cols


def unfold_tiles(img: torch.Tensor, tile_size: int, stride: int
                 ) -> torch.Tensor:
    """Split an image [H, W, C] into tiles [N, tile, tile, C], row-major
    over the grid; a remainder that does not fit the grid is dropped."""
    t = img.unfold(0, tile_size, stride).unfold(1, tile_size, stride)
    # [n_rows, n_cols, C, tile, tile] -> [N, tile, tile, C]
    return t.permute(0, 1, 3, 4, 2).reshape(-1, tile_size, tile_size,
                                            img.shape[-1])


def accumulate_blocks(tile_probs: torch.Tensor, n_rows: int, n_cols: int,
                      tile_size: int, stride: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Overlap-ADD tile maps into canvas block space (no division).

    Returns (acc [Rb, Cb, s, s, C] f32, cnt [Rb, Cb, 1, 1, 1] f32) with
    Rb = n_rows - 1 + k.  Sums are f32 whatever the input's dtype (the
    tile probabilities may arrive in bf16)."""
    N, T, T2, C = tile_probs.shape
    if T != tile_size or T2 != tile_size or N != n_rows * n_cols:
        raise ValueError(f"tile_probs {tuple(tile_probs.shape)} do not "
                         f"fit a {n_rows}x{n_cols} grid of {tile_size} px")
    k = tile_size // stride
    s = stride
    Rb, Cb = n_rows - 1 + k, n_cols - 1 + k
    t = tile_probs.reshape(n_rows, n_cols, k, s, k, s, C)
    acc = torch.zeros((Rb, Cb, s, s, C), dtype=torch.float32,
                      device=tile_probs.device)
    cnt = torch.zeros((Rb, Cb, 1, 1, 1), dtype=torch.float32,
                      device=tile_probs.device)
    for a in range(k):
        for b in range(k):
            acc[a:a + n_rows, b:b + n_cols] += t[:, :, a, :, b].float()
            cnt[a:a + n_rows, b:b + n_cols] += 1.0
    return acc, cnt


def blocks_to_canvas(acc: torch.Tensor) -> torch.Tensor:
    """[Rb, Cb, s, s, C] block space -> [Rb*s, Cb*s, C] canvas."""
    Rb, Cb, s, s2, C = acc.shape
    return acc.permute(0, 2, 1, 3, 4).reshape(Rb * s, Cb * s2, C)


def stitch_probs(tile_probs: torch.Tensor, n_rows: int, n_cols: int,
                 tile_size: int, stride: int) -> torch.Tensor:
    """Overlap-average [N, tile, tile, C] tile probabilities (grid order
    of ``unfold_tiles``) into an f32 canvas [H, W, C],
    H = (n_rows - 1) * stride + tile."""
    acc, cnt = accumulate_blocks(tile_probs, n_rows, n_cols, tile_size,
                                 stride)
    return blocks_to_canvas(acc / cnt)
