"""Augmentation distortions on the device, a batch of tiles at a time.

Port of ``pylc_tpu/ops/augment_ops.py`` (reference utils/tools.py:452-594,
utils/augment.py:203-220).  The homographies and brightness shifts are
drawn on the host from one ``np.random.Generator``, in the JAX package's
order and with its code, so that both packages draw the same numbers at
a seed.  The warps run on the device: the image sampled bilinearly, the
mask by nearest, both with mirror borders, then the reference's 30 px
crop and resize back, then the +U(10, 20) brightness shift.

Tiles are NCHW here (the DB's layout), NHWC in the JAX package.  The
sampling follows ``jax.scipy.ndimage.map_coordinates`` step by step
rather than ``F.grid_sample``, whose nearest mode rounds half to even and
reflects the float coordinate before rounding, and whose normalized
coordinates move a sample by ~1e-5 px at 512:

  - order 1: floor and fraction; the four corners' products of weights
    summed in JAX's order;
  - order 0: round half away from zero;
  - mirror: each integer index i goes to |(i + s) mod 2s - s|, s = size - 1
    (reflection about the edge pixels' centres).

The source coordinates are explicit f32 multiply-adds, never a matmul,
which could run in TF32 on the card (the train step turns TF32 on for
bf16).  Resizing back: the image by half-pixel bilinear without
antialias (``jax.image.resize`` "linear" upsamples, where its antialias
changes nothing); the mask by ``floor((i + 0.5) * m / n)`` in f32, as
``jax.image.resize`` "nearest" computes it.
"""

from __future__ import annotations

from typing import Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

# The reference's fixed source quad (utils/tools.py:582) for a 512 tile.
REF_PTS1 = np.float32([[56, 65], [368, 52], [28, 387], [389, 390]])


def solve_homography(pts_src: np.ndarray, pts_dst: np.ndarray) -> np.ndarray:
    """3x3 perspective transform mapping src -> dst (host, 8x8 solve)."""
    A = []
    b = []
    for (x, y), (u, v) in zip(pts_src, pts_dst):
        A.append([x, y, 1, 0, 0, 0, -u * x, -u * y]); b.append(u)
        A.append([0, 0, 0, x, y, 1, -v * x, -v * y]); b.append(v)
    h = np.linalg.solve(np.asarray(A, np.float64), np.asarray(b, np.float64))
    return np.concatenate([h, [1.0]]).reshape(3, 3).astype(np.float32)


def random_homographies(rng: np.random.Generator, n: int, size: int,
                        alpha_frac: float = 0.06) -> np.ndarray:
    """n inverse homographies for warping ``size``-px tiles, with the
    reference's perturbation model: dst = src + U(-alpha, alpha),
    alpha = 0.06 * size (utils/tools.py:578-584)."""
    pts1 = REF_PTS1 * (size / 512.0)
    alpha = alpha_frac * size
    out = np.empty((n, 3, 3), np.float32)
    for i in range(n):
        pts2 = pts1 + rng.uniform(-alpha, alpha, pts1.shape).astype(np.float32)
        # warp samples with the inverse map (dst pixel -> src coordinate)
        out[i] = np.linalg.inv(solve_homography(pts1, pts2)).astype(np.float32)
    return out


def warp_coords(h_inv: torch.Tensor, size: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Source coordinates (sy, sx), each [N, size * size] f32, of every
    destination pixel (row-major) under ``h_inv`` [N, 3, 3] f32."""
    ys, xs = torch.meshgrid(
        torch.arange(size, dtype=torch.float32, device=h_inv.device),
        torch.arange(size, dtype=torch.float32, device=h_inv.device),
        indexing="ij")
    x, y = xs.reshape(1, -1), ys.reshape(1, -1)
    h = h_inv[:, :, :, None]                           # [N, 3, 3, 1]
    src = [h[:, r, 0] * x + h[:, r, 1] * y + h[:, r, 2] for r in range(3)]
    return src[1] / src[2], src[0] / src[2]


def _mirror(index: torch.Tensor, size: int) -> torch.Tensor:
    s = size - 1  # half-wavelength of the triangular wave
    return torch.abs(torch.remainder(index + s, 2 * s) - s)


def _round_half_away_from_zero(x: torch.Tensor) -> torch.Tensor:
    t = torch.trunc(x)
    f = x - t  # exact
    return t + (f >= 0.5).to(x.dtype) - (f <= -0.5).to(x.dtype)


def _gather(flat: torch.Tensor, iy: torch.Tensor, ix: torch.Tensor,
            W: int) -> torch.Tensor:
    """flat [N, C, H * W] at pixels (iy, ix) [N, P] -> [N, C, P]."""
    idx = (iy * W + ix)[:, None, :].expand(-1, flat.shape[1], -1)
    return torch.gather(flat, 2, idx)


def sample_linear(img: torch.Tensor, sy: torch.Tensor, sx: torch.Tensor
                  ) -> torch.Tensor:
    """``map_coordinates(order=1, mode="mirror")`` per channel: img
    [N, C, H, W] f32 at (sy, sx) [N, P] -> [N, C, P] f32."""
    N, C, H, W = img.shape
    flat = img.reshape(N, C, H * W)
    nodes = []
    for coord, size in ((sy, H), (sx, W)):
        lower = torch.floor(coord)
        upper_w = coord - lower
        index = lower.long()
        nodes.append([(_mirror(index, size), 1 - upper_w),
                      (_mirror(index + 1, size), upper_w)])
    out = None
    for iy, wy in nodes[0]:
        for ix, wx in nodes[1]:
            term = (wy * wx)[:, None, :] * _gather(flat, iy, ix, W)
            out = term if out is None else out + term
    return out


def sample_nearest(img: torch.Tensor, sy: torch.Tensor, sx: torch.Tensor
                   ) -> torch.Tensor:
    """``map_coordinates(order=0, mode="mirror")``: img [N, C, H, W] at
    (sy, sx) [N, P] -> [N, C, P], same dtype."""
    N, C, H, W = img.shape
    iy = _mirror(_round_half_away_from_zero(sy).long(), H)
    ix = _mirror(_round_half_away_from_zero(sx).long(), W)
    return _gather(img.reshape(N, C, H * W), iy, ix, W)


def resize_nearest_index(m: int, n: int, device) -> torch.Tensor:
    """Source index of each of ``n`` outputs resized from ``m``, as
    ``jax.image.resize`` "nearest": floor((i + 0.5) * m / n) in f32."""
    i = torch.arange(n, dtype=torch.float32, device=device)
    return torch.floor((i + 0.5) * m / n).long()


def warp_tiles(imgs: torch.Tensor, masks: torch.Tensor, h_inv: torch.Tensor,
               crop: int = 30) -> Tuple[torch.Tensor, torch.Tensor]:
    """Perspective-warp a batch of tiles and masks on their device.

    imgs: [N, C, H, W] uint8; masks: [N, H, W] uint8; h_inv: [N, 3, 3]
    inverse homographies (f32).  Warps, crops ``crop`` px borders
    (at most (size - 2) // 2) and resizes back (image bilinear, mask
    nearest).  Returns (imgs [N, C, H, W] f32, masks [N, H, W] f32), as
    the JAX function returns them.
    """
    N, C, H, W = imgs.shape
    size = H
    crop = min(crop, (size - 2) // 2)
    sy, sx = warp_coords(h_inv.float(), size)
    img_w = sample_linear(imgs.float(), sy, sx).reshape(N, C, size, size)
    mask_w = sample_nearest(masks.float()[:, None], sy, sx
                            ).reshape(N, size, size)
    lo, hi = crop, size - crop
    img_r = F.interpolate(img_w[:, :, lo:hi, lo:hi], size=(size, size),
                          mode="bilinear", align_corners=False,
                          antialias=False)
    idx = resize_nearest_index(hi - lo, size, imgs.device) + lo
    mask_r = mask_w[:, idx][:, :, idx]
    return img_r, mask_r


def channel_shift(imgs: torch.Tensor, shifts: torch.Tensor) -> torch.Tensor:
    """Add a per-tile brightness shift to uint8 tiles [N, ...], clip to
    [0, 255] (reference utils/tools.py:533-554)."""
    shape = (-1,) + (1,) * (imgs.dim() - 1)
    x = imgs.to(torch.int32) + shifts.to(torch.int32).reshape(shape)
    return torch.clamp(x, 0, 255).to(torch.uint8)


def augment_batch(imgs_u8: np.ndarray, masks_u8: np.ndarray,
                  rng: np.random.Generator,
                  device: Union[str, torch.device]
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Full distortion pipeline for a batch of NCHW uint8 tiles on
    ``device``: perspective shift then brightness shift (reference
    augment_transform, utils/tools.py:452-493).  Draws the homographies,
    then the shifts, from ``rng``."""
    n, size = imgs_u8.shape[0], imgs_u8.shape[2]
    h_inv = random_homographies(rng, n, size)
    shifts = rng.integers(10, 20, size=n)
    crop = max(1, round(size * 30 / 512))  # reference's 30px at 512
    img_w, mask_w = warp_tiles(
        torch.from_numpy(np.ascontiguousarray(imgs_u8)).to(device),
        torch.from_numpy(np.ascontiguousarray(masks_u8)).to(device),
        torch.from_numpy(h_inv).to(device), crop)
    # clip, then truncate to uint8, as the JAX cast does
    img_w = torch.clamp(img_w, 0, 255).to(torch.uint8)
    img_w = channel_shift(img_w, torch.from_numpy(shifts).to(device))
    return img_w.cpu().numpy(), mask_w.to(torch.uint8).cpu().numpy()
