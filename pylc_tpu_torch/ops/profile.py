"""Dataset statistical profiler: per-tile statistics on the device, the
dataset's on the host.

Port of ``pylc_tpu/ops/profile.py``.  Each chunk of tiles goes to the
device once, for its per-tile class histograms, channel means and
channel standard deviations; the rest (pixel mean and std, class
probabilities and weights, M2, JSD) is the JAX package's host numpy,
copied as it is, so that the whole profile equals the JAX package's
bit for bit wherever the per-tile statistics do.

Semantics (vs reference utils/profile.py:21-150):
  - px_mean / px_std are the *mean of per-tile means / per-tile stds*
    (the reference accumulates torch.mean/std per sample then divides by
    n_samples — not a global pixel std), and the per-tile std is the
    unbiased (n - 1) estimator, as torch.std's default.
  - A mask value of ``n_classes`` or more is counted in no class (the
    JAX function's one-hot gives it a zero row).
  - class weights = 1 / log(1.02 + probs), normalized by max
    (utils/profile.py:129-130).
  - m2 / jsd per utils/metrics.py:90-132.
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple, Union

import numpy as np
import torch

from pylc_tpu_torch.device import resolve_device
from pylc_tpu_torch.utils.balance import jsd as jsd_metric, m2 as m2_metric


def _profile_chunk(imgs: torch.Tensor, masks: torch.Tensor, n_classes: int,
                  channel_dim: int = 3
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Profile one chunk on its device.

    imgs: [N, H, W, C] (``channel_dim`` 3) or [N, C, H, W] (1) uint8;
    masks: [N, H, W] uint8.  Returns (px_dist [N, n_classes] f32,
    tile_means [N, C] f32, tile_stds [N, C] f32)."""
    spatial = (1, 2) if channel_dim == 3 else (2, 3)
    x = imgs.float()
    tile_means = x.mean(dim=spatial)
    n = x.shape[spatial[0]] * x.shape[spatial[1]]
    var = x.var(dim=spatial, correction=0) * (n / (n - 1))
    tile_stds = torch.sqrt(var)
    N = masks.shape[0]
    m = masks.reshape(N, -1).int()
    # one bin per (tile, class), and one more for every value that is no
    # class, which is then dropped
    tile = torch.arange(N, dtype=torch.int32,
                        device=m.device)[:, None] * n_classes
    idx = torch.where(m < n_classes, tile + m, N * n_classes)
    counts = torch.bincount(idx.reshape(-1), minlength=N * n_classes + 1)
    px_dist = counts[:N * n_classes].reshape(N, n_classes).float()
    return px_dist, tile_means, tile_stds


def profile_tiles(chunks: Iterable[Tuple[np.ndarray, np.ndarray]],
                  n_classes: int, tile_size: int,
                  device: Union[str, torch.device, None] = None) -> Dict:
    """Profile an iterable of (img_chunk [N,H,W,C] or [N,C,H,W] uint8,
    mask_chunk [N,H,W] uint8) pairs on ``device`` (default ``cuda``;
    without a card this raises unless the caller passes ``"cpu"``).

    Returns a dict of metadata fields with the reference's names
    (px_dist, px_mean, px_std, dset_px_dist, dset_px_count, probs,
    weights, m2, jsd, n_samples, tile_px_count).
    """
    device = resolve_device(str(device or "cuda"))
    px_dists = []
    means = []
    stds = []
    n_samples = 0
    for imgs, masks in chunks:
        imgs = np.asarray(imgs)
        channel_dim = 3
        if imgs.ndim == 4 and imgs.shape[1] in (1, 3) and \
                imgs.shape[1] != imgs.shape[-1]:
            channel_dim = 1  # NCHW: reduced over (2, 3), not transposed
        d, m, s = _profile_chunk(
            torch.from_numpy(np.ascontiguousarray(imgs)).to(device),
            torch.from_numpy(np.ascontiguousarray(masks)).to(device),
            n_classes, channel_dim)
        px_dists.append(d.cpu().numpy())
        means.append(m.cpu().numpy())
        stds.append(s.cpu().numpy())
        n_samples += imgs.shape[0]

    px_dist = np.concatenate(px_dists, axis=0)
    px_mean = np.sum(np.concatenate(means, axis=0), axis=0) / n_samples
    px_std = np.sum(np.concatenate(stds, axis=0), axis=0) / n_samples

    dset_px_dist = np.sum(px_dist, axis=0)
    dset_px_count = float(np.sum(dset_px_dist))
    probs = dset_px_dist / dset_px_count

    weights = 1.0 / np.log(1.02 + probs)
    weights = weights / np.max(weights)

    balanced = np.full(n_classes, 1.0 / n_classes)

    return {
        "n_samples": int(n_samples),
        "px_mean": px_mean.tolist(),
        "px_std": px_std.tolist(),
        "px_dist": px_dist.tolist(),
        "tile_px_count": tile_size * tile_size,
        "dset_px_dist": dset_px_dist.tolist(),
        "dset_px_count": int(dset_px_count),
        "probs": probs.tolist(),
        "weights": weights.tolist(),
        "m2": float(m2_metric(probs, n_classes)),
        "jsd": float(jsd_metric(probs, balanced)),
    }
