"""Synthetic textured segmentation scenes: seeded photos with exact labels.

A copy of ``pylc_tpu/utils/synthetic.py`` (numpy only), so that the port
needs nothing of the JAX package; ``tests/test_torch_config.py`` holds
the two equal.  ``textured_scene`` draws curved class boundaries,
per-class textured interiors (multi-octave value noise) and a vertical
illumination gradient, so the photo's colour statistics look like
landscape photography while the ground truth stays exact.
``chip_smoke.py`` makes its archive-size photo and mask pairs with it.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def value_noise(H: int, W: int, rng: np.random.Generator,
                octaves: Tuple[int, ...] = (4, 8, 16, 32),
                amp_decay: float = 0.6) -> np.ndarray:
    """Multi-octave value noise in [-1, 1], shape [H, W].

    Coarse random grids bilinearly upsampled and summed — band-limited
    structure at several scales, the cheap stand-in for natural texture.
    """
    out = np.zeros((H, W), np.float32)
    amp = 1.0
    for cells in octaves:
        gh, gw = cells + 1, cells + 1
        grid = rng.standard_normal((gh, gw)).astype(np.float32)
        ys = np.linspace(0, cells, H, endpoint=False)
        xs = np.linspace(0, cells, W, endpoint=False)
        y0 = np.floor(ys).astype(np.int32)
        x0 = np.floor(xs).astype(np.int32)
        fy = (ys - y0)[:, None]
        fx = (xs - x0)[None, :]
        g00 = grid[y0][:, x0]
        g01 = grid[y0][:, x0 + 1]
        g10 = grid[y0 + 1][:, x0]
        g11 = grid[y0 + 1][:, x0 + 1]
        layer = (g00 * (1 - fy) * (1 - fx) + g01 * (1 - fy) * fx +
                 g10 * fy * (1 - fx) + g11 * fy * fx)
        out += amp * layer
        amp *= amp_decay
    m = np.abs(out).max()
    return out / (m + 1e-9)


def textured_scene(H: int, W: int, n_classes: int,
                   rng: np.random.Generator,
                   flip: float = 0.15, logit_noise: float = 0.7,
                   texture_amp: float = 28.0,
                   illumination: float = 35.0):
    """Generate (true_labels, guide_rgb, noisy_probs).

    - true: [H, W] int32 — voronoi patches with noise-warped (curved)
      boundaries, one of ``n_classes`` labels per patch.
    - guide: [H, W, 3] uint8 — per-class base colour + shared
      multi-octave texture + vertical illumination gradient.  Boundaries
      are guide-correlated (colour changes at label edges) but interiors
      carry realistic variance, so a CRF cannot win by flat-region
      averaging alone.
    - probs: [H, W, n_classes] float32 — softmax of one-hot logits with
      ``flip`` fraction of label flips and iid logit noise, the
      stand-in for a noisy network posterior.
    """
    n_pts = max(n_classes * 3, 8)
    pts = rng.integers(0, [H, W], size=(n_pts, 2))
    lbl = rng.integers(0, n_classes, size=(n_pts,))
    # warp the distance field with low-frequency noise -> curved borders
    wy = value_noise(H, W, rng, octaves=(3, 6)) * (0.08 * H)
    wx = value_noise(H, W, rng, octaves=(3, 6)) * (0.08 * W)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    yw, xw = yy + wy, xx + wx
    d = ((yw[..., None] - pts[:, 0]) ** 2 +
         (xw[..., None] - pts[:, 1]) ** 2)
    true = lbl[np.argmin(d, axis=-1)].astype(np.int32)

    colors = rng.integers(40, 230, size=(n_classes, 3)).astype(np.float32)
    guide = colors[true]
    # per-channel texture, correlated across channels (one luminance
    # field + a weaker chroma field) — like natural imagery
    lum = value_noise(H, W, rng)[..., None]
    chroma = np.stack([value_noise(H, W, rng) for _ in range(3)], axis=-1)
    guide = guide + texture_amp * (0.75 * lum + 0.25 * chroma)
    # vertical illumination gradient (sky bright, ground dark)
    guide = guide + illumination * np.linspace(
        1, -1, H, dtype=np.float32)[:, None, None]
    guide = np.clip(guide + rng.normal(0, 5, guide.shape), 0,
                    255).astype(np.uint8)

    flips = rng.random((H, W)) < flip
    rand_lbl = rng.integers(0, n_classes, size=(H, W))
    noisy_lbl = np.where(flips, rand_lbl, true)
    logits = np.eye(n_classes, dtype=np.float32)[noisy_lbl] * 2.0
    logits += rng.normal(0, logit_noise, logits.shape).astype(np.float32)
    e = np.exp(logits - logits.max(-1, keepdims=True))
    probs = e / e.sum(-1, keepdims=True)
    return true, guide, probs


def miou(pred: np.ndarray, true: np.ndarray, n_classes: int) -> float:
    ious = []
    for c in range(n_classes):
        inter = np.sum((pred == c) & (true == c))
        union = np.sum((pred == c) | (true == c))
        if union:
            ious.append(inter / union)
    return float(np.mean(ious))
