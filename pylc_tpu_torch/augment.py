"""Threshold-optimized oversampling augmentation, DB merge and grayscale.

Port of ``pylc_tpu/augment.py`` (reference utils/augment.py:92-239,
Rose 2020):

  optimize():  per-tile oversampling scores from the class-probability
      profile; grid search over (rate_coef x threshold) minimizing the
      Jensen-Shannon divergence of the oversampled pixel distribution
      from uniform, under the aug_n_samples_ratio budget.  Host numpy,
      the JAX package's code as it is.
  oversample(): apply per-tile integer rates; each oversampled copy gets
      a random perspective + brightness distortion, in device batches
      (``ops/augment_ops.py``), drawn from one ``np.random.Generator`` in
      the JAX package's order; the same generator then co-shuffles.
  merge_dbs():  concatenate and co-shuffle several DBs (the reference's
      merge_dbs is a dead stub, utils/augment.py:241-290).
  grayscale_db(): the channel mean of a colour DB.

Each profile runs on ``device`` (default ``cuda``; without a card this
raises unless the caller passes ``"cpu"``).  ``Augmentor.load`` takes an
``.h5`` path or a ``TileDB`` (an in-memory one needs no h5py);
``merge_dbs`` and ``grayscale_db`` read and write ``.h5`` files.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from pylc_tpu_torch.config import Config
from pylc_tpu_torch.db.database import TileDB
from pylc_tpu_torch.device import resolve_device
from pylc_tpu_torch.ops.augment_ops import augment_batch
from pylc_tpu_torch.ops.profile import profile_tiles
from pylc_tpu_torch.utils.balance import jsd, m2


class Augmentor:
    """Class-balancing oversampler for a tile DB."""

    def __init__(self, cfg: Optional[Config] = None,
                 device: Union[str, torch.device, None] = None):
        self.cfg = cfg or Config()
        self.device = resolve_device(str(device or "cuda"))
        self.db: Optional[TileDB] = None
        self.meta: Optional[Config] = None
        self.rates: Optional[np.ndarray] = None
        self.optim_meta: Optional[Dict] = None

    def load(self, db: Union[str, TileDB]):
        """An ``.h5`` path, or a ``TileDB`` (on disk or in memory)."""
        self.db = db if isinstance(db, TileDB) else TileDB(db)
        self.meta = self.db.get_meta(base=self.cfg)
        return self

    # ------------------------------------------------------------------ #

    def optimize(self) -> "Augmentor":
        """Grid-search (rate_coef, threshold) minimizing JSD-from-uniform
        (reference utils/augment.py:92-182, exact math)."""
        m = self.meta
        eps = 1e-8
        px_dist = np.asarray(m.px_dist, dtype=np.int64)
        px_count = m.tile_px_count
        dset_probs = np.asarray(m.probs, dtype=np.float32) + eps
        n_classes = m.n_classes
        n_samples = len(px_dist)

        oversample_filter = np.clip(1 / n_classes - dset_probs, 0, 1.0)
        probs = px_dist / px_count
        probs_weighted = probs * (1 / dset_probs) * oversample_filter
        scores = np.sqrt(np.sum(probs_weighted, axis=1))

        rate_coefs = np.arange(m.aug_rate_coef_range[0],
                               m.aug_rate_coef_range[1], 1.0)
        thresholds = np.arange(m.aug_threshold_range[0],
                               m.aug_threshold_range[1], 0.05)
        balanced = np.full(n_classes, 1 / n_classes)
        budget = int(m.aug_n_samples_ratio * n_samples)

        best = None
        for rate_coef in rate_coefs:
            assert rate_coef >= 1, "Rate coefficient must be >= 1."
            for threshold in thresholds:
                rates = ((scores > threshold) * rate_coef * scores
                         ).astype(int)
                rates = np.clip(rates, m.aug_oversample_rate_range[0],
                                m.aug_oversample_rate_range[1])
                if np.sum(rates) >= budget:
                    continue
                full_px_dist = px_dist + rates[:, None] * px_dist
                full_probs = np.sum(full_px_dist, axis=0) / \
                    np.sum(full_px_dist)
                jsd_v = jsd(full_probs, balanced)
                if best is None or jsd_v < best["jsd"]:
                    best = {
                        "probs": full_probs,
                        "threshold": float(threshold),
                        "rate_coef": float(rate_coef),
                        "rates": rates,
                        "n_samples": int(np.sum(full_px_dist) / px_count),
                        "aug_n_samples": int(np.sum(rates)),
                        "jsd": float(jsd_v),
                        "m2": float(m2(full_probs, n_classes)),
                    }
        assert best is not None, "No augmentation optimization found."
        self.optim_meta = best
        self.rates = best["rates"]
        return self

    def oversample(self, seed: int = 0, device_batch: int = 64,
                   chunk: int = 512) -> "Augmentor":
        """Materialize originals + rate-weighted distorted copies."""
        assert self.rates is not None, "Call optimize() first."
        rng = np.random.default_rng(seed)
        out_imgs: List[np.ndarray] = []
        out_masks: List[np.ndarray] = []

        pos = 0
        for imgs, masks in self.db.iter_chunks(chunk):
            n = len(imgs)
            rates = self.rates[pos:pos + n]
            pos += n
            # originals (keep DB's NCHW layout)
            out_imgs.append(imgs)
            out_masks.append(masks)
            # oversampled copies: repeated index vector -> device batches
            rep_idx = np.repeat(np.arange(n), rates)
            for s in range(0, len(rep_idx), device_batch):
                sel = rep_idx[s:s + device_batch]
                aug_i, aug_m = augment_batch(imgs[sel], masks[sel], rng,
                                             self.device)
                out_imgs.append(aug_i)
                out_masks.append(aug_m)

        imgs = np.concatenate(out_imgs)
        masks = np.concatenate(out_masks)
        perm = rng.permutation(len(imgs))
        self.out_imgs, self.out_masks = imgs[perm], masks[perm]

        prof = profile_tiles(
            ((self.out_imgs[i:i + chunk], self.out_masks[i:i + chunk])
             for i in range(0, len(self.out_imgs), chunk)),
            self.meta.n_classes, self.meta.tile_size, self.device)
        self.meta = self.meta.replace(**prof)
        self.meta.id = "_aug" + (self.meta.id or "")
        return self

    def get_data(self) -> TileDB:
        return TileDB(data={"img": self.out_imgs, "mask": self.out_masks,
                            "meta": self.meta})

    def save(self, out_dir: Optional[str] = None) -> str:
        out_dir = out_dir or self.meta.db_dir
        path = os.path.join(out_dir, self.meta.id + ".h5")
        return TileDB.save(path, self.out_imgs, self.out_masks, self.meta)


def merge_dbs(db_paths: List[str], out_path: str,
              cfg: Optional[Config] = None, seed: int = 0,
              device: Union[str, torch.device, None] = None) -> str:
    """Concatenate + co-shuffle multiple tile DBs into one
    (implements the reference's stubbed merge mode,
    utils/augment.py:241-290 / preprocess.py:94-107)."""
    device = resolve_device(str(device or "cuda"))
    imgs, masks = [], []
    meta = None
    for p in db_paths:
        db = TileDB(p)
        m = db.get_meta(base=cfg)
        if meta is None:
            meta = m
        else:
            # incompatible DBs would silently produce a corrupt merge
            # stamped with the first DB's meta
            for field in ("ch", "tile_size", "schema", "n_classes"):
                a, b = getattr(meta, field), getattr(m, field)
                if a != b:
                    raise ValueError(
                        f"Cannot merge {p}: {field}={b!r} differs from "
                        f"{db_paths[0]}'s {field}={a!r}.")
        for im, mk in db.iter_chunks(1024):
            imgs.append(im)
            masks.append(mk)
    imgs = np.concatenate(imgs)
    masks = np.concatenate(masks)
    perm = np.random.default_rng(seed).permutation(len(imgs))
    imgs, masks = imgs[perm], masks[perm]
    prof = profile_tiles(
        ((imgs[i:i + 512], masks[i:i + 512])
         for i in range(0, len(imgs), 512)),
        meta.n_classes, meta.tile_size, device)
    meta = meta.replace(**prof)
    meta.id = "_merged_" + "_".join(
        [str(len(db_paths)), str(len(imgs))])
    return TileDB.save(out_path, imgs, masks, meta)


def grayscale_db(db_path: str, out_path: str,
                 cfg: Optional[Config] = None,
                 device: Union[str, torch.device, None] = None) -> str:
    """Convert a colour tile DB to grayscale (the channel mean in f32,
    truncated to uint8) — implements the reference's dead 'grayscale'
    mode (preprocess.py:110-119, utils/augment.py:292-346)."""
    device = resolve_device(str(device or "cuda"))
    db = TileDB(db_path)
    meta = db.get_meta(base=cfg)
    imgs, masks = [], []
    for im, mk in db.iter_chunks(1024):
        if im.shape[1] != 3:
            raise ValueError("Grayscaling requires a 3-channel DB.")
        gray = np.mean(im.astype(np.float32), axis=1, keepdims=True)
        imgs.append(gray.astype(np.uint8))
        masks.append(mk)
    imgs = np.concatenate(imgs)
    masks = np.concatenate(masks)
    meta.ch = 1
    prof = profile_tiles(
        ((imgs[i:i + 512], masks[i:i + 512])
         for i in range(0, len(imgs), 512)),
        meta.n_classes, meta.tile_size, device)
    meta = meta.replace(**prof)
    meta.id = "_gs" + (meta.id or "")
    return TileDB.save(out_path, imgs, masks, meta)
