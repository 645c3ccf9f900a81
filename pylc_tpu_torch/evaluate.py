"""Evaluation: the JAX package's ``Evaluator``, loading masks through the
port's image IO (the base class's ``load`` imports the JAX package's
``imageio``, which imports jax)."""

from __future__ import annotations

from typing import Optional

import numpy as np

from pylc_tpu import evaluate as _reference
from pylc_tpu import native
from pylc_tpu_torch.utils.imageio import get_image


class Evaluator(_reference.Evaluator):

    def load(self, mask_pred_rgb: np.ndarray, fid: str,
             mask_true_path: Optional[str] = None,
             scale: Optional[float] = None):
        """Load a predicted RGB mask (+ optional ground truth path)."""
        import cv2

        self.fid = fid
        self.mask_pred = mask_pred_rgb
        if mask_true_path:
            mask_true, _, _, _, _ = get_image(
                mask_true_path, ch=3, scale=scale,
                tile_size=self.cfg.tile_size,
                interpolate=cv2.INTER_NEAREST)
            if mask_true.shape[:2] != mask_pred_rgb.shape[:2]:
                raise ValueError(
                    f"Ground truth dims {mask_true.shape[:2]} do not match "
                    f"predicted dims {mask_pred_rgb.shape[:2]}.")
            pal = np.asarray(self.cfg.palette_rgb, np.uint8)
            self.y_pred = native.class_encode(mask_pred_rgb, pal).ravel()
            self.y_true = native.class_encode(mask_true, pal).ravel()
            if self.keep_aggregate:
                self.y_true_aggregate.append(self.y_true)
                self.y_pred_aggregate.append(self.y_pred)
        return self
