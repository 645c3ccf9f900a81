"""Input normalization.  Port of ``pylc_tpu/ops/normalize.py``.

The reference's arithmetic, quirks included, because published
checkpoints were trained against it:

  - grayscale, profile stats:  ((x - mean(px_mean)) / mean(px_std)) / 255
  - grayscale, defaults:        (x - 142.01) / 23.66          (NO /255)
  - colour, either stats:      ((x - px_mean) / px_std) / 255
"""

from __future__ import annotations

import numpy as np
import torch


def normalize_image(img: torch.Tensor, px_mean, px_std, ch: int,
                    default: bool = False,
                    gs_default=(142.01, 23.66)) -> torch.Tensor:
    """Normalize an [N, H, W, C] image batch (uint8 or float) -> f32."""
    x = img.float()
    if ch == 1:
        if default:
            return (x - gs_default[0]) / gs_default[1]
        mean = float(np.mean(px_mean))
        std = float(np.mean(px_std))
        return ((x - mean) / std) / 255.0
    mean = torch.tensor(np.asarray(px_mean, np.float32), device=x.device)
    std = torch.tensor(np.asarray(px_std, np.float32), device=x.device)
    return ((x - mean) / std) / 255.0
