"""Host-side image IO: decode, scale, tile-grid fit, file collation.

Port of ``pylc_tpu/utils/imageio.py`` (which imports jax through its tile
module).  ``cv2`` is imported inside the functions that decode or
resize, so the package imports without it.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Union

import numpy as np

from pylc_tpu_torch.ops.tiles import adjust_to_tile_dims

IMG_EXTS = (".tif", ".tiff", ".jpg", ".jpeg")
MASK_EXTS = (".png",)


def is_grayscale(img: np.ndarray) -> bool:
    return bool(np.array_equal(img[..., 0], img[..., 1]) and
                np.array_equal(img[..., 0], img[..., 2]))


def get_image(img_path: str, ch: int = 3, scale: Optional[float] = None,
              tile_size: int = 512, interpolate: Optional[int] = None):
    """Load an image as uint8, optionally scaled (``interpolate`` is a cv2
    flag, INTER_AREA by default).

    Returns (img, w, h, w_resized, h_resized); grayscale images come
    back as [H, W], colour as [H, W, 3] RGB."""
    import cv2

    if ch not in (1, 3):
        raise ValueError(f"Invalid number of input channels: {ch}.")
    if not os.path.exists(img_path):
        raise FileNotFoundError(f"Image path {img_path} does not exist.")
    probe = cv2.imread(img_path, cv2.IMREAD_COLOR)
    if probe is None:
        raise IOError(f"Could not decode image {img_path}.")
    if is_grayscale(probe) and ch == 3:
        raise ValueError(
            f"Input image {img_path} is grayscale but process expects "
            "colour (RGB).")
    if ch == 3:
        img = cv2.cvtColor(probe, cv2.COLOR_BGR2RGB)
    else:
        img = cv2.imread(img_path, cv2.IMREAD_GRAYSCALE)

    h, w = img.shape[:2]
    h_r, w_r = h, w
    if scale:
        min_dim = min(h, w)
        if min_dim < tile_size:
            scale = tile_size / min_dim  # clamp (reference tools.py:139-145)
        dim = (int(scale * w), int(scale * h))
        img = cv2.resize(img, dim, interpolation=cv2.INTER_AREA
                         if interpolate is None else interpolate)
        h_r, w_r = img.shape[:2]
    return img, w, h, w_r, h_r


def adjust_to_tile(img: np.ndarray, tile_size: int, stride: int,
                   interpolate: Optional[int] = None):
    """Resize+crop an image to the tile grid.

    Returns (img, w_fitted, h_fitted, h_crop)."""
    import cv2

    h, w = img.shape[:2]
    w_fit, h_fit, h_crop = adjust_to_tile_dims(w, h, tile_size, stride)
    img = cv2.resize(img, (w_fit, h_fit + h_crop), interpolation=cv2.INTER_AREA
                     if interpolate is None else interpolate)
    return img[h_crop:], w_fit, h_fit, h_crop


def load_files(path: str, exts) -> List[str]:
    if not os.path.exists(path):
        raise FileNotFoundError(f"File not found: {path}")
    if os.path.isfile(path):
        ext = os.path.splitext(path)[1]
        if ext not in exts:
            raise ValueError(f"File {path} of type {ext} is invalid.")
        return [path]
    return sorted(os.path.join(path, f) for f in os.listdir(path)
                  if any(f.endswith(e) for e in exts))


def collate(img_dir: str, mask_dir: Optional[str] = None
            ) -> List[Union[str, Dict[str, str]]]:
    """Pair images with masks by basename; with no mask dir, return the
    image list."""
    img_files = load_files(img_dir, IMG_EXTS)
    if not mask_dir:
        return img_files
    mask_files = load_files(mask_dir, MASK_EXTS)
    masks = {os.path.splitext(os.path.basename(f))[0]: f for f in mask_files}
    pairs = []
    for f in img_files:
        stem = os.path.splitext(os.path.basename(f))[0]
        if stem not in masks:
            raise FileNotFoundError(f"Mask not found for image {stem}.")
        pairs.append({"img": f, "mask": masks[stem]})
    used = {os.path.splitext(os.path.basename(p["img"]))[0] for p in pairs}
    unused = [v for k, v in masks.items() if k not in used]
    if unused:
        raise FileNotFoundError(
            "Image not found for mask(s): " + ", ".join(unused))
    return pairs
