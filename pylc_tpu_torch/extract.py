"""Tile extraction: raw image/mask pairs -> tile DB.

Port of ``pylc_tpu/extract.py`` (reference utils/extract.py:25-330:
load -> scale -> optional grid fit -> unfold -> palette encode ->
coshuffle -> profile -> save).  Decoding is host work; each photo then
goes to the device once, is unfolded there (``ops/tiles.unfold_tiles``)
and comes back as uint8 NCHW tiles; each mask is decoded with
INTER_NEAREST, unfolded and palette-encoded on the device
(``ops/palette.class_encode``).

The extraction metadata (the ``extract`` dict with fid/n/w_full/...
/offset fields, utils/extract.py:161-171) is kept field for field,
because the stitcher and evaluator key off it.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from pylc_tpu_torch.config import Config
from pylc_tpu_torch.db.database import TileDB
from pylc_tpu_torch.device import resolve_device
from pylc_tpu_torch.ops.palette import class_encode
from pylc_tpu_torch.ops.profile import profile_tiles
from pylc_tpu_torch.ops.tiles import unfold_tiles
from pylc_tpu_torch.utils.imageio import adjust_to_tile, collate, get_image


class Extractor:
    """Extracts image/mask tile datasets from high-resolution images, on
    ``device`` (default ``cuda``; without a card this raises unless the
    caller passes ``"cpu"``)."""

    def __init__(self, cfg: Config,
                 device: Union[str, torch.device, None] = None):
        self.cfg = cfg
        self.device = resolve_device(str(device or "cuda"))
        self.reset()

    def reset(self):
        self.files: List = []
        self.imgs: List[np.ndarray] = []
        self.masks: List[np.ndarray] = []
        self.mask_path: Optional[str] = None
        self.extract_meta: Optional[Dict] = None
        self.meta = self.cfg.replace(id="_db_pylc_{}_{}".format(
            self.cfg.ch_label, int(time.time())))
        return self

    def load(self, img_path: str, mask_path: Optional[str] = None):
        self.reset()
        self.files = collate(img_path, mask_path)
        if not self.files:
            raise FileNotFoundError("File list is empty. Extraction stopped.")
        self.mask_path = mask_path
        return self

    # ------------------------------------------------------------------ #

    def _unfold(self, img: np.ndarray, stride: int) -> torch.Tensor:
        """One upload and a device unfold -> [N, tile, tile, C] uint8."""
        t = torch.from_numpy(np.ascontiguousarray(img)).to(self.device)
        return unfold_tiles(t, self.cfg.tile_size, stride)

    def _tile_image(self, img: np.ndarray, stride: int) -> np.ndarray:
        """[H, W(, C)] photo -> [N, C, tile, tile] uint8 tiles."""
        if img.ndim == 2:
            img = img[..., None]
        # stored NCHW in the DB for format parity with the reference
        return self._unfold(img, stride).permute(0, 3, 1, 2).cpu().numpy()

    def _encode_mask(self, mask: np.ndarray, stride: int) -> np.ndarray:
        """[H, W, 3] RGB mask -> [N, tile, tile] uint8 class tiles."""
        tiles = self._unfold(mask, stride)
        return class_encode(tiles, self.meta.palette_rgb).cpu().numpy()

    def extract(self, fit: bool = False, stride: Optional[int] = None,
                scale: Optional[float] = None, verbose: bool = True):
        import cv2

        cfg = self.meta
        stride = stride or cfg.stride
        scales = [scale] if scale else cfg.scales
        self.meta = cfg.replace(stride=stride, scales=scales)

        for sc in scales:
            for fpair in self.files:
                if isinstance(fpair, dict):
                    img_path, mask_path = fpair["img"], fpair["mask"]
                else:
                    img_path, mask_path = fpair, None

                img, w_full, h_full, w_scaled, h_scaled = get_image(
                    img_path, self.meta.ch, scale=sc,
                    tile_size=self.meta.tile_size)
                if fit:
                    img, w_fit, h_fit, offset = adjust_to_tile(
                        img, self.meta.tile_size, stride)
                else:
                    w_fit, h_fit, offset = w_scaled, h_scaled, 0

                img_tiles = self._tile_image(img, stride)
                n_tiles = len(img_tiles)
                self.imgs.append(img_tiles)

                self.extract_meta = {
                    "fid": os.path.basename(img_path.replace(".", "_")) +
                           "_scale_" + str(sc),
                    "n": n_tiles,
                    "w_full": w_full, "h_full": h_full,
                    "w_scaled": w_scaled, "h_scaled": h_scaled,
                    "w_fitted": w_fit, "h_fitted": h_fit,
                    "offset": offset,
                }
                if verbose:
                    print(f"  {os.path.basename(img_path)}: "
                          f"{w_full}x{h_full} -> fit {w_fit}x{h_fit}, "
                          f"{n_tiles} tiles")

                if mask_path:
                    mask, _, _, wsm, hsm = get_image(
                        mask_path, 3, scale=sc,
                        tile_size=self.meta.tile_size,
                        interpolate=cv2.INTER_NEAREST)
                    if (wsm, hsm) != (w_scaled, h_scaled):
                        raise ValueError(
                            f"Dimensions do not match:\n\tImage {img_path}"
                            f"\n\tMask {mask_path}.")
                    if fit:
                        mask, _, _, _ = adjust_to_tile(
                            mask, self.meta.tile_size, stride,
                            interpolate=cv2.INTER_NEAREST)
                    self.masks.append(self._encode_mask(mask, stride))

        self.meta.extract = self.extract_meta
        self.meta.n_tiles = sum(len(t) for t in self.imgs)
        return self

    # ------------------------------------------------------------------ #

    def coshuffle(self, seed: int = 0):
        imgs = np.concatenate(self.imgs)
        perm = np.random.default_rng(seed).permutation(len(imgs))
        self.imgs = [imgs[perm]]
        if self.masks:  # mask-less extraction (inference-only DB)
            self.masks = [np.concatenate(self.masks)[perm]]
        return self

    def profile(self, chunk: int = 256):
        if not self.masks:
            # class statistics need labels; mask-less extraction keeps
            # whatever stats the config already carries
            return self
        imgs = np.concatenate(self.imgs)
        masks = np.concatenate(self.masks)
        chunks = ((imgs[i:i + chunk], masks[i:i + chunk])
                  for i in range(0, len(imgs), chunk))
        prof = profile_tiles(chunks, self.meta.n_classes,
                             self.meta.tile_size, self.device)
        self.meta = self.meta.replace(**prof)
        return self

    def get_data(self) -> TileDB:
        data = {"img": np.concatenate(self.imgs),
                "mask": np.concatenate(self.masks) if self.masks
                        else np.zeros((0,), np.uint8),
                "meta": self.meta}
        return TileDB(data=data)

    def save(self, out_dir: Optional[str] = None) -> str:
        out_dir = out_dir or self.meta.db_dir
        path = os.path.join(out_dir, self.meta.id + ".h5")
        imgs = np.concatenate(self.imgs)
        masks = np.concatenate(self.masks) if self.masks else \
            np.zeros((0,), np.uint8)
        return TileDB.save(path, imgs, masks, self.meta)
