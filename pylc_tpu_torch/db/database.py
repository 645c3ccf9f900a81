"""Tile database: an HDF5 file or in-memory arrays.

Port of ``pylc_tpu/db/database.py`` with the same file layout (gzip-
chunked ``img`` [N, C, tile, tile] and ``mask`` [N, tile, tile] uint8
datasets and a JSON ``meta`` attribute), partition math (ceil indices),
shard ranges and chunk order.  ``h5py`` is imported only inside the HDF5
branches, so the in-memory form (``data=``) works on a host without it.
"""

from __future__ import annotations

import json
import math
import os
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from pylc_tpu_torch.config import DATA_META_FIELDS, Config


class TileDB:
    """Read/write wrapper over the .h5 tile DB.

    partition: fractional (start, end) of the dataset, with ceil-index
    semantics matching reference db/database.py:89-91 so train/valid
    splits land on identical sample indices.
    """

    def __init__(self, path: Optional[str] = None,
                 data: Optional[Dict] = None,
                 partition: Tuple[float, float] = (0.0, 1.0),
                 clip: float = 1.0):
        if (path is None) == (data is None):
            raise ValueError("TileDB needs exactly one of path or in-memory "
                             "data.")
        self.path = path
        self.data = data
        self.partition = partition
        self.clip = clip
        self._warned_tail = False

        if data is not None:
            self.size = int(clip * len(data["img"]))
            self.img_shape = data["img"].shape
            self.mask_shape = data["mask"].shape
        else:
            if not os.path.exists(path):
                raise FileNotFoundError(f"Database path {path} does not exist.")
            import h5py
            with h5py.File(path, "r") as f:
                self.size = int(clip * len(f["img"]))
                self.img_shape = f["img"].shape
                self.mask_shape = f["mask"].shape

        self.start = int(math.ceil(partition[0] * self.size))
        self.end = int(math.ceil(partition[1] * self.size))
        self.partition_size = self.end - self.start

    # ------------------------------------------------------------------ #

    def get_meta(self, base: Optional[Config] = None,
                 data_only: bool = False) -> Config:
        """Metadata attribute -> Config (pure round-trip; the reference
        instead mutates the global singleton, db/database.py:164).

        data_only=True applies only DATA_META_FIELDS so DB metadata
        cannot override user-chosen network settings in ``base``."""
        fields = DATA_META_FIELDS if data_only else None
        if self.path:
            import h5py
            with h5py.File(self.path, "r") as f:
                attr = f.attrs.get("meta")
            return Config.from_meta_json(attr, base, fields)
        meta = self.data["meta"]
        if not isinstance(meta, dict):  # a config object, of either package
            return meta
        return Config.from_meta(meta, base, fields)

    def read_chunk(self, start: int, end: int
                   ) -> Tuple[np.ndarray, np.ndarray]:
        """Read samples [start, end) (absolute indices)."""
        if self.data is not None:
            return (np.asarray(self.data["img"][start:end]),
                    np.asarray(self.data["mask"][start:end]))
        import h5py
        with h5py.File(self.path, "r", libver="latest", swmr=True) as f:
            imgs = np.empty((end - start,) + self.img_shape[1:], np.uint8)
            masks = np.empty((end - start,) + self.mask_shape[1:], np.uint8)
            f["img"].read_direct(imgs, np.s_[start:end])
            f["mask"].read_direct(masks, np.s_[start:end])
        return imgs, masks

    def shard_range(self, shard: Tuple[int, int],
                    drop_tail: bool = True) -> Tuple[int, int]:
        """(lo, hi) rows of this partition owned by shard (k, n).

        drop_tail=True (default): BALANCED floor split — every shard
        gets exactly ``partition_size // n`` rows (the tail remainder
        is dropped for the epoch).  Equal per-shard sizes are
        load-bearing for multi-host SPMD training: a ceil split (the
        reference's per-worker range math, db/database.py:129-149)
        hands hosts different batch counts after drop_last and the
        uneven host exits mid-epoch while the others block in a
        collective.

        drop_tail=False: the remainder is distributed one row each to
        the first shards (sizes differ by at most 1, no row dropped) —
        for validation, where the eval loop pads short batches instead
        of requiring equal sizes and the best-dice gate must see every
        sample.
        """
        k, n = shard
        if n > 1 and not drop_tail:
            per, tail = divmod(self.partition_size, n)
            lo = self.start + k * per + min(k, tail)
            return lo, min(lo + per + (1 if k < tail else 0), self.end)
        per = self.partition_size // n if n > 1 else self.partition_size
        if n > 1:
            if per == 0:
                # every shard would be empty -> zero steps per epoch on
                # every host, a silent no-op training run
                raise ValueError(
                    f"partition of {self.partition_size} rows cannot be "
                    f"split over {n} hosts (floor share is 0); shrink the "
                    "host count or grow the dataset.")
            tail = self.partition_size - per * n
            if tail and k == 0 and not self._warned_tail:
                import warnings
                warnings.warn(
                    f"balanced {n}-way split drops the {tail}-row tail of "
                    f"the {self.partition_size}-row partition each epoch "
                    "(equal per-host sizes are required for SPMD).",
                    stacklevel=2)
                self._warned_tail = True
        lo = self.start + k * per
        return lo, min(lo + per, self.end)

    def iter_chunks(self, chunk_size: int = 1000,
                    shard: Tuple[int, int] = (0, 1),
                    drop_tail: bool = True,
                    rng: Optional[np.random.Generator] = None
                    ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Yield (img, mask) chunks over this partition (or this
        shard's slice of it, see :meth:`shard_range`).

        ``rng`` permutes the CHUNK ORDER (the global-shuffle walk
        TileDataset feeds from); row order within a chunk is the
        caller's concern."""
        lo, hi = self.shard_range(shard, drop_tail=drop_tail)
        starts = np.arange(lo, hi, chunk_size)
        if rng is not None:
            starts = starts[rng.permutation(len(starts))]
        for s in starts:
            yield self.read_chunk(int(s), int(min(s + chunk_size, hi)))

    # ------------------------------------------------------------------ #

    @staticmethod
    def save(file_path: str, imgs: np.ndarray, masks: np.ndarray,
             meta: Config, overwrite: bool = True) -> str:
        """Write the .h5 with the reference's exact layout."""
        if os.path.exists(file_path) and not overwrite:
            raise FileExistsError(file_path)
        import h5py
        os.makedirs(os.path.dirname(file_path) or ".", exist_ok=True)
        tmp = file_path + ".tmp"
        with h5py.File(tmp, "w") as f:
            f.create_dataset("img", imgs.shape, compression="gzip",
                             chunks=True, data=imgs)
            f.create_dataset("mask", masks.shape, compression="gzip",
                             chunks=True, data=masks)
            f.attrs["meta"] = json.dumps(meta) if isinstance(meta, dict) \
                else meta.to_meta_json()
        # atomic replace so a crashed write never leaves a torn DB
        os.replace(tmp, file_path)
        return file_path

    def describe(self) -> str:
        return (f"TileDB(path={self.path}, size={self.size}, "
                f"partition={self.partition} -> "
                f"[{self.start}:{self.end}]={self.partition_size})")
