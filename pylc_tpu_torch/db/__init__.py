"""Tile database (HDF5 or in memory) and the batch feeding pipeline."""

from pylc_tpu_torch.db.database import TileDB  # noqa: F401
from pylc_tpu_torch.db.dataset import TileDataset  # noqa: F401
