"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(name: str = "cuda") -> torch.device:
    """The torch device a run asked for.  A CUDA device that is not
    present raises: a run never carries on on the CPU unasked."""
    device = torch.device(name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device '{name}' requested but no CUDA device is visible "
                "(pass --device cpu to run on the CPU)")
        if device.index is not None and \
                device.index >= torch.cuda.device_count():
            raise RuntimeError(f"device '{name}' requested but only "
                               f"{torch.cuda.device_count()} CUDA devices "
                               "are visible")
    elif device.type != "cpu":
        raise ValueError(f"unsupported device '{name}' (cuda or cpu)")
    return device
