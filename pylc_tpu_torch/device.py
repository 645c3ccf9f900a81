"""Device selection for the port's entry points."""

from __future__ import annotations

from typing import Optional

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


def check_n_devices(n_devices: Optional[int]) -> None:
    """The device count an entry point was asked for: ``None`` or 1 run
    on one device; several are ROADMAP Queue 1 item 18 and raise."""
    if n_devices not in (None, 1):
        raise NotImplementedError(
            f"n_devices={n_devices}: several GPUs are ROADMAP Queue 1 "
            "item 18; pass None or 1")
