"""Checkpointing and loss tracking.

Port of ``pylc_tpu/checkpoint.py``.  ``RunningLoss`` is the same code,
with the same ``losses.json``, which in a process group rank 0 alone
touches (``owner``).  ``Checkpoint`` keeps the atomic writes
(tmp + ``os.replace``) but writes torch files:

  - ``checkpoint.pth``: {epoch, iter, model, optimizer, scheduler, meta},
    written at every validation, for ``--resume``.  ``--resume`` also
    takes the JAX package's resumable ``checkpoint.ckpt`` in the model
    directory (``convert.load_ckpt_checkpoint``: the weights, the
    optimizer's moments and step counts, the schedule's position), so a
    run the JAX package started carries on here.  Where both files are
    there, the one written last is the run's newest state and is taken.
    A run without ``--resume`` removes only ``checkpoint.pth``, as the JAX
    package's removes only its own file;
  - ``<model_id>.pth``: {'model': state_dict, 'meta': cfg.to_meta()}, the
    best model by validation Dice.  For a DeepLab on ResNet101 or Xception
    this is the reference schema, which both the port's and the JAX
    package's ``.pth`` loaders read; the reference has no schema for the
    other models, whose file has the same ``meta`` and the port's own key
    names (``convert.module_map``), and loads through
    ``convert.load_pth_model`` with the config the model was built from.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import torch
import torch.nn as nn

from pylc_tpu_torch.config import Config
from pylc_tpu_torch.convert import load_ckpt_checkpoint


def _atomic_write(path: str, data: bytes):
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


def _atomic_save(obj: Any, path: str):
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _cpu_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    return {k: v.detach().cpu() for k, v in model.state_dict().items()}


class Checkpoint:
    """Checkpoint manager for one model directory."""

    def __init__(self, model_id: str, save_dir: str):
        self.model_dir = os.path.join(save_dir, model_id)
        os.makedirs(self.model_dir, exist_ok=True)
        self.checkpoint_file = os.path.join(self.model_dir, "checkpoint.pth")
        self.jax_checkpoint_file = os.path.join(self.model_dir,
                                                "checkpoint.ckpt")
        self.model_file = os.path.join(self.model_dir, model_id + ".pth")

    def save(self, model: nn.Module, optimizer: torch.optim.Optimizer,
             scheduler: torch.optim.lr_scheduler.LRScheduler, cfg: Config,
             epoch: int, iteration: int, is_best: bool = False):
        weights = _cpu_state_dict(model)
        meta = cfg.to_meta()
        _atomic_save({"epoch": epoch, "iter": iteration, "model": weights,
                      "optimizer": optimizer.state_dict(),
                      "scheduler": scheduler.state_dict(), "meta": meta},
                     self.checkpoint_file)
        if is_best:
            _atomic_save({"model": weights, "meta": meta}, self.model_file)

    def load(self, model: nn.Module, optimizer: torch.optim.Optimizer,
             scheduler: torch.optim.lr_scheduler.LRScheduler, cfg: Config
             ) -> Optional[Dict[str, Any]]:
        """Restore the newer of ``checkpoint.pth`` and the JAX package's
        ``checkpoint.ckpt`` (by modification time; ``cfg`` is the model's
        and the optimizer's config) into ``model``, ``optimizer`` and
        ``scheduler`` in place.  Returns {'epoch', 'iter', 'meta', 'file'},
        or None if there is neither."""
        found = [p for p in (self.checkpoint_file, self.jax_checkpoint_file)
                 if os.path.exists(p)]
        if not found:
            return None
        if max(found, key=os.path.getmtime) == self.jax_checkpoint_file:
            return dict(load_ckpt_checkpoint(
                self.jax_checkpoint_file, cfg, model, optimizer, scheduler),
                file=self.jax_checkpoint_file)
        device = next(model.parameters()).device
        payload = torch.load(self.checkpoint_file, map_location=device,
                             weights_only=False)
        model.load_state_dict(payload["model"], strict=True)
        optimizer.load_state_dict(payload["optimizer"])
        scheduler.load_state_dict(payload["scheduler"])
        return {"epoch": payload["epoch"], "iter": payload["iter"],
                "meta": payload["meta"], "file": self.checkpoint_file}

    def reset(self):
        """A run that does not resume removes its own resumable state.  The
        JAX package's ``checkpoint.ckpt`` stays, as that package's reset
        leaves ``checkpoint.pth``; this run's first ``save`` is newer, so
        a later ``--resume`` takes this run's file."""
        if os.path.exists(self.checkpoint_file):
            os.remove(self.checkpoint_file)


class RunningLoss:
    """Interval-averaged loss tracker with best-dice checkpoint gating.

    ``owner``: this process keeps ``losses.json``.  In a process group
    only rank 0 does; another rank's tracker averages its own metrics but
    never reads, removes or writes the file (every rank removing a stale
    log raced: the second to reach it raised ``FileNotFoundError``)."""

    def __init__(self, model_id: str, save_dir: str, resume: bool = False,
                 owner: bool = True):
        self.owner = owner
        self.train = []
        self.valid = []
        self.intv = []
        self.lr = []
        self.avg_ce = 0.0
        self.avg_dice = 1.0
        self.avg_fl = 0.0
        self.best_dice = 1.0
        self.is_best = False
        self.model_dir = os.path.join(save_dir, model_id)
        os.makedirs(self.model_dir, exist_ok=True)
        self.log_file = os.path.join(self.model_dir, "losses.json")
        if owner and os.path.exists(self.log_file):
            if resume:
                with open(self.log_file) as f:
                    d = json.load(f)
                self.train = d.get("train", [])
                self.valid = d.get("valid", [])
                self.best_dice = d.get("best_dice", 1.0)
                self.lr = d.get("lr", [])
            else:
                os.remove(self.log_file)

    def push(self, metrics: Dict[str, Any], weight: float = 1.0):
        """Buffer one step's metrics.  Device scalars are stored as they
        are; the host waits for them once per interval, in ``log``.

        ``weight``: this batch's weight in the interval average —
        validation passes its sample count, so a partial final batch
        does not get full-batch influence on the best-dice gate."""
        self.intv.append((metrics["ce"], metrics["dice"], metrics["focal"],
                          weight))

    def log(self, iteration: int, training: bool):
        """Fold the interval buffer into a weighted average; update
        best-dice on validation."""
        if not self.intv:
            if not training:
                # an empty validation must not re-trigger a stale best
                self.is_best = False
            return
        self.intv = [tuple(float(x) for x in row) for row in self.intv]
        wsum = sum(row[3] for row in self.intv) or 1.0
        ce, dice, fl = (sum(v * row[3] for v, row in
                            zip(col, self.intv)) / wsum
                        for col in zip(*(r[:3] for r in self.intv)))
        self.avg_ce, self.avg_dice, self.avg_fl = ce, dice, fl
        self.intv = []
        row = (iteration, ce, dice, fl)
        if training:
            self.train.append(row)
        else:
            self.valid.append(row)
            self.is_best = self.avg_dice < self.best_dice
            if self.is_best:
                self.best_dice = self.avg_dice

    def save(self):
        if not self.owner:
            raise RuntimeError("RunningLoss.save: only the owner (rank 0) "
                               "writes losses.json")
        blob = json.dumps({
            "train": self.train, "valid": self.valid,
            "best_dice": self.best_dice, "lr": self.lr,
        }).encode()
        _atomic_write(self.log_file, blob)

    def status(self, mode: str) -> str:
        return (f"[{mode}] ce {self.avg_ce:.4f}  dice {self.avg_dice:.4f}  "
                f"focal {self.avg_fl:.4f}  best-dice {self.best_dice:.4f}")
