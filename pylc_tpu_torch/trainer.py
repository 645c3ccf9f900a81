"""Training loop: epochs over a tile DB with validation and checkpoints.

Port of ``pylc_tpu/trainer.py``: train and validation
partitions (0, 1 - partition) and (1 - partition, 1), DB meta
rehydration (data fields only), the pretrained-encoder rule (a missing
default path trains from scratch, a path or flag the user gave must
exist), validation at the first epoch and after each epoch with the
best model gated on validation Dice, a resume that completes exactly
``n_epochs`` (DEVIATIONS F3) from the port's ``checkpoint.pth`` or the JAX
package's ``checkpoint.ckpt``, and metrics pulled to the host every
``report`` steps.  On several ranks (``parallel/mesh.py``) each rank
trains on its shard of the train split under DDP, validation is sharded
when the split has a row for every rank, and rank 0 alone writes.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional, Union

import numpy as np
import torch

from pylc_tpu_torch.checkpoint import Checkpoint, RunningLoss
from pylc_tpu_torch.config import Config
from pylc_tpu_torch.db.database import TileDB
from pylc_tpu_torch.db.dataset import TileDataset
from pylc_tpu_torch.device import resolve_device
from pylc_tpu_torch.parallel.mesh import (get_mesh, in_group, rank, spawn,
                                          world_size)
from pylc_tpu_torch.train_state import (
    init_model, make_eval_step, make_lr_schedule, make_optimizer,
    make_train_step,
)

# the ImageNet encoders' default paths, by backbone
PRETRAINED_PATHS = {
    "resnet": "./data/models/resnet101-5d3b4d8f.pth",
    "xception": "./data/models/xception-b5690688.pth",
    "mobilenet": "./data/models/mobilenet_v2-6a65762b.pth",
    "drn": "./data/models/drn_d_54-0e0534ff.pth",
}
FLIP_SEED = 1234


def resolve_pretrained(cfg: Config) -> Optional[str]:
    """The ImageNet encoder to start from, or None to train from scratch.

    A missing default path is the normal train-from-scratch case; a path
    the user gave, or the boolean ``--pretrained`` flag, must exist.  The
    config's default names the ResNet101 file: another backbone reads it
    as its own default."""
    if cfg.arch != "deeplab" or not cfg.pretrained:
        return None
    path = cfg.pretrained if isinstance(cfg.pretrained, str) else \
        PRETRAINED_PATHS[cfg.backbone]
    if path == PRETRAINED_PATHS["resnet"] and cfg.backbone != "resnet":
        path = PRETRAINED_PATHS[cfg.backbone]
    if os.path.exists(path):
        return path
    explicit = cfg.pretrained is True or (
        isinstance(cfg.pretrained, str)
        and cfg.pretrained not in PRETRAINED_PATHS.values())
    if explicit:
        raise FileNotFoundError(
            f"pretrained encoder requested but {path} does not exist; place "
            "the ImageNet checkpoint there or drop the flag.")
    return None


def _to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def train(cfg: Config, db: Union[str, Dict], n_devices: Optional[int] = None,
          verbose: bool = True, *,
          device: Union[str, torch.device, None] = None) -> dict:
    """Run the training job (default device ``cuda``; without a card this
    raises unless the caller passes ``"cpu"``).

    ``db`` is an ``.h5`` path or an in-memory {'img', 'mask', 'meta'}
    dict (``img`` [N, C, tile, tile] and ``mask`` [N, tile, tile] uint8).
    ``n_devices`` above 1, with no process group up, spawns that many
    ranks (``parallel.mesh.spawn``: NCCL on ``cuda:0 .. n-1``, or gloo on
    the CPU for ``device="cpu"``) and returns rank 0's summary.  Inside a
    process group (the spawned ranks, or ``torchrun`` with
    ``--multihost``) each rank is one of the JAX package's processes: it
    reads its shard of the train split, feeds its rows of the global
    batch, and only rank 0 writes checkpoints and ``losses.json``.
    Returns a summary dict."""
    world = world_size()
    if n_devices is not None and n_devices > 1 and not in_group():
        mesh = get_mesh(n_devices, str(device or "cuda"))
        return spawn(train, n_devices, (cfg, db, None, verbose),
                     {"device": mesh.devices[0].type},
                     devices=mesh.devices)
    if n_devices is not None and n_devices != world:
        raise ValueError(f"n_devices={n_devices} in a process group of "
                         f"{world} ranks")
    me = rank()
    device = resolve_device(str(device or "cuda"))
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    say = verbose and me == 0
    src = {"data": db} if isinstance(db, dict) else {"path": db}
    part = cfg.partition
    tr_db = TileDB(**src, partition=(0.0, 1.0 - part), clip=cfg.clip)
    va_db = TileDB(**src, partition=(1.0 - part, 1.0), clip=cfg.clip)

    # DB data facts -> config; the user's network settings win
    cfg = tr_db.get_meta(base=cfg, data_only=True)
    model_id = cfg.gen_model_id()
    cfg.id = model_id

    # the global batch divides over the ranks
    batch = max(cfg.batch_size, world)
    if batch % world:
        batch += world - batch % world
    if batch != cfg.batch_size and say:
        print(f"Global batch rounded {cfg.batch_size} -> {batch} to shard "
              f"evenly over the {world}-device mesh.")
    tr_ds = TileDataset(tr_db, batch_size=batch // world,
                        shuffle=cfg.shuffle, drop_last=True,
                        chunk_size=cfg.buffer_size, shard=(me, world))
    # validation is sharded when every rank gets a row: each rank feeds
    # batch / world rows of each global step from a split whose shard
    # sizes differ by at most one, and an exhausted rank feeds none, so
    # that all ranks make the same collective calls.  Otherwise every
    # rank walks the whole split, keeping partial batches: a small DB's
    # split can be smaller than one batch, and dropping it would starve
    # validation
    va_sharded = world > 1 and va_db.partition_size >= world
    if va_sharded:
        va_rows = batch // world
        va_ds = TileDataset(va_db, batch_size=va_rows, shuffle=False,
                            drop_last=False, chunk_size=cfg.buffer_size,
                            shard=(me, world), drop_tail=False)
        per, tail = divmod(va_db.partition_size, world)
        va_sizes = [per + (1 if j < tail else 0) for j in range(world)]
        va_steps = -(-va_sizes[0] // va_rows)  # shard 0 is the largest
    else:
        va_ds = TileDataset(va_db, batch_size=min(batch, va_db.partition_size)
                            or 1, shuffle=False, drop_last=False,
                            chunk_size=cfg.buffer_size, drop_tail=False)
    steps_per_epoch = max(1, tr_ds.n_batches)

    # resolved before the (expensive) model build, so a bad path fails fast
    pretrained_path = resolve_pretrained(cfg)
    model = init_model(cfg, seed=0)
    if pretrained_path:
        from pylc_tpu_torch.convert import IMAGENET_LOADERS
        IMAGENET_LOADERS[cfg.backbone](pretrained_path, model)
        if say:
            print(f"Loaded pretrained encoder from {pretrained_path}")
    model.to(device, memory_format=torch.channels_last)
    optimizer, scheduler = make_optimizer(cfg, model, steps_per_epoch)
    train_step = make_train_step(cfg, model, optimizer, scheduler)
    eval_step = make_eval_step(cfg, model, global_batch=va_sharded)
    lr_sched = make_lr_schedule(cfg, steps_per_epoch)

    ckpt = Checkpoint(model_id, cfg.save_dir)
    loss = RunningLoss(model_id, cfg.save_dir, resume=cfg.resume_checkpoint,
                       owner=me == 0)
    epoch0 = it = 0
    if cfg.resume_checkpoint:
        restored = ckpt.load(model, optimizer, scheduler, cfg)
        if restored is not None:
            epoch0, it = restored["epoch"], restored["iter"]
            if say:
                print(f"Resumed from epoch {epoch0} (iter {it}) of "
                      f"{restored['file']}.")
    elif me == 0:
        ckpt.reset()

    def val_batches():
        """(img, mask, weight in the validation average) per step."""
        if not va_sharded:
            for img, mask in va_ds:
                yield img, mask, float(img.shape[0])
            return
        batches = iter(va_ds)
        for s in range(va_steps):
            img, mask = next(batches, (None, None))
            if img is None:
                img = np.zeros((0,) + tuple(va_db.img_shape[1:]), np.uint8)
                mask = np.zeros((0,) + tuple(va_db.mask_shape[1:]),
                                np.uint8)
            # the global rows of step s, known to every rank from the
            # split's sizes
            yield img, mask, float(sum(min(va_rows, max(0, n - s * va_rows))
                                       for n in va_sizes))

    def validate(epoch: int):
        """Validate, then checkpoint (the reference saves at every
        validation)."""
        n_val = 0
        for img, mask, weight in val_batches():
            metrics = eval_step(_to_device(img, device),
                                _to_device(mask, device))
            loss.push(metrics, weight=weight)
            n_val += 1
        if n_val == 0 and say:
            print("  warning: validation split is empty")
        loss.log(it, training=False)
        # every rank holds the same metrics and weights; one writes
        if me == 0:
            ckpt.save(model, optimizer, scheduler, cfg, epoch, it,
                      is_best=loss.is_best)
            loss.save()
        if say:
            print(loss.status("valid"))

    t_start = time.time()
    flip_gen = torch.Generator().manual_seed(FLIP_SEED)
    for epoch in range(epoch0, cfg.n_epochs):
        if say:
            print(f"\nEpoch {epoch + 1}/{cfg.n_epochs}  (steps/epoch "
                  f"{steps_per_epoch}, lr {lr_sched(it):.2e}, {device}"
                  f"{f' x {world} ranks' if world > 1 else ''})")
        loss.lr.append((it, lr_sched(it)))
        if epoch == epoch0:
            validate(epoch)
        for img, mask in tr_ds:
            metrics = train_step(_to_device(img, device),
                                 _to_device(mask, device), flip_gen)
            it += 1
            loss.push(metrics)
            if it % cfg.report == 0:
                loss.log(it, training=True)
                if me == 0:
                    loss.save()
                if say:
                    print(f"  step {it}: {loss.status('train')}")
        loss.log(it, training=True)
        validate(epoch + 1)

    return {
        "model_id": model_id,
        "epochs": cfg.n_epochs - epoch0,
        "steps": it,
        "best_dice": loss.best_dice,
        "wall_s": time.time() - t_start,
        "model": model,
        "config": cfg,
    }
