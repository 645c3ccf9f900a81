"""CLI of the port: the JAX package's parser and flags, plus ``--device``.

``python -m pylc_tpu_torch <mode> ... [--device cuda|cpu]``.  ``train``
and ``test`` run in the port; every other mode raises, naming the ROADMAP
item that ports it.  ``train --db`` reads an HDF5 DB, so it needs h5py.
"""

from __future__ import annotations

import argparse
import os

from pylc_tpu.cli import _cfg_from_args, get_parser
from pylc_tpu_torch.config import Config
from pylc_tpu_torch.device import resolve_device

# mode -> the ROADMAP Queue 1 item that ports it
NOT_PORTED = {
    "extract": "item 15 (ops/profile.py and extract.py)",
    "profile": "item 15 (ops/profile.py and extract.py)",
    "augment": "item 16 (augment_ops.py and augment.py)",
    "merge": "item 16 (augment_ops.py and augment.py)",
    "grayscale": "item 16 (augment_ops.py and augment.py)",
    "export": "item 19 (export.py, server.py)",
    "serve": "item 19 (export.py, server.py)",
}


def run_test(args, device):
    from pylc_tpu_torch.tester import test
    cfg = _cfg_from_args(args)
    test(cfg, args.model, args.img, mask_path=args.mask, scale=args.scale,
         save_logits=args.save_logits,
         aggregate_metrics=args.aggregate_metrics,
         use_crf=args.crf, device=device)


def run_train(args, device):
    from pylc_tpu_torch.trainer import train
    cfg = _cfg_from_args(args)
    summary = train(cfg, args.db, device=device)
    print(f"\nTraining done: {summary['steps']} steps, best dice "
          f"{summary['best_dice']:.4f}, {summary['wall_s']:.1f}s")


def main(argv=None):
    dev_parser = argparse.ArgumentParser(add_help=False)
    dev_parser.add_argument("--device", default="cuda",
                            help="torch device: cuda (default), cuda:N "
                                 "or cpu")
    dev_args, rest = dev_parser.parse_known_args(argv)
    args = get_parser().parse_args(rest)
    if args.mode in NOT_PORTED:
        raise NotImplementedError(
            f"mode '{args.mode}' is not ported to PyTorch yet: ROADMAP "
            f"Queue 1 {NOT_PORTED[args.mode]}")
    if getattr(args, "n_devices", None) not in (None, 1):
        raise NotImplementedError(
            f"multi-GPU {args.mode} is ROADMAP Queue 1 item 18")
    if getattr(args, "multihost", False):
        raise NotImplementedError(
            "multi-host training is ROADMAP Queue 1 item 18")
    device = resolve_device(dev_args.device)
    cfg = Config()
    for d in (cfg.root, cfg.db_dir, cfg.save_dir, cfg.model_dir,
              cfg.output_dir):
        os.makedirs(d, exist_ok=True)
    {"train": run_train, "test": run_test}[args.mode](args, device)
