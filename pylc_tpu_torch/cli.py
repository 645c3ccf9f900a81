"""CLI of the port: the JAX package's subcommands, flags and defaults,
plus ``--device``.

``python -m pylc_tpu_torch <mode> ... [--device cuda|cuda:N|cpu]``.  Flag
names follow reference utils/argparse.py:22-337, as ``pylc_tpu/cli.py``'s
do, so existing invocations keep working (``tests/test_torch_config.py``
holds the two parsers to equal configs).  ``extract``, ``profile``,
``augment``, ``merge``, ``grayscale``, ``train`` and ``test`` run in the
port; ``export`` and ``serve`` parse and then raise, naming the ROADMAP
item that ports them.  Every mode that reads or writes an ``.h5`` DB
needs h5py.
"""

from __future__ import annotations

import argparse
import os

from pylc_tpu_torch.config import Config
from pylc_tpu_torch.device import check_n_devices, resolve_device

DEVICE_HELP = "torch device: cuda (default), cuda:N or cpu"

# mode -> the ROADMAP Queue 1 item that ports it
NOT_PORTED = {
    "export": "item 19 (export.py, server.py)",
    "serve": "item 19 (export.py, server.py)",
}


def _base(sub):
    sub.add_argument("--schema", type=str, metavar="SCHEMA_PATH",
                     default=None,
                     help="Categorization schema (JSON file, default: "
                          "schema_a.json).")
    # also accepted before the mode; SUPPRESS keeps that value when the
    # flag is not repeated after it
    sub.add_argument("--device", default=argparse.SUPPRESS, help=DEVICE_HELP)


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="pylc_tpu_torch",
        description="Deep-learning land-cover classification on PyTorch "
                    "and CUDA.")
    p.add_argument("--device", default="cuda", help=DEVICE_HELP)
    sub = p.add_subparsers(title="Modes", dest="mode", required=True)

    # ------------------------- extract -------------------------------- #
    ex = sub.add_parser("extract", help="Extract tiles from input images.")
    _base(ex)
    ex.add_argument("-i", "--img", type=str, required=True,
                    metavar="IMAGE_PATH")
    ex.add_argument("-m", "--mask", type=str, default=None,
                    metavar="MASKS_PATH")
    ex.add_argument("--ch", type=int, required=True, choices=(1, 3),
                    metavar="N_CHANNELS")
    ex.add_argument("--batch_size", type=int, default=None)
    ex.add_argument("--output", type=str, default=None,
                    help="Output directory for the .h5 database.")

    # ------------------------- augment -------------------------------- #
    au = sub.add_parser("augment", help="Data augmentation for database.")
    _base(au)
    au.add_argument("--db", type=str, required=True, metavar="DATABASE_PATH")
    au.add_argument("--output", type=str, default=None)

    # ------------------------- merge ---------------------------------- #
    me = sub.add_parser("merge", help="Combine multiple databases.")
    _base(me)
    me.add_argument("--dbs", type=str, nargs="+", required=True,
                    metavar="DATABASE_PATHS")
    me.add_argument("--output", type=str, default=None)

    # ------------------------- grayscale ------------------------------ #
    gs = sub.add_parser("grayscale", help="Convert database to grayscale.")
    _base(gs)
    gs.add_argument("--db", type=str, required=True, metavar="DATABASE_PATH")
    gs.add_argument("--output", type=str, default=None)

    # ------------------------- profile -------------------------------- #
    pr = sub.add_parser("profile", help="Print database profile metadata.")
    _base(pr)
    pr.add_argument("--db", type=str, required=True, metavar="DATABASE_PATH")

    # ------------------------- train ---------------------------------- #
    tr = sub.add_parser("train", help="Train model on input database.")
    _base(tr)
    tr.add_argument("--db", type=str, required=True, metavar="DATABASE_PATH")
    tr.add_argument("--arch", type=str, default=None,
                    choices=("deeplab", "unet", "resunet"))
    tr.add_argument("--backbone", type=str, default=None,
                    choices=("resnet", "xception", "mobilenet", "drn"))
    tr.add_argument("--weighted", action="store_true",
                    help="Class-weighted CE loss.")
    tr.add_argument("--ce_weight", type=float, default=None)
    tr.add_argument("--dice_weight", type=float, default=None)
    tr.add_argument("--focal_weight", type=float, default=None)
    tr.add_argument("--optim", type=str, default=None,
                    choices=("adam", "sgd"))
    tr.add_argument("--sched", type=str, default=None,
                    choices=("step_lr", "cyclic_lr", "anneal"))
    tr.add_argument("--normalize", type=str, default=None,
                    choices=("batch", "instance", "layer", "syncbatch"))
    tr.add_argument("--activation", type=str, default=None,
                    choices=("relu", "lrelu", "selu", "gelu"))
    tr.add_argument("--up_mode", type=str, default=None,
                    choices=("upconv", "upsample"))
    tr.add_argument("--lr", type=float, default=None)
    tr.add_argument("--batch_size", type=int, default=None)
    tr.add_argument("--n_epochs", type=int, default=None)
    tr.add_argument("--pretrained", action="store_true")
    tr.add_argument("--n_workers", type=int, default=None)
    tr.add_argument("--report", type=int, default=None)
    tr.add_argument("--resume", action="store_true")
    tr.add_argument("--clip", type=float, default=None)
    tr.add_argument("--head_lr_mult", type=float, default=None,
                    help="LR multiplier for the ASPP+decoder head vs "
                         "the backbone (the reference's unwired "
                         "get_1x/get_10x_lr_params split; try 10).")
    tr.add_argument("--n_devices", type=int, default=None,
                    help="Number of devices (only 1 is ported).")
    tr.add_argument("--multihost", action="store_true",
                    help="Multi-host training (not ported).")

    # ------------------------- test ----------------------------------- #
    te = sub.add_parser("test", help="Generate segmentation maps.")
    _base(te)
    te.add_argument("-l", "--model", type=str, required=True,
                    metavar="MODEL_PATH")
    te.add_argument("-i", "--img", type=str, required=True,
                    metavar="IMAGE_PATH")
    te.add_argument("-m", "--mask", type=str, default=None,
                    metavar="MASKS_PATH")
    te.add_argument("--scale", type=float, default=None)
    te.add_argument("--save_logits", action="store_true")
    te.add_argument("--aggregate_metrics", action="store_true")
    te.add_argument("--crf", action="store_true",
                    help="Apply dense-CRF mean-field refinement.")
    te.add_argument("--crf_iters", type=int, default=None,
                    help="Mean-field iterations (default 5).")
    te.add_argument("--crf_radius", type=int, default=None,
                    help="Message-passing window radius (default 3).")
    te.add_argument("--crf_downsample", type=int, default=None,
                    help="Message-passing grid subsampling: 1 = full "
                         "resolution, 2 (default) halves it — see "
                         "docs/CRF_TUNING.md for the quality/speed "
                         "frontier.")
    te.add_argument("--crf_w_app", type=float, default=None,
                    help="Appearance (bilateral) kernel weight.")
    te.add_argument("--crf_sigma_app", type=float, default=None,
                    help="Appearance spatial sigma (grid px).")
    te.add_argument("--crf_sigma_color", type=float, default=None,
                    help="Appearance colour sigma (intensity units).")
    te.add_argument("--crf_w_smooth", type=float, default=None,
                    help="Smoothness (Gaussian) kernel weight.")
    te.add_argument("--crf_sigma_smooth", type=float, default=None,
                    help="Smoothness spatial sigma (grid px).")
    te.add_argument("--n_devices", type=int, default=None,
                    help="Number of devices (only 1 is ported).")

    # ------------------------- export --------------------------------- #
    xp = sub.add_parser(
        "export",
        help="Export a hermetic serving artifact (.pylcx).")
    _base(xp)
    xp.add_argument("-l", "--model", type=str, required=True,
                    metavar="MODEL_PATH")
    xp.add_argument("--size", type=str, required=True, metavar="HxW",
                    help="Fitted canvas geometry, e.g. 1024x1536 (must be "
                         "tile multiples; one artifact per geometry).")
    xp.add_argument("--stride", type=int, default=None,
                    help="Tile stride (default tile_size/2, the test "
                         "path's overlap).")
    xp.add_argument("--crf", action="store_true",
                    help="Bake dense-CRF refinement into the program.")
    xp.add_argument("--platforms", type=str, default=None,
                    help="Comma-separated lowering targets.")
    xp.add_argument("-o", "--output", type=str, default=None)

    # ------------------------- serve ---------------------------------- #
    sv = sub.add_parser(
        "serve",
        help="Resident HTTP segmentation daemon: POST /segment with "
             "image bytes -> colour mask PNG; GET /healthz.")
    _base(sv)
    sv.add_argument("-l", "--model", type=str, required=True,
                    metavar="MODEL_PATH",
                    help=".ckpt / .pth checkpoint or .pylcx artifact")
    sv.add_argument("--host", type=str, default="127.0.0.1")
    sv.add_argument("--port", type=int, default=8917)
    sv.add_argument("--scale", type=float, default=None,
                    help="Pre-fit scale applied to every photo "
                         "(reference --scale semantics).")
    sv.add_argument("--batch_size", type=int, default=16,
                    help="Tile batch per forward.")
    sv.add_argument("--crf", action="store_true",
                    help="Apply dense-CRF refinement (checkpoint "
                         "backend; .pylcx bakes CRF at export).")

    return p


def _cfg_from_args(args) -> Config:
    cfg = Config() if not getattr(args, "schema", None) else \
        Config(schema=args.schema)
    remap = {"optim": "optim_type", "sched": "sched_type",
             "normalize": "norm_type", "activation": "activ_type",
             "resume": "resume_checkpoint"}
    updates = {}
    for k, v in vars(args).items():
        if k in ("mode", "schema", "device") or v is None or v is False:
            continue
        updates[remap.get(k, k)] = v
    return cfg.replace(**updates)


def run_extract(args, device):
    from pylc_tpu_torch.extract import Extractor
    cfg = _cfg_from_args(args)
    print(f"Extracting tiles from:\n\t{args.img}\n\t{args.mask}")
    ex = Extractor(cfg, device).load(args.img, args.mask)
    ex.extract().coshuffle().profile()
    path = ex.save(args.output)
    print(f"Saved {ex.meta.n_tiles} tiles to {path}")


def run_augment(args, device):
    from pylc_tpu_torch.augment import Augmentor
    cfg = _cfg_from_args(args)
    print(f"Augmenting database:\n\t{args.db}")
    aug = Augmentor(cfg, device).load(args.db).optimize()
    om = aug.optim_meta
    print(f"  optimal threshold {om['threshold']:.2f}, rate_coef "
          f"{om['rate_coef']:.0f}, +{om['aug_n_samples']} samples, "
          f"JSD {om['jsd']:.4f}")
    aug.oversample()
    path = aug.save(args.output)
    print(f"Saved augmented DB to {path}")


def run_merge(args, device):
    from pylc_tpu_torch.augment import merge_dbs
    cfg = _cfg_from_args(args)
    out = args.output or os.path.join(cfg.db_dir, "merged.h5")
    path = merge_dbs(args.dbs, out, cfg, device=device)
    print(f"Merged {len(args.dbs)} databases into {path}")


def run_grayscale(args, device):
    from pylc_tpu_torch.augment import grayscale_db
    cfg = _cfg_from_args(args)
    out = args.output or os.path.splitext(args.db)[0] + "_gs.h5"
    path = grayscale_db(args.db, out, cfg, device=device)
    print(f"Grayscaled database saved to {path}")


def run_profile(args, device):
    from pylc_tpu_torch.db.database import TileDB
    from pylc_tpu_torch.ops.profile import profile_tiles
    cfg = _cfg_from_args(args)
    db = TileDB(args.db)
    meta = db.get_meta(base=cfg)
    prof = profile_tiles(db.iter_chunks(512), meta.n_classes,
                         meta.tile_size, device)
    meta = meta.replace(**prof)
    print_profile(meta)


def run_train(args, device):
    from pylc_tpu_torch.trainer import train
    cfg = _cfg_from_args(args)
    summary = train(cfg, args.db, n_devices=args.n_devices, device=device)
    print(f"\nTraining done: {summary['steps']} steps, best dice "
          f"{summary['best_dice']:.4f}, {summary['wall_s']:.1f}s")


def run_test(args, device):
    from pylc_tpu_torch.tester import test
    cfg = _cfg_from_args(args)
    test(cfg, args.model, args.img, mask_path=args.mask, scale=args.scale,
         save_logits=args.save_logits,
         aggregate_metrics=args.aggregate_metrics,
         use_crf=args.crf, n_devices=args.n_devices, device=device)


def print_profile(meta: Config):
    print(f"\nProfile Metadata\n{'-' * 60}")
    print(f"{'ID':24s}{meta.id}")
    print(f"{'Channels':24s}{meta.ch} ({meta.ch_label})")
    print(f"{'Classes':24s}{meta.n_classes}")
    print(f"{'Samples':24s}{meta.n_samples}")
    print(f"{'Tile size':24s}{meta.tile_size}px")
    print(f"{'Pixel mean':24s}{meta.px_mean}")
    print(f"{'Pixel std':24s}{meta.px_std}")
    print(f"{'M2':24s}{meta.m2:.4f}")
    print(f"{'JSD':24s}{meta.jsd:.4f}")
    print(f"\n{'Class':28s}{'Probs':>10s}{'Weights':>10s}")
    for i, lbl in enumerate(meta.class_labels):
        print(f"{lbl:28s}{meta.probs[i]:>10.4f}{meta.weights[i]:>10.4f}")


MODES = {"extract": run_extract, "profile": run_profile,
         "augment": run_augment, "merge": run_merge,
         "grayscale": run_grayscale, "train": run_train, "test": run_test}


def main(argv=None):
    args = get_parser().parse_args(argv)
    if args.mode in NOT_PORTED:
        raise NotImplementedError(
            f"mode '{args.mode}' is not ported to PyTorch yet: ROADMAP "
            f"Queue 1 {NOT_PORTED[args.mode]}")
    check_n_devices(getattr(args, "n_devices", None))
    if getattr(args, "multihost", False):
        raise NotImplementedError(
            "multi-host training is ROADMAP Queue 1 item 18")
    device = resolve_device(args.device)
    cfg = Config()
    for d in (cfg.root, cfg.db_dir, cfg.save_dir, cfg.model_dir,
              cfg.output_dir):
        os.makedirs(d, exist_ok=True)
    MODES[args.mode](args, device)
