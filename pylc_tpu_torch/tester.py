"""Test mode: apply a trained model to images -> masks + metrics.

Port of ``pylc_tpu/tester.py`` for one device: load the model (its meta
rides in the checkpoint), collate image (+ mask) files, decode and fit
them on a thread pool, segment with one image of device lookahead, save
the colour mask PNG, evaluate against the ground truth, optionally dump
the probability canvas, and aggregate the metrics.
"""

from __future__ import annotations

import os
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Optional, Tuple, Union

import torch
import torch.nn as nn

from pylc_tpu_torch.config import Config
from pylc_tpu_torch.convert import load_ckpt_model, load_pth_model
from pylc_tpu_torch.device import check_n_devices, resolve_device
from pylc_tpu_torch.evaluate import Evaluator
from pylc_tpu_torch.infer import Segmenter
from pylc_tpu_torch.ops.tiles import grid_dims
from pylc_tpu_torch.train_state import make_predict
from pylc_tpu_torch.utils.imageio import adjust_to_tile, collate, get_image


def load_model(model_path: str, base_cfg: Optional[Config] = None,
               device: Union[str, torch.device, None] = None
               ) -> Tuple[Config, nn.Module, Callable]:
    """Load a model file onto ``device`` (default ``cuda``; without a
    card this raises unless the caller passes ``"cpu"``): a ``.pth`` (the
    reference schema, or a best model of the port's trainer), or anything
    else as the JAX package's best-model ``.ckpt``.

    Returns (cfg, model, predict_fn)."""
    if not model_path or not os.path.exists(model_path):
        raise FileNotFoundError(f"Model file {model_path} does not exist.")
    device = resolve_device(str(device or "cuda"))
    load = load_pth_model if model_path.endswith(".pth") else load_ckpt_model
    cfg, model = load(model_path, base_cfg)
    model.to(device)
    return cfg, model, make_predict(cfg, model)


def test(cfg: Config, model_path: str, img_path: str,
         mask_path: Optional[str] = None, scale: Optional[float] = None,
         save_logits: bool = False, aggregate_metrics: bool = False,
         use_crf: bool = False, verbose: bool = True,
         n_devices: Optional[int] = None, *,
         device: Union[str, torch.device, None] = None) -> List[dict]:
    """Run the full test pipeline over one or more images on one device
    (default ``cuda``; without a card this raises unless the caller passes
    ``"cpu"``).  The arguments before ``device`` are the JAX package's, in
    its order; ``n_devices`` takes ``None`` or 1 (several GPUs are ROADMAP
    Queue 1 item 18), and ``verbose=False`` prints nothing."""
    check_n_devices(n_devices)
    device = resolve_device(str(device or "cuda"))
    cfg, _, predict = load_model(model_path, cfg, device)
    cfg.id = cfg.id or cfg.gen_model_id()

    crf = None
    if use_crf:
        from pylc_tpu_torch.ops.crf import make_crf
        crf = make_crf(cfg)

    seg = Segmenter(cfg, predict, device, batch_size=16, crf=crf)
    evaluator = Evaluator(cfg, keep_aggregate=aggregate_metrics)
    files = collate(img_path, mask_path)
    results = []

    import cv2

    stride = cfg.tile_size // 2
    n_workers = max(1, cfg.n_workers)

    def decode(fpair):
        if isinstance(fpair, dict):
            img_file, mask_file = fpair["img"], fpair["mask"]
        else:
            img_file, mask_file = fpair, None
        img, w_full, h_full, w_s, h_s = get_image(
            img_file, cfg.ch, scale=scale or cfg.scale,
            tile_size=cfg.tile_size)
        fitted, w_fit, h_fit, offset = adjust_to_tile(
            img, cfg.tile_size, stride)
        meta = {
            "img_file": img_file, "mask_file": mask_file,
            "w_full": w_full, "h_full": h_full,
            "w_scaled": w_s, "h_scaled": h_s,
            "w_fitted": w_fit, "h_fitted": h_fit,
            "offset": offset,
        }
        return meta, fitted

    def feed():
        # in-order results with a bounded decode lookahead
        with ThreadPoolExecutor(max_workers=n_workers) as ex:
            futs: deque = deque()
            it = iter(files)
            done = False
            while True:
                while not done and len(futs) < n_workers + 2:
                    try:
                        futs.append(ex.submit(decode, next(it)))
                    except StopIteration:
                        done = True
                if not futs:
                    return
                yield futs.popleft().result()

    for meta, res in seg.segment_stream(feed(), stride=stride):
        img_file, mask_file = meta["img_file"], meta["mask_file"]
        nr, nc = grid_dims(meta["w_fitted"], meta["h_fitted"],
                           cfg.tile_size, stride)
        res["mask_rgb"] = cv2.resize(
            res["mask_rgb"], (meta["w_scaled"], meta["h_scaled"]),
            interpolation=cv2.INTER_NEAREST)
        res["extract"] = dict(meta, n=nr * nc,
                              fid=(img_file.split("/")[-1].replace(".", "_")
                                   + "_scale_" + str(scale or cfg.scale)))
        fid = res["extract"]["fid"]
        mp = res["megapixels"]
        if verbose:
            print(f"  {fid}: {mp:.1f} MP in {res['seconds']:.3f}s "
                  f"({mp / res['seconds']:.1f} MP/s) on {device}")

        evaluator.load(res["mask_rgb"], fid, mask_true_path=mask_file,
                       scale=scale)
        evaluator.save_image()
        if mask_file and not aggregate_metrics:
            evaluator.evaluate()
            evaluator.save_metrics()
            m = evaluator.metrics.results
            if verbose:
                print(f"    F1 {m['f1']:.4f}  IoU {m['iou']:.4f}  "
                      f"MCC {m['mcc']:.4f}")
        if save_logits:
            evaluator.save_logits(res["probs"].cpu().numpy())
        results.append({"fid": fid, "seconds": res["seconds"],
                        "megapixels": res["megapixels"],
                        "metrics": dict(evaluator.metrics.results)})
        evaluator.reset()

    if aggregate_metrics:
        evaluator.evaluate(aggregate=True)
        evaluator.save_metrics()
        evaluator.save_tex()
        results.append({"fid": "aggregate",
                        "metrics": dict(evaluator.metrics.results)})
    return results
