"""Full-image inference: tile -> batched forward -> stitch -> (CRF) ->
argmax -> colourize.

Port of ``pylc_tpu/infer.py`` for one device.  PyTorch runs eagerly, so
there is no program cache: every stage is a few launches on the device's
current stream, and only the class-map copy to the host waits for them.

  host uint8 image -> one copy to the device
    -> unfold into tiles (layout moves)
    -> forward in batches of ``batch_size`` tiles (logits smaller than
       the tile, a valid-conv U-Net's, are resized to it with align
       corners), softmax per tile
    -> overlap-average stitch into an f32 canvas
    -> optional dense-CRF mean-field refinement (kernel K1)
    -> uint8 argmax -> one copy of the class map to the host
  -> palette colourize on the host (``native.colourize``).

``segment_many`` pipelines a sequence of same-shape photos on a CUDA
device (photo k + 1's upload on a copy stream from pinned memory while
photo k computes, the class map's download without blocking the host, the
colourize of photo k on a worker thread while the main thread launches
photo k + 1); eager PyTorch overlaps none of this by itself.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from pylc_tpu_torch import native
from pylc_tpu_torch.config import Config
from pylc_tpu_torch.models.layers import resize_bilinear_align_corners
from pylc_tpu_torch.ops.tiles import grid_dims, stitch_probs, unfold_tiles
from pylc_tpu_torch.utils.imageio import adjust_to_tile, get_image

#: tile sets larger than this keep their probabilities in bf16 (the
#: stitch still sums in f32); 3 decimal digits on [0, 1] keep the argmax
PROBS_BF16_BYTES = 256 * 2 ** 20

STAGES = ("h2d", "forward_stitch", "crf", "d2h", "colourize")

#: pinned host buffers ``segment_many`` rotates, for the photos and for
#: the class maps: one in a copy while the host fills or reads the other
MANY_BUFFERS = 2


class Segmenter:
    """Batched tile -> mask inference for one loaded model on one device.

    predict_fn: uint8 [B, t, t, C] on ``device`` -> f32 logits
    [B, t, t, K] (``train_state.make_predict``).  crf: optional
    (canvas [H, W, K], guide [H, W, C]) -> refined canvas."""

    def __init__(self, cfg: Config, predict_fn: Callable,
                 device: torch.device, batch_size: int = 16,
                 crf: Optional[Callable] = None):
        self.cfg = cfg
        self.predict = predict_fn
        self.device = torch.device(device)
        self.batch_size = batch_size
        self.crf = crf
        self.palette = np.asarray(cfg.palette_rgb, np.uint8)
        native.available()  # builds the host library now, not in a timing

    def _canvas(self, img: torch.Tensor, stride: int) -> torch.Tensor:
        """Tile, forward and stitch a fitted [H, W, C] uint8 image on the
        device -> [H, W, K] f32 probability canvas."""
        tile = self.cfg.tile_size
        H, W = img.shape[:2]
        n_rows, n_cols = grid_dims(W, H, tile, stride)
        tiles = unfold_tiles(img, tile, stride)
        n_tiles = tiles.shape[0]
        probs_dtype = torch.bfloat16 if \
            n_tiles * tile * tile * self.cfg.n_classes * 4 > PROBS_BF16_BYTES \
            else torch.float32
        probs = torch.empty((n_tiles, tile, tile, self.cfg.n_classes),
                            dtype=probs_dtype, device=img.device)
        # the last batch runs short: BatchNorm is in eval mode, so padding
        # it (as a fixed-length scan must) changes nothing
        for i in range(0, n_tiles, self.batch_size):
            logits = self.predict(tiles[i:i + self.batch_size])
            if logits.shape[1] != tile:  # valid-conv U-Net: 324 of 512
                logits = resize_bilinear_align_corners(
                    logits.permute(0, 3, 1, 2), tile, tile
                ).permute(0, 2, 3, 1)
            probs[i:i + self.batch_size] = torch.softmax(logits, dim=-1)
        return stitch_probs(probs, n_rows, n_cols, tile, stride)

    def _compute(self, dev: torch.Tensor, stride: int,
                 mark: Callable[[str], None]):
        """Enqueue the device work for one [H, W, C] uint8 image on the
        device -> (class map, canvas), both on the device."""
        canvas = self._canvas(dev, stride)
        mark("forward_stitch")
        if self.crf is not None:
            canvas = self.crf(canvas, dev)
        mark("crf")
        return canvas.argmax(dim=-1).to(torch.uint8), canvas

    def _launch(self, img: np.ndarray, stride: int,
                mark: Callable[[str], None]):
        """Enqueue the device work for one image -> (class map and canvas
        on the device, megapixels); nothing here waits for the device."""
        if img.ndim == 2:
            img = img[..., None]
        dev = torch.from_numpy(np.ascontiguousarray(img)).to(self.device)
        mark("h2d")
        class_map, canvas = self._compute(dev, stride, mark)
        return class_map, canvas, img.shape[0] * img.shape[1] / 1e6

    def _fetch(self, class_map: torch.Tensor, canvas: torch.Tensor,
               megapixels: float, mark: Callable[[str], None]) -> Dict:
        class_map = class_map.cpu().numpy()  # waits for the device
        mark("d2h")
        mask_rgb = native.colourize(class_map, self.palette)
        mark("colourize")
        return {"mask_rgb": mask_rgb, "class_map": class_map,
                "probs": canvas, "megapixels": megapixels}

    def segment_array(self, img: np.ndarray, stride: Optional[int] = None
                      ) -> Dict:
        """Segment a fitted [H, W, C] uint8 image (H, W tile multiples).

        Returns 'mask_rgb' [H, W, 3] u8, 'class_map' [H, W] u8, 'probs'
        (the [H, W, K] canvas on the device), 'seconds', 'megapixels'."""
        stride = stride or self.cfg.tile_size // 2  # test default
        t0 = time.perf_counter()
        res = self._fetch(*self._launch(img, stride, _no_mark), _no_mark)
        res["seconds"] = time.perf_counter() - t0
        return res

    def segment_array_staged(self, img: np.ndarray,
                             stride: Optional[int] = None) -> Dict:
        """segment_array with 'stages': seconds for h2d, forward_stitch,
        crf, d2h (argmax and the class-map copy) and colourize.

        On a CUDA device the device stages are read from CUDA events on
        the current stream (the host returns from a launch before the
        device runs it), and colourize, host work, from the host clock.
        On the CPU every stage is the host clock."""
        stride = stride or self.cfg.tile_size // 2
        cuda = self.device.type == "cuda"
        host, events = [], []

        def mark(name):
            if cuda:
                events.append(torch.cuda.Event(enable_timing=True))
                events[-1].record()
            host.append(time.perf_counter())

        if cuda:
            torch.cuda.synchronize(self.device)
        mark("start")
        res = self._fetch(*self._launch(img, stride, mark), mark)
        res["seconds"] = host[-1] - host[0]
        res["stages"] = {
            name: events[i].elapsed_time(events[i + 1]) / 1e3
            if cuda and name != "colourize" else host[i + 1] - host[i]
            for i, name in enumerate(STAGES)}
        return res

    def segment_many(self, imgs: Sequence[np.ndarray],
                     stride: Optional[int] = None) -> List[Dict]:
        """Segment a sequence of fitted images of one shape (a folder of
        photos from one camera), pipelined on a CUDA device.

        Returns a list of dicts like ``segment_array``'s without 'probs':
        'class_map' and 'mask_rgb' (each equal to ``segment_array``'s: the
        same kernels in the same order), 'megapixels', 'seconds' (marginal
        wall time: the previous photo's completion to this one's, the
        first carrying the pipeline's fill, so the sum is the total) and
        'completed_s' (completion since the start of the call)."""
        stride = stride or self.cfg.tile_size // 2
        if len(imgs) == 0:
            return []
        imgs = [img[..., None] if img.ndim == 2 else img for img in imgs]
        H, W = imgs[0].shape[:2]
        for i, img in enumerate(imgs):
            if img.shape[:2] != (H, W):
                raise ValueError(
                    f"segment_many requires uniform shapes: imgs[{i}] is "
                    f"{img.shape[:2]}, imgs[0] is {(H, W)} — use "
                    "segment_stream for mixed-shape batches.")
            # the pinned buffers take imgs[0]'s channels and dtype
            if (img.shape, img.dtype) != (imgs[0].shape, imgs[0].dtype):
                raise ValueError(
                    f"segment_many requires uniform shapes: imgs[{i}] is "
                    f"{img.shape} {img.dtype}, imgs[0] is {imgs[0].shape} "
                    f"{imgs[0].dtype} — use segment_stream for mixed-shape "
                    "batches.")
        t0 = time.perf_counter()
        if self.device.type == "cuda":
            results = self._many_pipelined(imgs, stride)
        else:
            results = []
            for img in imgs:
                res = self._fetch(*self._launch(img, stride, _no_mark),
                                  _no_mark)
                del res["probs"]
                results.append((res, time.perf_counter()))
        out, prev = [], t0
        for res, done in results:
            res["seconds"], res["completed_s"] = done - prev, done - t0
            out.append(res)
            prev = done
        return out

    def _many_pipelined(self, imgs: List[np.ndarray], stride: int):
        """``segment_many`` on a CUDA device -> [(result, host time of its
        completion)].

        Per photo k the main thread copies the photo into a pinned buffer
        and starts its upload on a copy stream, then launches photo
        k - 1's compute on the current stream behind the upload's event,
        then the class map's copy into a pinned buffer with an event of
        its own; a worker thread waits for that event, copies the class
        map out and colourizes it.  A pinned buffer is rewritten only
        after the event (photos) or the worker (class maps) that read it
        last."""
        device = self.device
        megapixels = imgs[0].shape[0] * imgs[0].shape[1] / 1e6
        compute = torch.cuda.current_stream(device)
        copy = torch.cuda.Stream(device)
        slots = min(MANY_BUFFERS, len(imgs))
        pinned_in = [torch.empty(imgs[0].shape,
                                 dtype=torch.from_numpy(imgs[0][:0]).dtype,
                                 pin_memory=True) for _ in range(slots)]
        pinned_out = [torch.empty(imgs[0].shape[:2], dtype=torch.uint8,
                                  pin_memory=True) for _ in range(slots)]
        uploaded: List[Optional[torch.cuda.Event]] = [None] * slots

        def upload(k: int) -> torch.Tensor:
            slot = k % slots
            if uploaded[slot] is not None:
                uploaded[slot].synchronize()  # the buffer's last copy
            np.copyto(pinned_in[slot].numpy(), imgs[k])
            with torch.cuda.stream(copy):
                dev = pinned_in[slot].to(device, non_blocking=True)
                uploaded[slot] = torch.cuda.Event()
                uploaded[slot].record(copy)
            # allocated on the copy stream, read on the compute stream: the
            # allocator must not hand it out again before those reads end
            dev.record_stream(compute)
            return dev

        def finish(slot: int, fetched: torch.cuda.Event):
            fetched.synchronize()
            class_map = pinned_out[slot].numpy().copy()
            mask_rgb = native.colourize(class_map, self.palette)
            return ({"mask_rgb": mask_rgb, "class_map": class_map,
                     "megapixels": megapixels}, time.perf_counter())

        futures = []
        with ThreadPoolExecutor(max_workers=1) as worker:
            dev = upload(0)
            for k in range(len(imgs)):
                slot = k % slots
                ready = uploaded[slot]
                nxt = upload(k + 1) if k + 1 < len(imgs) else None
                compute.wait_event(ready)
                class_map, _ = self._compute(dev, stride, _no_mark)
                if k >= slots:
                    futures[k - slots].result()  # frees pinned_out[slot]
                pinned_out[slot].copy_(class_map, non_blocking=True)
                fetched = torch.cuda.Event()
                fetched.record(compute)
                futures.append(worker.submit(finish, slot, fetched))
                dev = nxt
            return [f.result() for f in futures]

    def segment_stream(self, items, stride: Optional[int] = None):
        """Generator over (tag, fitted image) pairs with one image of
        lookahead: image k+1's device work is enqueued before image k's
        class map is fetched.  Yields (tag, result dict) in order."""
        stride = stride or self.cfg.tile_size // 2
        pending = None
        for tag, img in items:
            nxt = (tag, time.perf_counter(),
                   self._launch(img, stride, _no_mark))
            if pending is not None:
                yield self._finish_stream(*pending)
            pending = nxt
        if pending is not None:
            yield self._finish_stream(*pending)

    def _finish_stream(self, tag, t0, launched):
        res = self._fetch(*launched, _no_mark)
        res["seconds"] = time.perf_counter() - t0
        return tag, res

    def segment_file(self, img_path: str, scale: Optional[float] = None,
                     stride: Optional[int] = None) -> Dict:
        """One image file: decode -> scale -> fit to the tile grid ->
        segment -> resize the mask back to the scaled size (nearest)."""
        import cv2

        cfg = self.cfg
        stride = stride or cfg.tile_size // 2
        img, w_full, h_full, w_scaled, h_scaled = get_image(
            img_path, cfg.ch, scale=scale or cfg.scale,
            tile_size=cfg.tile_size)
        fitted, w_fit, h_fit, offset = adjust_to_tile(
            img, cfg.tile_size, stride)
        res = self.segment_array(fitted, stride)
        res["mask_rgb"] = cv2.resize(
            res["mask_rgb"], (w_scaled, h_scaled),
            interpolation=cv2.INTER_NEAREST)
        n_rows, n_cols = grid_dims(w_fit, h_fit, cfg.tile_size, stride)
        res["extract"] = {
            "fid": (img_path.split("/")[-1].replace(".", "_")
                    + "_scale_" + str(scale or cfg.scale)),
            "n": n_rows * n_cols,
            "w_full": w_full, "h_full": h_full,
            "w_scaled": w_scaled, "h_scaled": h_scaled,
            "w_fitted": w_fit, "h_fitted": h_fit, "offset": offset,
        }
        return res


def _no_mark(name: str) -> None:
    pass
