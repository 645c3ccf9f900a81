"""Full-image inference: tile -> batched forward -> stitch -> (CRF) ->
argmax -> colourize.

Port of ``pylc_tpu/infer.py``.  PyTorch runs eagerly, so
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

On a mesh of devices (``Segmenter(mesh=...)``, ``parallel/``) the photo
goes through in row bands, one per device: each band is uploaded to its
device, which forwards and stitches it, and the CRF runs band by band.

``segment_many`` pipelines a sequence of same-shape photos on CUDA, on one
device or on a mesh (photo k + 1's upload, every band of it on its
device's copy stream from pinned memory, while photo k computes; the
class map's download without blocking the host; the colourize of photo k
on a worker thread while the main thread launches photo k + 1); eager
PyTorch overlaps none of this by itself.
"""

from __future__ import annotations

import copy
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from pylc_tpu_torch import native
from pylc_tpu_torch.config import Config
from pylc_tpu_torch.models.layers import resize_bilinear_align_corners
from pylc_tpu_torch.ops.tiles import grid_dims, stitch_probs, unfold_tiles
from pylc_tpu_torch.parallel import banded_infer as BI
from pylc_tpu_torch.parallel.mesh import Mesh, shard_batch
from pylc_tpu_torch.parallel.sharded_crf import (can_shard_crf,
                                                 mean_field_sharded)
from pylc_tpu_torch.parallel.sharded_stitch import gather_rows
from pylc_tpu_torch.utils.imageio import load_fitted, restore_size

#: tile sets larger than this keep their probabilities in bf16 (the
#: stitch still sums in f32); 3 decimal digits on [0, 1] keep the argmax
PROBS_BF16_BYTES = 256 * 2 ** 20

STAGES = ("h2d", "forward_stitch", "crf", "d2h", "colourize")

#: pinned host buffers ``segment_many`` rotates, for the photos (all of a
#: photo's bands in one) and for the class maps: one in a copy while the
#: host fills or reads the other
MANY_BUFFERS = 2


class Segmenter:
    """Batched tile -> mask inference for one loaded model on one device,
    or on a mesh of devices.

    predict_fn: uint8 [B, t, t, C] on ``device`` -> f32 logits
    [B, t, t, K] (``train_state.make_predict``, or
    ``quant.make_predict_int8``).  crf: optional (canvas [H, W, K],
    guide [H, W, C]) -> refined canvas.

    mesh: optional ``parallel.mesh.Mesh`` whose first device is
    ``device``; the network is replicated once on each of its other
    distinct devices (``predict_fn.remake`` on a copy of
    ``predict_fn.model``, so an int8 predict stays int8).  Where
    ``can_band`` holds, each device uploads,
    forwards and stitches its own row band of the photo
    (``parallel/banded_infer.py``), else the tile batch is split over the
    devices and stitched on the first.  The CRF (from ``make_crf``) runs
    row-banded with K1 on every band where ``can_shard_crf`` holds, else
    on the first device; these are the JAX package's geometry rules, and
    ``mesh_routes`` names the route a photo takes.  The class map and the
    canvas come back on the first device.  ``segment_many`` pipelines its
    photos on a CUDA mesh as on one CUDA device: each distinct device
    uploads its bands on a copy stream of its own."""

    def __init__(self, cfg: Config, predict_fn: Callable,
                 device: torch.device, batch_size: int = 16,
                 crf: Optional[Callable] = None, mesh=None):
        self.cfg = cfg
        self.predict = predict_fn
        self.device = torch.device(device)
        self.batch_size = batch_size
        self.crf = crf
        self.mesh = mesh
        self._predicts = {}
        if mesh is not None:
            if mesh.devices[0] != Mesh([self.device]).devices[0]:
                raise ValueError(f"the mesh's first device is "
                                 f"{mesh.devices[0]}, the Segmenter's "
                                 f"{self.device}")
            for dev in mesh.distinct[1:]:
                replica = copy.deepcopy(predict_fn.model).to(dev)
                self._predicts[dev] = predict_fn.remake(replica)
        self.palette = np.asarray(cfg.palette_rgb, np.uint8)
        native.available()  # builds the host library now, not in a timing

    def _probs_dtype(self, n_tiles: int) -> torch.dtype:
        """bf16 tile probabilities for a large photo's tile set (the whole
        photo's, whatever the device's share), else f32."""
        tile = self.cfg.tile_size
        return torch.bfloat16 if \
            n_tiles * tile * tile * self.cfg.n_classes * 4 > PROBS_BF16_BYTES \
            else torch.float32

    def _tile_probs(self, tiles: torch.Tensor, dtype: torch.dtype
                    ) -> torch.Tensor:
        """Class probabilities [N, t, t, K] of ``tiles`` [N, t, t, C], on
        the tiles' device, in batches of ``batch_size``."""
        tile = self.cfg.tile_size
        predict = self._predicts.get(tiles.device, self.predict)
        n_tiles = tiles.shape[0]
        probs = torch.empty((n_tiles, tile, tile, self.cfg.n_classes),
                            dtype=dtype, device=tiles.device)
        # the last batch runs short: BatchNorm is in eval mode, so padding
        # it (as a fixed-length scan must) changes nothing
        for i in range(0, n_tiles, self.batch_size):
            logits = predict(tiles[i:i + self.batch_size])
            if logits.shape[1] != tile:  # valid-conv U-Net: 324 of 512
                logits = resize_bilinear_align_corners(
                    logits.permute(0, 3, 1, 2), tile, tile
                ).permute(0, 2, 3, 1)
            probs[i:i + self.batch_size] = torch.softmax(logits, dim=-1)
        return probs

    def _canvas(self, img: torch.Tensor, stride: int) -> torch.Tensor:
        """Tile, forward and stitch a fitted [H, W, C] uint8 image on the
        device -> [H, W, K] f32 probability canvas."""
        tile = self.cfg.tile_size
        H, W = img.shape[:2]
        n_rows, n_cols = grid_dims(W, H, tile, stride)
        probs = self._tile_probs(unfold_tiles(img, tile, stride),
                                 self._probs_dtype(n_rows * n_cols))
        return stitch_probs(probs, n_rows, n_cols, tile, stride)

    def mesh_routes(self, H: int, W: int, stride: int) -> Dict[str, str]:
        """The route of an H x W photo over the mesh: 'forward_stitch' is
        'banded' or 'tile-split', 'crf' (with a CRF) 'banded' or
        'one-device'."""
        n = self.mesh.size
        routes = {"forward_stitch": "banded" if BI.can_band(
            H, W, self.cfg.tile_size, stride, n) else "tile-split"}
        if self.crf is not None:
            params = getattr(self.crf, "params", None)
            routes["crf"] = "banded" if params is not None and \
                can_shard_crf(H, params, n) else "one-device"
        return routes

    def _layout(self, H: int, W: int, stride: int
                ) -> Tuple[Optional[BI.BandPlan], List[torch.device]]:
        """How an H x W photo goes to the devices: (plan, devices), the
        row bands of ``plan`` (``BI.plan_bands``) one to each device, or
        with no plan the whole photo to ``devices[0]`` (one device, or
        the mesh's tile-split route)."""
        if self.mesh is None:
            return None, [self.device]
        if self.mesh_routes(H, W, stride)["forward_stitch"] == "tile-split":
            return None, [self.mesh.devices[0]]
        return (BI.plan_bands(H, W, self.cfg.tile_size, stride,
                              self.mesh.size), list(self.mesh.devices))

    def _host_parts(self, img: np.ndarray, stride: int,
                    out: Optional[np.ndarray] = None) -> np.ndarray:
        """[n, h, W, C]: what device i of ``_layout`` uploads is part i,
        written into ``out`` where it is given."""
        plan, _ = self._layout(*img.shape[:2], stride)
        if plan is not None:
            return BI.split_bands(img, plan, out)
        if out is None:
            return np.ascontiguousarray(img)[None]
        np.copyto(out[0], img)
        return out

    def _upload(self, img: np.ndarray, stride: int) -> List[torch.Tensor]:
        """One [H, W, C] photo onto the devices: its parts
        (``_host_parts``), each on its device of ``_layout``."""
        _, devices = self._layout(*img.shape[:2], stride)
        parts = self._host_parts(img, stride)
        return [torch.from_numpy(p).to(d, non_blocking=True)
                for p, d in zip(parts, devices)]

    def _compute_parts(self, parts: Sequence[torch.Tensor], H: int, W: int,
                       stride: int, mark: Callable[[str], None]):
        """Enqueue the device work for one H x W photo from its parts
        (``_upload``) -> (class map, canvas), both on the (first) device.
        On a mesh: the forward and stitch (of each band on its device, or
        of the tile batch split over the devices), the CRF (banded or on
        the first device, per ``mesh_routes``), the argmax on the first
        device."""
        if self.mesh is None:
            return self._compute(parts[0], stride, mark)
        mesh, dev0, tile = self.mesh, self.mesh.devices[0], self.cfg.tile_size
        n_rows, n_cols = grid_dims(W, H, tile, stride)
        dtype = self._probs_dtype(n_rows * n_cols)
        routes = self.mesh_routes(H, W, stride)
        plan, _ = self._layout(H, W, stride)
        if plan is not None:
            canvas = BI.run_banded(parts, lambda t: self._tile_probs(t, dtype),
                                   n_cols, tile, stride, mesh, plan)
            guide = BI.banded_guide(parts, plan)
        else:
            guide = parts[0]
            tiles = shard_batch(mesh, unfold_tiles(guide, tile, stride))
            probs = torch.cat([self._tile_probs(t, dtype).to(dev0)
                               for t in tiles])
            canvas = [stitch_probs(probs, n_rows, n_cols, tile, stride)]
        mark("forward_stitch")
        if routes.get("crf") == "banded":
            canvas = mean_field_sharded(canvas, guide, self.crf.params, mesh)
        else:
            canvas = gather_rows(canvas, dev0)
            if self.crf is not None:
                canvas = self.crf(canvas, gather_rows(
                    [guide] if isinstance(guide, torch.Tensor) else guide,
                    dev0))
        mark("crf")
        return canvas.argmax(dim=-1).to(torch.uint8), canvas

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
        H, W = img.shape[:2]
        parts = self._upload(img, stride)
        mark("h2d")
        class_map, canvas = self._compute_parts(parts, H, W, stride, mark)
        return class_map, canvas, H * W / 1e6

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
        devices = [self.device] if self.mesh is None else self.mesh.distinct
        # events time one stream: with several cards, each stage ends by
        # waiting for all of them and is read from the host clock
        cuda = self.device.type == "cuda" and len(devices) == 1
        host, events = [], []

        def mark(name):
            if cuda:
                events.append(torch.cuda.Event(enable_timing=True))
                events[-1].record()
            elif self.device.type == "cuda":
                for d in devices:
                    torch.cuda.synchronize(d)
            host.append(time.perf_counter())

        if self.device.type == "cuda":
            for d in devices:
                torch.cuda.synchronize(d)
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
        photos from one camera), pipelined on a CUDA device or mesh.

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
        """``segment_many`` on CUDA -> [(result, host time of its
        completion)].

        Per photo k the main thread writes the photo's parts (the photo,
        or its row bands on a mesh: ``_layout``) into a pinned buffer and
        starts each part's upload on its device's copy stream, then
        launches photo k - 1's compute on the devices' current streams,
        each behind the upload events of its own parts, then the class
        map's copy from the first device into a pinned buffer with an
        event of its own; a worker thread waits for that event, copies the
        class map out and colourizes it.  A pinned buffer is rewritten only
        after the events (photos) or the worker (class maps) that read it
        last.  Every copy between devices inside the compute (halos, the
        gather onto the first device) runs on the devices' current
        streams, which PyTorch orders against each other."""
        H, W = imgs[0].shape[:2]
        megapixels = H * W / 1e6
        plan, devices = self._layout(H, W, stride)
        computes = {d: torch.cuda.current_stream(d) for d in devices}
        copies = {d: torch.cuda.Stream(d) for d in computes}
        shape = (1, H, W) if plan is None else (plan.n_dev, plan.band_h, W)
        slots = min(MANY_BUFFERS, len(imgs))
        pinned_in = [torch.empty(shape + imgs[0].shape[2:],
                                 dtype=torch.from_numpy(imgs[0][:0]).dtype,
                                 pin_memory=True) for _ in range(slots)]
        pinned_out = [torch.empty((H, W), dtype=torch.uint8, pin_memory=True)
                      for _ in range(slots)]
        uploaded: List[List[torch.cuda.Event]] = [[] for _ in range(slots)]

        def upload(k: int) -> List[torch.Tensor]:
            slot = k % slots
            for done in uploaded[slot]:
                done.synchronize()  # the buffer's last copies
            self._host_parts(imgs[k], stride, out=pinned_in[slot].numpy())
            parts, uploaded[slot] = [], []
            for part, dev in zip(pinned_in[slot], devices):
                with torch.cuda.stream(copies[dev]):
                    parts.append(part.to(dev, non_blocking=True))
                    uploaded[slot].append(torch.cuda.Event())
                    uploaded[slot][-1].record(copies[dev])
                # allocated on the copy stream, read on the compute stream:
                # the allocator must not hand it out again before those
                # reads end
                parts[-1].record_stream(computes[dev])
            return parts

        def finish(slot: int, fetched: torch.cuda.Event):
            fetched.synchronize()
            class_map = pinned_out[slot].numpy().copy()
            mask_rgb = native.colourize(class_map, self.palette)
            return ({"mask_rgb": mask_rgb, "class_map": class_map,
                     "megapixels": megapixels}, time.perf_counter())

        futures = []
        with ThreadPoolExecutor(max_workers=1) as worker:
            parts = upload(0)
            for k in range(len(imgs)):
                slot = k % slots
                ready = uploaded[slot]
                nxt = upload(k + 1) if k + 1 < len(imgs) else None
                for dev, done in zip(devices, ready):
                    computes[dev].wait_event(done)
                class_map, _ = self._compute_parts(parts, H, W, stride,
                                                   _no_mark)
                if k >= slots:
                    futures[k - slots].result()  # frees pinned_out[slot]
                pinned_out[slot].copy_(class_map, non_blocking=True)
                fetched = torch.cuda.Event()
                fetched.record(computes[devices[0]])
                futures.append(worker.submit(finish, slot, fetched))
                parts = nxt
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
        cfg = self.cfg
        stride = stride or cfg.tile_size // 2
        fitted, extract = load_fitted(img_path, cfg.ch, scale or cfg.scale,
                                      cfg.tile_size, stride)
        return self.segment_fitted(fitted, extract, stride)

    def segment_fitted(self, fitted: np.ndarray, extract: Dict,
                       stride: int) -> Dict:
        """``segment_file`` after the decode: ``fitted`` and ``extract``
        from ``utils.imageio.load_fitted``."""
        res = self.segment_array(fitted, stride)
        res["mask_rgb"] = restore_size(res["mask_rgb"], extract)
        res["extract"] = extract
        return res


def _no_mark(name: str) -> None:
    pass
