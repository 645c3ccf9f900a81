"""Hermetic serving artifacts: one file that holds the fitted canvas
program of a ``Segmenter`` with its weights, loadable without the model
zoo or a checkpoint.

Port of ``pylc_tpu/export.py`` on ``torch.export``.  The program is
``Segmenter._compute`` for one (H, W, stride) geometry: unfold, the
batched forward (under bf16 autocast where the model serves in bf16),
softmax, stitch, the optional dense CRF and the uint8 argmax, traced
into an ``ExportedProgram`` with the weights inside.  The CRF's
iteration is the custom operator ``pylc::crf_iteration``
(``ops/kernels/crf_kernel.py``): the program records one call of it per
iteration, and a process that imports that module (as ``ServingModel.
load`` does) runs it on kernel K1 on a card and on its plain version on
the CPU.  ``torch.export`` does not lower across devices: an artifact runs
on the device type it was exported on.

Artifact layout (one file, magic ``PYLCT\\x01``; the JAX package's
``.pylcx`` starts with ``PYLCX\\x01``, so neither package mistakes the
other's file):

    6 bytes   magic
    4 bytes   big-endian header length
    N bytes   header JSON (shape contract, palette, schema labels, the
              torch version, the device and its CUDA capability)
    rest      the program, written by ``torch.export.save``
"""

from __future__ import annotations

import io
import json
import os
import struct
from typing import Dict, Optional, Sequence

import numpy as np
import torch

MAGIC = b"PYLCT\x01"
JAX_MAGIC = b"PYLCX\x01"  # pylc_tpu/export.py's artifacts


class _CanvasProgram(torch.nn.Module):
    """``Segmenter._compute`` at one stride as a module: uint8
    [H, W, ch] -> uint8 class map [H, W].  The network is a submodule, so
    its weights are the program's parameters."""

    def __init__(self, seg, stride: int):
        super().__init__()
        model = getattr(seg.predict, "model", None)
        if not isinstance(model, torch.nn.Module):
            raise ValueError(
                "export needs a Segmenter whose predict_fn comes from "
                "train_state.make_predict (it carries the network)")
        self.model = model
        self._seg = seg
        self.stride = stride

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        from pylc_tpu_torch.infer import _no_mark
        class_map, _ = self._seg._compute(img, self.stride, _no_mark)
        return class_map


def export_segmenter(seg, H: int, W: int, stride: Optional[int] = None,
                     platforms: Optional[Sequence[str]] = None):
    """Export one canvas program from a live ``Segmenter`` on its device.

    Returns a ``torch.export.ExportedProgram`` whose input is one uint8
    [H, W, ch] tensor on that device.  ``platforms`` may name only the
    Segmenter's own device type: torch.export does not lower a program for
    a device it does not run on.  A Segmenter on a mesh is refused, as in
    the JAX package: serving scales out by replicas."""
    if seg.mesh is not None:
        raise ValueError(
            "export requires a single-device Segmenter (mesh=None); "
            "serving scale-out is replica-parallel (docs/DEPLOY.md)")
    stride = stride or seg.cfg.tile_size // 2
    device = seg.device
    if platforms is not None and list(platforms) != [device.type]:
        raise ValueError(
            f"platforms {list(platforms)}: torch.export lowers only for "
            f"the device the export runs on ({device.type}); export on the "
            f"target device, or pass --platforms {device.type}")
    example = torch.zeros((H, W, seg.cfg.ch), dtype=torch.uint8,
                          device=device)
    return torch.export.export(_CanvasProgram(seg, stride), (example,))


def _header(seg, H: int, W: int, stride: int) -> Dict:
    cfg = seg.cfg
    device = seg.device
    capability = list(torch.cuda.get_device_capability(device)) \
        if device.type == "cuda" else None
    return {
        "h": H, "w": W, "ch": cfg.ch, "stride": stride,
        "tile_size": cfg.tile_size,
        "n_classes": cfg.n_classes,
        "schema_name": cfg.schema_name,
        "class_labels": list(cfg.class_labels),
        "palette_rgb": [list(c) for c in cfg.palette_rgb],
        "model_id": cfg.id,
        "arch": cfg.arch, "backbone": cfg.backbone,
        "crf": seg.crf is not None,
        "torch_version": torch.__version__,
        "device": device.type,
        "cuda_capability": capability,
    }


def save_artifact(path: str, seg, H: int, W: int,
                  stride: Optional[int] = None,
                  platforms: Optional[Sequence[str]] = None) -> Dict:
    """Export and write a serving artifact; returns its header."""
    stride = stride or seg.cfg.tile_size // 2
    program = export_segmenter(seg, H, W, stride, platforms)
    header = _header(seg, H, W, stride)
    hdr = json.dumps(header).encode()
    blob = io.BytesIO()
    torch.export.save(program, blob)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack(">I", len(hdr)))
        f.write(hdr)
        f.write(blob.getvalue())
    os.replace(tmp, path)  # atomic, as checkpoint.py writes
    return header


class ServingModel:
    """A loaded serving artifact: a fitted photo -> class map and mask.

    Imports no model code: only the artifact, torch, the CRF operator's
    module and the host colourize.  The program is shape-specialized;
    ``segment`` checks the contract and raises with the expected
    geometry."""

    def __init__(self, meta: Dict, program, device: torch.device):
        self.meta = meta
        self.device = device
        self._program = program
        self._fn = program.module()
        self._palette = np.asarray(meta["palette_rgb"], np.uint8)

    @classmethod
    def load(cls, path: str, device: Optional[str] = None
             ) -> "ServingModel":
        """Read an artifact.  It runs on the device type it was exported
        on (``device`` may name that type, or an index of it); a CUDA
        artifact raises where no card is visible."""
        from pylc_tpu_torch.device import resolve_device
        # registers pylc::crf_iteration, which a program with the CRF
        # calls, and pylc::quantize_int8 / pylc::int8_conv2d, which an int8
        # Segmenter's program calls (quant.make_predict_int8)
        from pylc_tpu_torch.ops.kernels import crf_kernel  # noqa: F401
        from pylc_tpu_torch.ops.kernels import int8_conv  # noqa: F401

        with open(path, "rb") as f:
            magic = f.read(len(MAGIC))
            if magic == JAX_MAGIC:
                raise ValueError(
                    f"{path}: a JAX package artifact (pylc_tpu/export.py, "
                    "magic PYLCX); the port reads only its own "
                    "(pylc_tpu_torch/export.py, magic PYLCT)")
            if magic != MAGIC:
                raise ValueError(f"{path}: not a PYLCT artifact")
            (n,) = struct.unpack(">I", f.read(4))
            meta = json.loads(f.read(n).decode())
            blob = f.read()
        want = resolve_device(device or meta["device"])
        if want.type != meta["device"]:
            raise ValueError(
                f"{path} was exported for {meta['device']} and runs only "
                f"there (asked for {want}); export again on {want.type}")
        return cls(meta, torch.export.load(io.BytesIO(blob)), want)

    def segment(self, img: np.ndarray) -> Dict:
        """Segment a fitted [H, W, ch] uint8 image (the artifact's exact
        geometry).  Returns ``class_map`` [H, W] u8 and ``mask_rgb``
        [H, W, 3] u8."""
        from pylc_tpu_torch import native

        m = self.meta
        if img.ndim == 2:
            img = img[..., None]
        want = (m["h"], m["w"], m["ch"])
        if tuple(img.shape) != want or img.dtype != np.uint8:
            raise ValueError(
                f"artifact expects uint8 {want}, got "
                f"{img.dtype} {tuple(img.shape)} — fit the source with "
                f"adjust_to_tile(tile_size={m['tile_size']}) first")
        dev = torch.from_numpy(np.ascontiguousarray(img)).to(self.device)
        with torch.inference_mode():
            class_map = self._fn(dev).cpu().numpy()
        return {"class_map": class_map,
                "mask_rgb": native.colourize(class_map, self._palette)}
