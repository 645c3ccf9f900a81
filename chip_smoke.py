"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failed check raises, and the script exits non-zero:

  [build]  nvcc builds both kernel libraries from the checkout's sources
           and g++ the host palette library, in parallel: K1 (the
           dense-CRF mean-field iteration, csrc/crf_iteration.cu), K2a/K2b
           (the fused CE+Dice+Focal loss forward and backward,
           csrc/fused_loss.cu) with their register and spill reports, and
           csrc/host_lut.cpp.
  [k1]     K1 against its plain torch version at the serving shape (the
           tiled kernel), at 1024x1792 with schema_b's 11 classes beside
           a grayscale photo, at a ragged shape of each of the four tiled
           instantiations; at the narrow sizes (at most 16 classes
           outside the tiled list, on the wide kernel's instantiations) on
           the slice's 1024x1792 grid at r = 2, 4, 5, 6, 7 and 8, with 11
           classes and a grayscale guide at r = 5 and 8, with 16 and with
           6 classes at r = 3, and at ragged shapes of 1 to 16 classes and
           r = 1 to 8 (one per instantiation; the largest, 16 classes and
           a 4-channel guide at r = 8), and on the generic kernel at r = 0;
           on the wide kernel (17 to 128 classes) at 20 classes on the
           slice's 1024x1792 grid at r = 3, 6 and 8, at 64 and 128 classes
           on 512x512 (128 at r = 3 and 8), and at ragged shapes of 17 to
           128 classes and r = 0 to 8 (one per instantiation; the largest,
           128 classes and a 4-channel guide at r = 8); per shape the
           kernel that ran, its time, the plain version's, the simple
           form's (the generic or simple wide kernel, in turns with it)
           and the bound.  Fails if a tiled, narrow or wide instantiation
           or the generic kernel was not launched.
  [k2]     K2a and K2b against their plain versions at the training
           slice's [8, 9, 512, 512] channels_last logits (weighted and
           not), at a ragged channels_last [3, 9, 61, 53], a ragged
           contiguous [1, 11, 37, 29] and a ragged channels_last
           [2, 6, 45, 37], these with targets outside [0, C); at
           schema_b's [8, 11, 512, 512] and a ragged [3, 11, 61, 53],
           both channels_last, and at the U-Net's [8, 9, 324, 324]
           channels_last; at every other class count up to 16 (a user's
           own schema, each class count on kernels of its own) on a
           ragged shape, channels_last (and at 12 classes contiguous too),
           targets outside [0, C), and at [8, C, 512, 512] channels_last
           for C = 6, 8, 12 and 16; on the wide kernels (17 to 128
           classes) at [2, 20, 61, 53] and [2, 128, 37, 29], channels_last
           (K2a's and K2b's wide staged kernels) and contiguous (their
           wide kernels), at [2, 33, 61, 53] channels_last, and at the
           train steps' [8, 20, 512, 512] and [8, 128, 512, 512]
           channels_last: K2a's 3C + 4 statistics entry by entry and the
           losses from them, K2a and K2b twice for bit-equal results,
           K2b's dlogits against the plain backward fed by the plain
           forward, and the direct kernels of K2a and K2b held to the same
           limits; per shape the kernels that ran, the times (each in
           turns with its direct kernel) and the bounds.  Fails if an
           instantiation (K2a's and K2b's direct kernels and K2b's staged
           kernel, each at every class count from 1 to 16) or a wide or
           wide staged kernel was not launched.
  [net]    the f32 network on the card against the same network on the
           CPU.
  [slice]  the segmentation path: ``Segmenter`` with the CRF on, at full
           width (DeepLabV3+/ResNet101, OS16, schema_a, 512 px tiles at
           stride 256) on a seeded 3584x2048 photo, with random weights
           from a seeded ``torch.Generator`` that go through a
           reference-schema ``.pth`` and ``load_pth_model``.
  [many]   the archive path: 4 seeded 3584x2048 photos through
           ``Segmenter.segment_many`` (pinned buffers, a copy stream, the
           colourize on a worker thread) and the same 4 through
           ``segment_array`` one after the other, in turns: every class
           map and mask equal, K1 launched 5 x 4 times, total wall and
           MP/s of both, each photo's completion time, peak memory, and
           the device's busy time per photo under ``torch.profiler``.
  [radius] ``test --crf_radius 5`` and ``8``: [slice]'s model through its
           ``.pth`` with the CRF at radius 5, then 8, each on a seeded
           3584x2048 photo, K1 as ``narrow<R=5>`` and ``narrow<R=8>`` 5
           times per photo, the class map against the plain CRF.
  [cli]    the ``test`` CLI on a 3872x2592 JPEG.
  [serve]  the serving path: ``server.build_service`` on [slice]'s
           ``.pth`` with the CRF, behind a ThreadingHTTPServer on an
           ephemeral port; POSTs of [cli]'s JPEG (first and warm latency,
           every mask PNG equal to ``Segmenter.segment_file``'s, K1 5
           times per POST, ``/healthz``'s count, one POST under
           ``utils.tracing.trace`` with the server's regions found in the
           trace); then ``export.save_artifact`` of the same Segmenter at
           the photo's fitted 3584x2048 with the CRF, loaded in a process
           that imports no ``pylc_tpu_torch.models``: export and load
           seconds, ms per photo against the live path's, K1 5 times per
           photo inside the program, the class map against the live
           Segmenter's; then the ``export`` and ``serve`` CLI modes (on the
           card by default) on the same ``.pth`` and photo.
  [wide]   a user's 20-class schema: DeepLabV3+/ResNet101 with the CRF on
           a 1024x1024 photo, K1 on its wide kernel (r = 3), the class
           map against the plain CRF; 5 train steps at 512 px, batch 8,
           K2a and K2b on their wide staged kernels once per step, the
           loss falling.
  [schema] users' own schemas of 6 and 16 classes (generated): 5 train
           steps each of DeepLabV3+/ResNet101 at full width, 512 px,
           batch 8, bf16, AdamW, the fused loss on K2a ``direct<C>`` and
           K2b ``staged<C>`` once per step, the loss finite and falling.
  [train]  the training path: ``trainer.train`` at full width (512 px,
           batch 8, bf16 autocast, AdamW with step_lr, clip 0.5, the fused
           loss on K2a/K2b) on an in-memory DB of 40 seeded tiles for 2
           epochs, from seeded He-normal weights; the JAX package's files
           it writes beside its own (``checkpoint.ckpt`` and
           ``<model_id>.ckpt`` with their ``.meta``, the seconds of each
           save in each format): ``checkpoint.ckpt`` through
           ``convert.load_ckpt_checkpoint`` into a fresh model, optimizer
           and scheduler equals ``checkpoint.pth`` bit for bit (weights,
           statistics, moments, step counts, lrs); the best model's
           ``.pth`` and ``.ckpt`` load through ``tester.load_model`` and
           segment a 1024x1024 photo to the same class map; then 10 timed
           steps on one fixed batch, whose loss must fall, one of them
           under ``torch.profiler``.
  [remat]  ``remat_backbone``: the f32 remat step of DeepLabV3+/ResNet101
           against the plain one (TF32 off, cudnn.deterministic, batch 2:
           losses and running statistics within REMAT_RTOL, every gradient
           within it plus a second plain run's distance); the bf16 train
           step at 512 px (AdamW, the fused loss) with remat off and on in
           turns at batch 8 and 32: ms per step, peak memory, a profiled
           step's kernel launches and device time, K2a and K2b once per
           step; one step each way of DeepLab on Xception, MobileNetV2 and
           DRN-D-54 at batch 8 with their peak memory.
  [resume] a run carried across the JAX package's checkpoint: 3 bf16
           steps of DeepLabV3+/ResNet101 (AdamW, head_lr_mult 10), its
           model, optimizer and schedule through a ``checkpoint.ckpt`` in
           the JAX package's layout into a fresh model and optimizer (equal
           bit for bit), then 2 more steps in f32 with TF32 off on the
           resumed run, the run and a torch-native copy of it (the resumed
           run within 4 times the copy's distance from the run), K2a and
           K2b once per step.
  [multi]  several devices and ranks, on the one card: [slice]'s
           DeepLabV3+/ResNet101 weights and 3584x2048 photo with the CRF
           through ``Segmenter(mesh=Mesh([cuda:0] * n))`` for n = 2, 3, 4
           (row bands: the banded forward, the stitch with its spill halo,
           K1 on each band of h_loc + 2r rows with an r-row halo exchanged
           every iteration; n = 3 pads the tile grid 7 -> 9 rows and the CRF
           grid 1024 -> 1026), timed in turns with the one-device path: the
           class maps against one device's (>= 99.99%) and the canvas
           within MULTI_CANVAS_ATOL at a batch of one tile row (every
           forward call in both paths a full batch of one shape), >= 99.9%
           at batch 16; K1 5 x n times per photo on bands of the
           planned height, and K1 on an extended band against K1 on the
           whole grid row for row; the archive path on each mesh: 4 seeded
           3584x2048 photos through ``segment_many`` (each band uploaded on
           a copy stream from pinned memory) and through ``segment_array``
           one by one, timed many, one by one, one by one, many, every
           class map and mask equal, K1 5 x n x 4 times in the first
           pass, total wall, MP/s, the ratio and each photo's completion
           time; then 2 ranks on cuda:0 under gloo
           (``parallel.mesh.spawn``): MULTI_STEPS f32 SGD steps at batch 4
           each (TF32 off, every bn3.weight x RESIDUAL_GAIN, dropout 0)
           against one process at batch 8 on the same rows (first-step
           losses rtol 1e-5, updates within MULTI_UPDATE_RTOL), bf16 steps
           timed beside the gradients' all-reduce alone, then
           ``trainer.train`` on the ranks (K2a/K2b once per step per rank,
           rank 0 alone writes); and ``trainer.train`` on one rank under
           NCCL.
  [data]   the data-preparation path at an archive's size: 4 seeded
           3872x2592 photos (``utils/synthetic.textured_scene``, JPEG)
           with palette-exact schema_a masks (PNG) through ``Extractor``
           (512 px tiles at stride 512), ``Augmentor.optimize`` and
           ``oversample`` on an in-memory DB, then 2 steps of
           ``trainer.train`` (DeepLabV3+/ResNet101, batch 8, bf16, the
           fused loss) on the first 20 augmented tiles.  The same
           extraction on the CPU gives the same bytes and meta; the
           profile's histograms are equal and its means and stds within
           1e-5; ``optimize`` is equal; ``oversample`` at the same seed on
           the CPU agrees (masks equal, images within 1 grey level, each
           on 99.9% of the pixels); K2a and K2b run once per step.  Per
           photo the extraction's seconds and MP/s, one photo's stages,
           the profile's and ``optimize``'s seconds, the warped tiles per
           second, the device's busy share of the profile and of
           ``oversample`` (``torch.profiler``), and the peak memory.
  [zoo]    the rest of the model zoo at full width and depth, seeded
           weights: for each of eight models (DeepLab on Xception,
           MobileNetV2 and DRN-D-54; U-Net and ResUNet with ``upsample``;
           U-Net with ``upconv``; a DeepLab with instance and a U-Net with
           layer norm) the f32 network on the card against the CPU on 2
           tiles; a U-Net (schema_a) on a 3584x2048 photo and a
           DeepLab/Xception (schema_b, grayscale) on the same photo in
           grayscale, bf16 with the CRF on: stage times, MP/s, peak
           memory, K1 launched 5 times per photo (the Xception's as
           ``tiled<C=11,G=1,R=3>``), canvas rows summing to 1, the class
           map against the plain-CRF run; MobileNetV2, DRN-D-54 and
           ResUNet on a 1024x1024 photo each, the same checks; 5 train
           steps on one fixed batch of 8 for the U-Net and for
           DeepLab/Xception on schema_b: finite, the loss falls, K2a and
           K2b once per step on the kernels the layout names, ms per step,
           peak memory; the U-Net's best model written by
           ``checkpoint.Checkpoint``, loaded by ``tester.load_model`` and
           segmenting a 1024x1024 photo.

A hand-written kernel's time (``ms``) is the mean over one CUDA graph of
50 of its wrapper's launches (``graph_ms``): the card's time, whatever the
host's.  Beside it stands ``host_loop_ms``, the mean over 50 launches from
a loop on the host (``cuda_ms``), which is what the scripts before this
one measured.

Output: per-phase lines, then one JSON line with every kernel, the
card's ``name, power.limit`` line, and last a JSON line
{"ok": true, "device": {...}}.  Without a CUDA device it prints no result
and exits non-zero.
"""

from __future__ import annotations

import copy
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
SLICE_HW = (2048, 3584)        # bench.py's 3872x2592 photo, fitted
CLI_PHOTO_HW = (2592, 3872)
K1_SHAPES = [                  # (C, G, H, W, r)
    (9, 3, 1024, 1792, 3),     # the slice: schema_a on the 2x-pooled grid
    (11, 1, 1024, 1792, 3),    # schema_b beside a grayscale photo
    # ragged (W not a multiple of 4, H not of 8), one per tiled kernel
    (9, 3, 37, 70, 3),
    (11, 3, 37, 70, 3),
    (9, 1, 45, 53, 3),
    (11, 1, 29, 66, 3),
    # at most 16 classes outside the tiled list (the wide kernel, named
    # narrow<R=r> there) on the slice's grid at other radii, schema_b's
    # classes beside a grayscale photo at r = 5, 16 classes and a 6-class
    # schema
    (9, 3, 1024, 1792, 2),
    (9, 3, 1024, 1792, 4),
    (9, 3, 1024, 1792, 5),
    (11, 1, 1024, 1792, 5),
    (16, 3, 1024, 1792, 3),
    (6, 3, 1024, 1792, 3),
    # ragged, one per radius, at 1 to 16 classes (r = 0, no window: the
    # generic kernel)
    (1, 1, 37, 70, 0),
    (6, 3, 45, 53, 1),
    (16, 4, 29, 66, 2),
    (11, 3, 37, 70, 2),        # schema_b's classes
    (1, 3, 37, 70, 3),
    (6, 1, 45, 53, 4),
    (16, 3, 37, 70, 5),
    (5, 2, 45, 53, 6),         # one window row a thread (r = 6 to 8)
    (9, 3, 37, 70, 7),
    (16, 4, 29, 66, 8),        # the largest narrow size
    # radii 6 to 8 on the slice's grid: schema_a, and schema_b beside a
    # grayscale photo at r = 8
    (9, 3, 1024, 1792, 6),
    (9, 3, 1024, 1792, 7),
    (9, 3, 1024, 1792, 8),
    (11, 1, 1024, 1792, 8),
    # more classes than the generic kernel holds: the wide kernel, one
    # shape per radius (the simple wide kernel in turns with each)
    (20, 3, 1024, 1792, 3),    # a 20-class schema on the slice's grid
    (64, 3, 512, 512, 3),      # wider schemas, where the plain version
    (128, 3, 512, 512, 3),     # still fits the card
    (17, 3, 37, 70, 3),        # ragged, one class past the generic kernel
    (20, 3, 37, 70, 3),
    (128, 3, 37, 70, 3),       # the largest class count
    (17, 1, 37, 70, 0),
    (31, 4, 45, 53, 1),
    (33, 3, 29, 66, 2),
    (104, 3, 37, 70, 4),
    (128, 4, 37, 70, 5),       # the largest sizes of row pairs
    (24, 3, 45, 53, 6),        # one window row a thread (r = 6 to 8)
    (40, 2, 37, 70, 7),
    (20, 4, 29, 66, 8),
    (128, 4, 37, 70, 8),       # the largest sizes the wide kernel takes
    (20, 3, 1024, 1792, 6),    # a 20-class schema at r = 6 and 8
    (20, 3, 1024, 1792, 8),
    (128, 3, 512, 512, 8),
]
K1_ATOL = 1e-5                 # f32, no fast math; measured ~2e-7
CRF_AGREEMENT = 0.999          # class maps, kernel CRF vs plain CRF
N_PHOTOS = 3                   # timed runs of the slice after one warm-up
MANY_PHOTOS = 4                # the archive path's photos, at SLICE_HW
K2_SHAPES = [   # (B, C, H, W, channels_last, weighted, targets outside)
    (8, 9, 512, 512, True, False, False),   # the training slice
    (8, 9, 512, 512, True, True, False),
    # ragged: a K2a block (4,096 pixels of one image) gets 12 whole chunks
    # of 256 and one of 161
    (3, 9, 61, 53, True, True, True),
    (1, 11, 37, 29, False, True, True),     # ragged, contiguous NCHW
    (2, 6, 45, 37, True, True, True),       # ragged, a 6-class schema
    (8, 11, 512, 512, True, True, False),   # schema_b's train step
    (3, 11, 61, 53, True, True, True),      # ragged, targets 255 and 11
    # the U-Net's train step: 104,976 pixels per image, 410 chunks of 256
    # and one of 16
    (8, 9, 324, 324, True, False, False),
    # every other class count up to 16 (a user's --schema), each on kernels
    # of its own: ragged, channels_last (K2b staged, its direct kernel in
    # turns), at 12 classes contiguous too, then the train steps' shapes
    (2, 1, 45, 37, True, False, True),
    (3, 2, 61, 53, True, False, True),
    (1, 3, 37, 29, True, True, True),
    (2, 4, 33, 65, True, True, True),
    (2, 5, 45, 37, True, True, True),
    (3, 7, 61, 53, True, True, True),
    (2, 8, 45, 37, True, True, True),
    (1, 10, 37, 29, True, True, True),
    (2, 12, 45, 37, True, True, True),
    (2, 12, 37, 29, False, True, True),
    (1, 13, 61, 53, True, False, True),
    (2, 14, 37, 29, True, True, True),
    (1, 15, 45, 37, True, True, True),
    (2, 16, 61, 53, True, True, True),
    (8, 6, 512, 512, True, False, False),
    (8, 8, 512, 512, True, False, False),
    (8, 12, 512, 512, True, False, False),
    (8, 16, 512, 512, True, False, False),
]
# wider class counts than the register-held kernels take: K2a's and K2b's
# wide kernels, channels_last and contiguous, targets outside [0, C)
K2_WIDE_SHAPES = [
    (2, 20, 61, 53, True, True, True),
    (2, 20, 61, 53, False, True, True),
    (2, 128, 37, 29, True, True, True),
    (2, 128, 37, 29, False, False, True),
    (8, 20, 512, 512, True, False, False),  # a 20-class train step's
    (8, 128, 512, 512, True, False, False),  # the largest class count's
    (2, 33, 61, 53, True, True, True),  # K2b's wide span of 128 pixels
]
# the instantiations that [k2] must have launched: every class count up to
# 16 has its own
K2_CLASS_COUNTS = range(1, 17)
K2A_MUST_RUN = {f"direct<C={C}>" for C in K2_CLASS_COUNTS} | {"wide",
                                                              "wide-staged"}
K2B_MUST_RUN = {f"{kind}<C={C}>" for C in K2_CLASS_COUNTS
                for kind in ("staged", "direct")} | {"wide", "wide-staged"}
# f32, no fast math.  Both sides sum millions of terms in different
# orders (the kernel: per-block tree then a double-precision pass; torch:
# its own reduction tree), hence relative limits.
K2_ACC_RTOL = 1e-5             # per entry of the 3C + 4 statistics: each is
                               # a sum of non-negative terms, so the order
                               # moves it by ~log2(N) eps_f32 of itself
K2_LOSS_RTOL = 1e-5            # on total, ce, dice and focal
K2_DX_RTOL = 1e-5              # on dlogits, times max |dlogits|
# The card's peaks for the bounds (NVIDIA's data sheet, H100 SXM): device
# memory, and fp32 outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOP_PER_S = 67e12
TRAIN_TILES = 40               # in-memory DB, 512 px
TRAIN_EPOCHS = 2
FIXED_STEPS = 10               # timed steps on one fixed batch
TRAIN_PHOTO_HW = (1024, 1024)  # segmented by the trained model
RESIDUAL_GAIN = 0.03           # see phase_zoo's network checks
DATA_PHOTOS = 4                # [data]: seeded photo and mask pairs
DATA_PHOTO_HW = (2592, 3872)   # bench.py's photo and the archive's scans
DATA_TRAIN_TILES = 20          # of the augmented DB: 16 train, 4 valid
DATA_STEPS = 2                 # train steps of 8 tiles on them
DATA_AGREEMENT = 0.999         # oversample card vs CPU, pixel share
DATA_PROFILE_RTOL = 1e-5       # px_mean / px_std, card vs CPU (f32 sums)
ZOO_STEPS = 5                  # train steps on one fixed batch, per model
ZOO_PHOTO_HW = (1024, 1024)    # MobileNetV2, DRN-D-54 and ResUNet
RADIUS_PHOTO_R = (5, 8)        # [radius]: `test --crf_radius 5` and 8
WIDE_CLASSES = 20              # [wide]: a user's schema past 16 classes
SCHEMA_CLASSES = (6, 16)       # [schema]: users' schemas up to 16 classes
WIDE_PHOTO_HW = (1024, 1024)
MULTI_BANDS = (2, 3, 4)        # [multi]: Mesh([cuda:0] * n)
MULTI_AGREEMENT = 0.9999       # class maps, banded against one device, at
                               # a batch of one tile row, so that every
                               # forward call in either path is a full batch
                               # of one shape (equal expected)
MULTI_CANVAS_ATOL = 1e-4       # the canvas there: the stitch sums a block of
                               # two bands' tiles in another order (f32
                               # rounding), and the CRF carries that through
                               # 5 iterations
# At the default batch of 16 the paths' short last batches differ (a band
# ends its own), cuDNN picks its bf16 algorithm by batch shape, and near-ties
# of the random weights flip: one device at batch 16 against batch 13 agrees
# on 0.9974 of the pixels.  The banded photo at batch 16 is held to the
# agreement [slice] holds the kernel CRF to, CRF_AGREEMENT.
MULTI_STEPS = 3                # f32 steps, 2 ranks against one process
MULTI_LOSS_RTOL = 1e-5         # first-step losses (global K2 sums)
MULTI_UPDATE_RTOL = 1e-3       # each parameter's update after MULTI_STEPS,
                               # of its norm plus the whole update's: cuDNN
                               # picks other algorithms at batch 4 and 8
MULTI_BF16_STEPS = 5           # timed bf16 steps per rank after a warm-up
MULTI_TRAIN_TILES = 20         # trainer.train on the ranks: 16 train, 4 valid
SERVE_WARM = 5                 # [serve]: warm POSTs after the first
REMAT_BATCHES = (8, 32)        # [remat]: the train step with and without
REMAT_STEPS = 5                # timed steps per block, blocks off/on/on/off
REMAT_BACKBONES = ("xception", "mobilenet", "drn")  # one step each way
# A remat step replays the plain step's operations on the same inputs
# (equality expected), but the bilinear upsample's backward adds with
# atomics on the card, so two runs of the same step differ by rounding.
# Each gradient is held within REMAT_RTOL of its norm plus the whole
# gradient's, plus four times the distance of a second plain run; the
# losses and the running statistics (forward only) within REMAT_RTOL.
REMAT_RTOL = 1e-6
RESUME_STEPS = (3, 2)  # [resume]: bf16 steps before the carry, f32 after
# [resume]: the carried model, optimizer and schedule equal the run's bit for
# bit.  The steps after it are not bit-reproducible on the card even with
# cudnn.deterministic: the bilinear upsample's, the max-pool's and the
# average pool's backwards add with atomics.  In bf16 the rounding carries
# that into every tensor (on an H100: 0.24 of a bn3 bias's largest entry
# after 2 steps), so the steps after the carry run in f32 with TF32 off.
# The resumed run and a torch-native copy of the run (load_state_dict at
# the carry) each step on beside it, and the resumed run's distance from
# the run is held within 4 times the copy's, plus RESUME_RTOL of the run's
# update over those steps (an optimizer that lost its moments moves every
# parameter by about the lr).
RESUME_RTOL = 1e-7
ARTIFACT_PHOTOS = 5            # timed photos through the loaded artifact


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, n: int, warmup: int = 2) -> float:
    """Mean device milliseconds of ``fn`` over ``n`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def graph_ms(fn, n: int) -> float:
    """Mean device milliseconds of ``fn`` over ``n`` calls replayed from
    one CUDA graph: what the launches take on the card with no host time
    between them.  A loop on the host measures the host instead wherever
    a launch costs it more than the kernel costs the card, which for the
    loss kernels (tens of microseconds) depends on the machine."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def bound(n_bytes: float, n_flop: float):
    """(least ms the card could take, which side binds): the larger of
    the bytes over the memory rate and the operations over the fp32 rate."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_flop = n_flop / PEAK_FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_flop else (t_flop, "operations")


def k1_bound(C, G, H, W, r):
    """K1 reads q, u [C, H, W] and g [G, H, W] once and writes [C, H, W].
    Per pixel and window offset the least it must do: one FMA a class
    (2C flop: both messages are linear in the same q, so their weights
    fold into one coefficient), the guide distance (3G), the weight (about
    8: the exp and two products), its sum (1) and the coefficient (one
    FMA, 2)."""
    window = (2 * r + 1) ** 2 - 1
    return bound((3 * C + G) * H * W * 4,
                 H * W * window * (2 * C + 3 * G + 11))


def k2_bounds(B, C, H, W):
    """(K2a, K2b): K2a reads the logits and the uint8 targets once and
    writes 3C + 4 floats; K2b reads the same and the statistics and writes
    dlogits.  Operations per pixel, counted from the formulas: a softmax
    (about 12 per class with its exp), the focal term (about 40), and for
    K2b three gradient terms (about 10 per class)."""
    N = B * H * W
    read = N * C * 4 + N + C * 4
    return (bound(read + (3 * C + 4) * 4, N * (15 * C + 40)),
            bound(read + (3 * C + 4) * 4 + N * C * 4, N * (22 * C + 60)))


def in_turns(a, b, n: int):
    """Mean device ms of ``a`` and of ``b``, timed a, b, b, a, each from
    a CUDA graph of ``n`` launches."""
    a1, b1, b2, a2 = (graph_ms(f, n) for f in (a, b, b, a))
    return (a1 + a2) / 2, (b1 + b2) / 2


def plain_crf(params):
    """The CRF of ``ops/crf.py`` step by step, with every iteration done
    by the plain torch version instead of the kernel."""
    from pylc_tpu_torch.ops.crf import _pool, _upsample
    from pylc_tpu_torch.ops.kernels.crf_kernel import crf_iteration_reference

    def crf(canvas, guide):
        H, W, _ = canvas.shape
        k = params.downsample
        q, g = _pool(canvas.float(), k), _pool(guide.float(), k)
        u = torch.log(q + params.eps).permute(2, 0, 1).contiguous()
        q = q.permute(2, 0, 1).contiguous()
        g = g.permute(2, 0, 1).contiguous()
        for _ in range(params.n_iters):
            q = crf_iteration_reference(
                q, g, u, params.radius, params.sigma_spatial_app,
                params.sigma_color, params.sigma_spatial_sm,
                params.w_appearance, params.w_smoothness, params.eps)
        q = _upsample(q.permute(1, 2, 0), H, W, k)
        return q / q.sum(dim=-1, keepdim=True)

    return crf


def phase_build():
    """Every library from source, one compiler each, started together.
    Fails if the host palette library does not build in C++."""
    from pylc_tpu_torch import native
    from pylc_tpu_torch.ops.kernels import _build, crf_kernel, fused_loss

    def timed(build):
        t0 = time.perf_counter()
        path, report = build(force=True)
        return path, report, time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=3) as ex:
        futs = [ex.submit(timed, k.build)
                for k in (crf_kernel, fused_loss, native)]
        results = [f.result() for f in futs]
    log(f"[build] nvcc {' '.join(_build.NVCC_FLAGS)} and g++ "
        f"{' '.join(_build.GXX_FLAGS)}: all built in "
        f"{time.perf_counter() - t0:.2f} s")
    for path, report, secs in results:
        log(f"[build] -> {os.path.relpath(path, REPO)} in {secs:.2f} s")
        for line in report.splitlines():
            if "Compiling entry" in line or "registers" in line \
                    or "spill" in line:
                log(f"[build]   {line.strip()}")
    if not native.available():
        raise AssertionError("the host palette library (csrc/host_lut.cpp) "
                             "did not build: no g++ on this machine")


def phase_k1(device):
    """K1 against crf_iteration_reference on the card, and beside it the
    simple form of each size (the generic kernel, or the simple wide
    kernel past 16 classes: what the tiled, narrow and wide kernels
    replace), timed in turns.  Returns the worst error, the
    slice shape's numbers and every shape's (the kernel that ran, its
    error, times and bound)."""
    from pylc_tpu_torch.ops.kernels.crf_kernel import (
        TILED_SIZES, WIDE_MAX_RADIUS, crf_iteration, crf_iteration_generic,
        crf_iteration_reference, variant)
    sig = (3.0, 13.0, 1.5, 3.0, 1.0, 1e-8)
    worst, at_slice, checked = 0.0, None, []
    for C, G, H, W, r in K1_SHAPES:
        rng = np.random.default_rng(C * 1000 + H)
        q = rng.random((C, H, W)).astype(np.float32)
        q /= q.sum(0, keepdims=True)
        g = rng.integers(0, 256, (G, H, W)).astype(np.float32)
        u = np.log(q + 1e-8)
        q, g, u = (torch.from_numpy(a).to(device) for a in (q, g, u))
        name = variant(C, G, r)
        got = crf_iteration(q, g, u, r, *sig)
        generic = crf_iteration_generic(q, g, u, r, *sig)
        want = crf_iteration_reference(q, g, u, r, *sig)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        generic_err = (generic - want).abs().max().item()
        generic_ms, ms = in_turns(
            lambda: crf_iteration_generic(q, g, u, r, *sig),
            lambda: crf_iteration(q, g, u, r, *sig), 50)
        host_ms = cuda_ms(lambda: crf_iteration(q, g, u, r, *sig), 50)
        plain_ms = cuda_ms(lambda: crf_iteration_reference(q, g, u, r, *sig),
                           10)
        bound_ms, bound_by = k1_bound(C, G, H, W, r)
        simple = "generic kernel" if C <= 16 else "simple wide kernel"
        log(f"[k1] C={C} G={G} {H}x{W} r={r}: {name} max_abs_err {err:.3e} "
            f"(limit {K1_ATOL:g}); kernel {ms:.4f} ms/iter from a graph, "
            f"{host_ms:.4f} from a host loop, plain {plain_ms:.4f} "
            f"ms/iter, {simple} {generic_ms:.4f} ms/iter (max_abs_err "
            f"{generic_err:.3e}); bound {bound_ms:.4f} ms by {bound_by}, "
            f"share {bound_ms / ms:.3f}")
        for what, e in (("K1", err), (f"K1's {simple}", generic_err)):
            if not e <= K1_ATOL:
                raise AssertionError(f"{what} disagrees with its plain "
                                     f"version: {e} > {K1_ATOL}")
        worst = max(worst, err)
        numbers = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                   "bound_by": bound_by, "variant": name,
                   "generic_ms": generic_ms, "host_loop_ms": host_ms}
        checked.append(dict(numbers, shape=[C, G, H, W, r], max_abs_err=err,
                            share_of_bound=bound_ms / ms))
        if at_slice is None:
            at_slice = numbers
    if not at_slice["variant"].startswith("tiled"):
        raise AssertionError(f"the slice's shape ran {at_slice['variant']}, "
                             "not a tiled instantiation")
    must = {variant(*size) for size in TILED_SIZES} | {"generic"} | {
        f"wide<R={r}>" for r in range(WIDE_MAX_RADIUS + 1)} | {
        f"narrow<R={r}>" for r in range(1, WIDE_MAX_RADIUS + 1)}
    missing = must - {c["variant"] for c in checked}
    if missing:
        raise AssertionError(f"kernels of K1 that no shape launched: "
                             f"{sorted(missing)}")
    return worst, at_slice, checked


def phase_k2(device):
    """K2a and K2b, the kernel each layout gets (and beside it the
    direct kernel of each, timed in turns), against fused_forward_reference
    and fused_backward_reference on the card."""
    from pylc_tpu_torch.ops.kernels import fused_loss as fl
    from pylc_tpu_torch.ops.kernels.fused_loss import (
        backward_variant, forward_variant, fused_backward_reference,
        fused_forward_reference, fused_loss_backward,
        fused_loss_backward_direct, fused_loss_forward,
        fused_loss_forward_direct, losses_from_acc)
    from pylc_tpu_torch.ops.losses import LossWeights
    worst_loss, worst_dx, at_slice = 0.0, 0.0, None
    checked = {"fwd": [], "bwd": []}
    for B, C, H, W, cl, weighted, outside in K2_SHAPES + K2_WIDE_SHAPES:
        rng = np.random.default_rng(B * 100 + C)
        x = torch.from_numpy(
            rng.normal(size=(B, C, H, W)).astype(np.float32) * 3).to(device)
        if cl:
            x = x.contiguous(memory_format=torch.channels_last)
        t = rng.integers(0, C, (B, H, W)).astype(np.uint8)
        if outside:   # targets outside [0, C): no class
            t[rng.random(t.shape) < 0.1] = 255
            t[rng.random(t.shape) < 0.05] = C
        t = torch.from_numpy(t).to(device)
        cw = torch.from_numpy((rng.random(C) + 0.2).astype(np.float32)
                              ).to(device)
        w = LossWeights(weighted=weighted)
        ct = torch.tensor(0.75, device=device)
        acc = fused_loss_forward(x, t, cw, w)
        acc_again = fused_loss_forward(x, t, cw, w)
        acc_direct = fused_loss_forward_direct(x, t, cw, w)
        acc_ref = fused_forward_reference(x, t, cw, w)
        # each side's backward from its own forward: a fault of K2a that
        # reaches the gradient shows in dlogits too
        dx = fused_loss_backward(x, t, cw, acc, ct, w)
        dx_again = fused_loss_backward(x, t, cw, acc, ct, w)
        dx_direct = fused_loss_backward_direct(x, t, cw, acc, ct, w)
        dx_ref = fused_backward_reference(x, t, cw, acc_ref, ct, w)
        torch.cuda.synchronize()
        if dx.stride() != x.stride():
            raise AssertionError(f"dlogits strides {dx.stride()} are not "
                                 f"the logits' {x.stride()}")
        if not torch.equal(acc, acc_again):
            raise AssertionError(f"two launches of K2a on the same input "
                                 f"differ: {acc.tolist()} vs "
                                 f"{acc_again.tolist()}")
        if not torch.equal(dx, dx_again):
            raise AssertionError("two launches of K2b on the same input "
                                 "differ")
        del dx_again
        fwd_name, name = forward_variant(x), backward_variant(x)
        lib = fl._library()
        codes = {"K2a": (lib.fused_loss_forward_variant(
                     x.data_ptr(), C, H * W, x.stride(0), x.stride(1),
                     fl._pixel_stride(x)), fwd_name),
                 "K2b": (lib.fused_loss_backward_variant(
                     x.data_ptr(), dx.data_ptr(), C, H * W, x.stride(0),
                     x.stride(1), fl._pixel_stride(x)), name)}
        for what, (code, said) in codes.items():
            if fl.VARIANTS[code].format(C=C) != said:
                raise AssertionError(f"the library dispatches {what} to "
                                     f"variant {code}, the wrapper says "
                                     f"{said}")

        def rel_bad(a):
            """(largest relative error, statistics past K2_ACC_RTOL)."""
            diff = (a - acc_ref).abs()
            return ((diff / acc_ref.abs()).nan_to_num(0.0).max().item(),
                    int((~(diff <= K2_ACC_RTOL * acc_ref.abs())).sum()))

        (acc_rel, acc_bad), (direct_rel, direct_bad) = (
            rel_bad(acc), rel_bad(acc_direct))
        want = torch.stack(losses_from_acc(acc_ref, C, w))
        got = torch.stack(losses_from_acc(acc, C, w))
        loss_err = (got - want).abs().max().item()
        # 0 / 0: both exactly 0 (CE at one class)
        loss_rel = ((got - want).abs() / want.abs()).nan_to_num(0.0
                                                                ).max().item()
        dx_err = (dx - dx_ref).abs().max().item()
        direct_err = (dx_direct - dx_ref).abs().max().item()
        dx_scale = dx_ref.abs().max().item()
        fwd_direct_ms, fwd_ms = in_turns(
            lambda: fused_loss_forward_direct(x, t, cw, w),
            lambda: fused_loss_forward(x, t, cw, w), 50)
        fwd_host = cuda_ms(lambda: fused_loss_forward(x, t, cw, w), 50)
        fwd_plain = cuda_ms(lambda: fused_forward_reference(x, t, cw, w), 5)
        direct_ms, bwd_ms = in_turns(
            lambda: fused_loss_backward_direct(x, t, cw, acc, ct, w),
            lambda: fused_loss_backward(x, t, cw, acc, ct, w), 50)
        bwd_host = cuda_ms(
            lambda: fused_loss_backward(x, t, cw, acc, ct, w), 50)
        bwd_plain = cuda_ms(
            lambda: fused_backward_reference(x, t, cw, acc, ct, w), 5)
        (fwd_bound, fwd_by), (bwd_bound, bwd_by) = k2_bounds(B, C, H, W)
        layout = "channels_last" if cl else "contiguous"
        log(f"[k2] [{B},{C},{H},{W}] {layout} weighted={weighted}: losses "
            f"(total, ce, dice, focal) {[round(v, 6) for v in got.tolist()]}"
            f" max_abs_err {loss_err:.3e} max_rel_err {loss_rel:.3e} "
            f"(limit {K2_LOSS_RTOL:g}); statistics ({3 * C + 4} entries) "
            f"max_rel_err {acc_rel:.3e} (limit {K2_ACC_RTOL:g} each), two "
            f"launches bit-equal (K2a and K2b); dlogits max_abs_err "
            f"{dx_err:.3e} at max "
            f"|dx| {dx_scale:.3e} (limit {K2_DX_RTOL:g} x max)")
        # launches back to back on one input: what of the logits fits the
        # 50 MB L2 is read from there
        log(f"[k2]   K2a {fwd_name} {fwd_ms:.4f} ms from a graph, "
            f"{fwd_host:.4f} ms from a host loop, plain {fwd_plain:.4f} "
            f"ms, direct kernel {fwd_direct_ms:.4f} ms (statistics "
            f"max_rel_err {direct_rel:.3e}), bound {fwd_bound:.4f} ms by "
            f"{fwd_by}, share {fwd_bound / fwd_ms:.3f} "
            f"({fwd_bound / fwd_host:.3f} by the host loop); K2b {name} "
            f"{bwd_ms:.4f} ms from a graph, "
            f"{bwd_host:.4f} ms from a host loop, plain {bwd_plain:.4f} "
            f"ms, direct kernel {direct_ms:.4f} ms (max_abs_err "
            f"{direct_err:.3e}), bound {bwd_bound:.4f} ms by {bwd_by}, "
            f"share {bwd_bound / bwd_ms:.3f}")
        for what, bad, got_acc in (("K2a", acc_bad, acc),
                                   ("K2a's direct kernel", direct_bad,
                                    acc_direct)):
            if bad:
                raise AssertionError(
                    f"{what} disagrees with its plain version on {bad} of "
                    f"{3 * C + 4} statistics: {got_acc.tolist()} vs "
                    f"{acc_ref.tolist()}")
        if not loss_rel <= K2_LOSS_RTOL:
            raise AssertionError(f"K2a disagrees with its plain version on "
                                 f"the losses: relative {loss_rel} > "
                                 f"{K2_LOSS_RTOL}")
        for what, e in (("K2b", dx_err),
                        ("K2b's direct kernel", direct_err)):
            if not e <= K2_DX_RTOL * dx_scale:
                raise AssertionError(f"{what} disagrees with its plain "
                                     f"version: {e} > {K2_DX_RTOL} x "
                                     f"{dx_scale}")
        worst_loss, worst_dx = max(worst_loss, loss_err), max(worst_dx,
                                                              dx_err)
        numbers = {
            "fwd": {"ms": fwd_ms, "plain_ms": fwd_plain,
                    "bound_ms": fwd_bound, "bound_by": fwd_by,
                    "variant": fwd_name, "host_loop_ms": fwd_host,
                    "direct_ms": fwd_direct_ms},
            "bwd": {"ms": bwd_ms, "plain_ms": bwd_plain,
                    "bound_ms": bwd_bound, "bound_by": bwd_by,
                    "variant": name, "host_loop_ms": bwd_host,
                    "direct_ms": direct_ms}}
        shape = [B, C, H, W, layout]
        checked["fwd"].append(dict(
            numbers["fwd"], shape=shape, max_abs_err=loss_err,
            share_of_bound=fwd_bound / fwd_ms))
        checked["bwd"].append(dict(
            numbers["bwd"], shape=shape, max_abs_err=dx_err,
            share_of_bound=bwd_bound / bwd_ms))
        # the direct kernel of this class count, run beside whatever the
        # layout gets and held to the same limit (the wide kernels past 16
        # classes)
        if fwd_name == "wide-staged":
            checked["fwd"].append({
                "variant": "wide", "shape": shape,
                "max_rel_err": direct_rel, "ms": fwd_direct_ms,
                "bound_ms": fwd_bound, "bound_by": fwd_by,
                "share_of_bound": fwd_bound / fwd_direct_ms})
        if name != "wide":
            code = fl.backward_variant_code(x)
            checked["bwd"].append({
                "variant": fl.VARIANTS[3 if code == 4 else min(1, code)
                                       ].format(C=C),
                "shape": shape, "max_abs_err": direct_err, "ms": direct_ms,
                "bound_ms": bwd_bound, "bound_by": bwd_by,
                "share_of_bound": bwd_bound / direct_ms})
        if at_slice is None:
            at_slice = numbers
    ran = (at_slice["fwd"]["variant"], at_slice["bwd"]["variant"])
    if ran != ("direct<C=9>", "staged<C=9>"):
        raise AssertionError(f"the train step's layout ran K2a {ran[0]} and "
                             f"K2b {ran[1]}, not the compile-time class "
                             "count and the staged kernel")
    for what, must, key in (("K2a", K2A_MUST_RUN, "fwd"),
                            ("K2b", K2B_MUST_RUN, "bwd")):
        missing = must - {c["variant"] for c in checked[key]}
        if missing:
            raise AssertionError(f"compile-time instantiations of {what} "
                                 f"that no shape launched: {sorted(missing)}")
    for B, C, H, W, cl, _, _ in K2_SHAPES:
        want = [f"direct<C={C}>", f"staged<C={C}>" if cl or C == 1
                else f"direct<C={C}>"]
        got = [{c["variant"] for c in checked[key]
                if c["shape"] == [B, C, H, W, "channels_last" if cl
                                  else "contiguous"] and "plain_ms" in c}
               for key in ("fwd", "bwd")]
        if got != [{v} for v in want]:
            raise AssertionError(f"K2a and K2b at [{B},{C},{H},{W}] ran "
                                 f"{got}, not {want}")
    return worst_loss, worst_dx, at_slice, checked


def phase_network_check(model, cfg, device, tag="[net]"):
    """The network on the card in true f32 against the same network on
    the CPU, on two tiles: the tolerance of tests/test_golden_parity.py."""
    import copy

    from pylc_tpu_torch.train_state import make_predict
    f32 = cfg.replace(compute_dtype="float32")
    tiles = np.random.default_rng(7).integers(
        0, 255, (2, cfg.tile_size, cfg.tile_size, cfg.ch), dtype=np.uint8)
    t0 = time.perf_counter()
    want = make_predict(f32, copy.deepcopy(model).cpu())(
        torch.from_numpy(tiles)).numpy()
    cpu_s = time.perf_counter() - t0
    got = make_predict(f32, model)(torch.from_numpy(tiles).to(device))
    got = got.cpu().numpy()
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    agree = float(np.mean(got.argmax(-1) == want.argmax(-1)))
    log(f"{tag} f32 card vs CPU on 2 tiles of {cfg.tile_size} px (logits "
        f"{got.shape[1]} px; the CPU took {cpu_s:.1f} s): max_abs_err "
        f"{err:.3e} at logit scale {scale:.3e}; argmax agreement "
        f"{agree:.5f}")
    np.testing.assert_allclose(got, want, rtol=1e-3,
                               atol=max(5e-4, 1e-5 * scale))
    if agree < 0.999:
        raise AssertionError(f"f32 argmax agreement {agree} < 0.999")


def phase_slice(device, workdir, cfg_base=None, hw=SLICE_HW):
    """The main path: .pth round trip, Segmenter with the CRF on."""
    from pylc_tpu_torch.config import Config
    from pylc_tpu_torch.tester import load_model
    from pylc_tpu_torch.train_state import init_model

    cfg = cfg_base or Config()
    pth = os.path.join(workdir, "deeplab_resnet101_random.pth")
    model = init_model(cfg, seed=0)
    torch.save({"model": model.state_dict(), "meta": cfg.to_meta()}, pth)
    del model
    cfg, model, _ = load_model(pth, cfg, device)
    phase_network_check(model, cfg, device)
    photo = np.random.default_rng(0).integers(0, 255, (*hw, 3),
                                              dtype=np.uint8)
    launches, seg, _ = drive_photo("[slice]", cfg, model, device, photo,
                                   N_PHOTOS)
    return launches, pth, seg


def phase_radius(device, pth):
    """``test --crf_radius 5`` and ``8``: [slice]'s model and photo size
    with the CRF at each radius of RADIUS_PHOTO_R, K1 as ``narrow<R=r>``.
    Returns K1's launches by radius, each photo's count set to 0 just
    before it."""
    from pylc_tpu_torch.config import Config
    from pylc_tpu_torch.tester import load_model
    cfg, model, _ = load_model(pth, Config(), device)
    launches = {}
    for r in RADIUS_PHOTO_R:
        photo = np.random.default_rng(r).integers(0, 255, (*SLICE_HW, 3),
                                                  dtype=np.uint8)
        launches[r], _, _ = drive_photo(
            f"[radius] r={r}:", cfg.replace(crf_radius=r), model, device,
            photo, N_PHOTOS, f"narrow<R={r}>")
    return launches


def drive_photo(tag, cfg, model, device, photo, n_timed, k1_kind="tiled"):
    """``Segmenter.segment_array_staged`` with the CRF on, on one photo:
    a warm-up and ``n_timed`` timed runs with K1's count set to 0 just
    before them all, then the same photo with the plain CRF.  Checks the
    class map, the canvas and K1's launches (on a kernel whose name
    starts with ``k1_kind``); returns (K1 launches, the Segmenter, median
    seconds)."""
    from pylc_tpu_torch import native
    from pylc_tpu_torch.infer import Segmenter
    from pylc_tpu_torch.ops.crf import make_crf
    from pylc_tpu_torch.ops.kernels.crf_kernel import crf_iteration, variant
    from pylc_tpu_torch.train_state import make_predict
    predict = make_predict(cfg, model)  # compute_dtype bf16: autocast
    crf = make_crf(cfg)
    seg = Segmenter(cfg, predict, device, batch_size=16, crf=crf)
    hw = photo.shape[:2]
    n_classes = cfg.n_classes
    k1 = variant(n_classes, photo.shape[2] if photo.ndim == 3 else 1,
                 crf.params.radius)

    torch.cuda.reset_peak_memory_stats(device)
    crf_iteration.launches = 0
    runs = [seg.segment_array_staged(photo) for _ in range(1 + n_timed)]
    launches = crf_iteration.launches
    expect = len(runs) * crf.params.n_iters
    log(f"{tag} K1 {k1} launches {launches} over {len(runs)} photos "
        f"(expected {expect} = photos x crf_iters)")
    if launches != expect:
        raise AssertionError(f"K1 launched {launches} times, not {expect}")
    if not k1.startswith(k1_kind):
        raise AssertionError(f"the CRF of {tag} ran K1's {k1} kernel")
    peak = torch.cuda.max_memory_allocated(device)

    res = runs[-1]
    cm, canvas = res["class_map"], res["probs"]
    if cm.shape != hw or cm.dtype != np.uint8 or int(cm.max()) >= n_classes:
        raise AssertionError(f"class map {cm.shape} {cm.dtype} max "
                             f"{int(cm.max())}")
    if canvas.shape != (*hw, n_classes) or not torch.isfinite(canvas).all():
        raise AssertionError("canvas shape or NaN/inf")
    row_err = (canvas.sum(-1) - 1).abs().max().item()
    if not row_err <= 1e-3:
        raise AssertionError(f"canvas rows sum to 1 +- {row_err}")
    mp = res["megapixels"]
    for i, r in enumerate(runs[1:]):
        st = " ".join(f"{k} {v * 1e3:.2f} ms" for k, v in r["stages"].items())
        log(f"{tag} photo {i}: {r['seconds']:.4f} s, "
            f"{mp / r['seconds']:.3f} MP/s ({st})")
    secs = sorted(r["seconds"] for r in runs[1:])
    median = secs[len(secs) // 2]
    host = "C++ (csrc/host_lut.cpp)" if native.available() else "numpy"
    log(f"{tag} {cfg.arch}"
        f"{'/' + cfg.backbone if cfg.arch == 'deeplab' else ''} "
        f"{hw[1]}x{hw[0]}x{cfg.ch} ({mp:.3f} MP), {cfg.n_classes} classes, "
        f"compute {cfg.compute_dtype}, host colourize {host}: median "
        f"{median:.4f} s = "
        f"{mp / median:.3f} MP/s; peak device memory "
        f"{peak / 2 ** 30:.3f} GiB; canvas rows sum to 1 +- {row_err:.2e}")

    plain = Segmenter(cfg, predict, device, batch_size=16,
                      crf=plain_crf(crf.params))
    plain_res = [plain.segment_array_staged(photo) for _ in range(2)][-1]
    if crf_iteration.launches != launches:
        raise AssertionError("the plain CRF run launched K1")
    agree = float(np.mean(plain_res["class_map"] == cm))
    diff = (plain_res["probs"] - canvas).abs().max().item()
    log(f"{tag} plain-CRF rerun: crf stage "
        f"{plain_res['stages']['crf'] * 1e3:.2f} ms vs kernel "
        f"{res['stages']['crf'] * 1e3:.2f} ms; class-map agreement "
        f"{agree:.6f} (limit {CRF_AGREEMENT}); canvas max_abs_diff "
        f"{diff:.3e}")
    if agree < CRF_AGREEMENT:
        raise AssertionError(f"class maps agree on {agree} < {CRF_AGREEMENT}")
    return launches, seg, median


def profiled_many(seg, photos, device):
    """``seg.segment_many(photos)`` under ``torch.profiler`` -> (ms per
    photo on the compute stream, ms per photo of the profiled run)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize(device)  # the profiler's start is behind
        t0 = time.perf_counter()
        seg.segment_many(photos)
        torch.cuda.synchronize(device)
        wall = (time.perf_counter() - t0) / len(photos) * 1e3
    # all device events but the host-to-device copies: the photos' uploads
    # run on the copy stream beside the kernels, and everything else runs
    # on the compute stream, one after the other, so the sum is the time
    # that stream is busy
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and not e.key.startswith("Memcpy HtoD"))
    return busy / len(photos) / 1e3, wall


def phase_many(seg, device, hw=SLICE_HW):
    """The archive path: MANY_PHOTOS photos through segment_many and
    through segment_array one after the other, timed many, one by one,
    one by one, many."""
    from pylc_tpu_torch.ops.kernels.crf_kernel import crf_iteration
    rng = np.random.default_rng(21)
    photos = [rng.integers(0, 255, (*hw, 3), dtype=np.uint8)
              for _ in range(MANY_PHOTOS)]
    mp = MANY_PHOTOS * hw[0] * hw[1] / 1e6

    def many():
        out = seg.segment_many(photos)
        torch.cuda.synchronize(device)
        return out

    def one_by_one():
        out = []
        for photo in photos:
            res = seg.segment_array(photo)
            del res["probs"]  # 264 MB of canvas each
            out.append(res)
        return out

    def timed(fn):
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        out = fn()
        wall = time.perf_counter() - t0
        return out, wall, torch.cuda.max_memory_allocated(device)

    seg.segment_many(photos[:3])  # warm-up: pinned buffers, the stream
    crf_iteration.launches = 0
    got, wall_a, peak_many = timed(many)
    launches = crf_iteration.launches
    expect = MANY_PHOTOS * seg.crf.params.n_iters
    want, seq_a, peak_seq = timed(one_by_one)
    _, seq_b, _ = timed(one_by_one)
    _, wall_b, _ = timed(many)
    log(f"[many] K1 launches {launches} over {MANY_PHOTOS} photos through "
        f"segment_many (expected {expect} = photos x crf_iters)")
    if launches != expect:
        raise AssertionError(f"K1 launched {launches} times, not {expect}")
    if len(got) != MANY_PHOTOS:
        raise AssertionError(f"segment_many returned {len(got)} results")
    for i, (g, w) in enumerate(zip(got, want)):
        if "probs" in g or g["class_map"].shape != hw:
            raise AssertionError(f"photo {i}: keys {sorted(g)}, class map "
                                 f"{g['class_map'].shape}")
        if not (np.array_equal(g["class_map"], w["class_map"])
                and np.array_equal(g["mask_rgb"], w["mask_rgb"])):
            differ = float(np.mean(g["class_map"] != w["class_map"]))
            raise AssertionError(f"photo {i}: segment_many's class map "
                                 f"differs from segment_array's on "
                                 f"{differ:.6%} of pixels")
    total = sum(r["seconds"] for r in got)
    if abs(total - got[-1]["completed_s"]) > 1e-6:
        raise AssertionError("segment_many's seconds do not add up to the "
                             "last completion")
    log(f"[many] {MANY_PHOTOS} class maps and masks equal segment_array's; "
        f"completed_s {[round(r['completed_s'], 4) for r in got]}; seconds "
        f"{[round(r['seconds'], 4) for r in got]}")
    for name, walls, peak in (("segment_many", (wall_a, wall_b), peak_many),
                              ("segment_array one by one", (seq_a, seq_b),
                               peak_seq)):
        mean = sum(walls) / 2
        log(f"[many] {name}: total wall {walls[0]:.4f} s and {walls[1]:.4f} "
            f"s for {MANY_PHOTOS} photos of {hw[1]}x{hw[0]} ({mp:.1f} MP), "
            f"mean {mean / MANY_PHOTOS * 1e3:.2f} ms per photo = "
            f"{mp / mean:.3f} MP/s; peak device memory "
            f"{peak / 2 ** 30:.3f} GiB")
    log(f"[many] segment_many takes {(wall_a + wall_b) / (seq_a + seq_b):.3f}"
        " of the one-by-one wall (timed many, one by one, one by one, many)")

    busy_ms, profiled = profiled_many(seg, photos[:3], device)
    per_photo = (wall_a + wall_b) / 2 / MANY_PHOTOS * 1e3
    log(f"[many] profiled (3 photos): {busy_ms:.2f} ms per photo on the compute "
        f"stream (the uploads beside it left out); the profiled run took "
        f"{profiled:.2f} ms per photo with its fill (idle share "
        f"{1 - busy_ms / profiled:.3f}), the unprofiled run of "
        f"{MANY_PHOTOS} {per_photo:.2f} ms per photo (idle share "
        f"{1 - busy_ms / per_photo:.3f})")
    return launches


def _png_size(path):
    with open(path, "rb") as f:
        head = f.read(24)
    if head[:8] != b"\x89PNG\r\n\x1a\n":
        raise AssertionError(f"{path} is not a PNG")
    return int.from_bytes(head[16:20], "big"), int.from_bytes(head[20:24],
                                                             "big")


def phase_cli(pth, workdir):
    """``python -m pylc_tpu_torch test -l m.pth -i photo.jpg --crf`` on
    the card, on a JPEG written by a child process (the CLI decodes with
    cv2; this script does not import it)."""
    env = dict(os.environ, PYTHONPATH=REPO)
    photo = os.path.join(workdir, "photo.jpg")
    h, w = CLI_PHOTO_HW
    subprocess.run(
        [sys.executable, "-c",
         "import sys, cv2, numpy as np; "
         f"img = np.random.default_rng(1).integers(0, 255, ({h}, {w}, 3), "
         "dtype=np.uint8); sys.exit(0 if cv2.imwrite(sys.argv[1], img) "
         "else 1)", photo], check=True, env=env, timeout=120)
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "pylc_tpu_torch", "test", "-l", pth, "-i",
         photo, "--crf"], cwd=workdir, env=env, capture_output=True,
        text=True, timeout=600)
    if out.returncode != 0:
        raise AssertionError(f"CLI failed:\n{out.stdout}\n{out.stderr}")
    mask = os.path.join(workdir, "data", "outputs",
                        "pylc_deeplab_ch3_schema_a", "masks",
                        "photo_jpg_scale_1.0.png")
    size = _png_size(mask)
    if size != (w, h):
        raise AssertionError(f"CLI mask is {size}, photo is {(w, h)}")
    for line in out.stdout.strip().splitlines()[-1:]:
        log(f"[cli] {line.strip()}")
    log(f"[cli] mask {size[0]}x{size[1]} PNG written; process wall "
        f"{time.perf_counter() - t0:.1f} s (interpreter start, weights, "
        "kernel load, one photo)")


def write_schema(path: str, n_classes: int) -> str:
    """A schema file of ``n_classes`` classes with distinct colours, in
    the packaged schemas' format."""
    classes = [{"label": f"class {i}", "code": f"C{i}",
                "colour": {"rgb": [i, 255 - i, (7 * i) % 256],
                           "hex": "#%02x%02x%02x" % (i, 255 - i,
                                                     (7 * i) % 256)}}
               for i in range(n_classes)]
    with open(path, "w") as f:
        json.dump({"classes": classes}, f)
    return path


def phase_wide(device, workdir):
    """A user's schema of WIDE_CLASSES classes (more than the register-
    held kernels take): DeepLabV3+/ResNet101 at full width with the CRF
    on a 1024x1024 photo, K1 on its wide kernel, the class map against the
    plain CRF; then ZOO_STEPS train steps with the fused loss on K2a's and
    K2b's wide staged kernels.  Returns (K1 launches, (K2a, K2b
    launches))."""
    from pylc_tpu_torch.config import Config
    from pylc_tpu_torch.train_state import init_model
    cfg = Config(schema=write_schema(os.path.join(workdir, "wide.json"),
                                     WIDE_CLASSES))
    if cfg.n_classes != WIDE_CLASSES:
        raise AssertionError(f"the schema has {cfg.n_classes} classes")
    model = init_model(cfg, seed=6).to(device)
    photo = np.random.default_rng(61).integers(0, 255, (*WIDE_PHOTO_HW, 3),
                                               dtype=np.uint8)
    launches, _, _ = drive_photo(f"[wide] photo {WIDE_CLASSES} classes:", cfg,
                                 model, device, photo, N_PHOTOS, "wide<")
    k2a, k2b, _, _, _ = zoo_train_steps(
        f"deeplab/resnet {WIDE_CLASSES} classes", cfg, model, device,
        "[wide]", ("wide-staged", "wide-staged"))
    return launches, (k2a, k2b)


def phase_schema(device, workdir):
    """Users' own schemas of up to 16 classes: for each of SCHEMA_CLASSES
    a generated schema and DeepLabV3+/ResNet101 at full width, ZOO_STEPS
    train steps (512 px, batch 8, bf16, AdamW, the fused loss) with K2a
    on ``direct<C>`` and K2b on ``staged<C>`` once per step.  Returns
    {"schema<C>_train": (K2a launches, K2b launches)}."""
    from pylc_tpu_torch.config import Config
    from pylc_tpu_torch.train_state import init_model
    out = {}
    for C in SCHEMA_CLASSES:
        cfg = Config(schema=write_schema(
            os.path.join(workdir, f"schema{C}.json"), C))
        if cfg.n_classes != C:
            raise AssertionError(f"the schema has {cfg.n_classes} classes")
        k2a, k2b, _, _, _ = zoo_train_steps(
            f"deeplab/resnet {C} classes", cfg, init_model(cfg, seed=7 + C),
            device, "[schema]")
        out[f"schema{C}_train"] = (k2a, k2b)
        torch.cuda.empty_cache()
    return out


def _post(url: str, data: bytes, ctype: str = "image/jpeg"):
    """POST ``data`` -> (status, body bytes, seconds)."""
    import urllib.request
    req = urllib.request.Request(url, data=data,
                                 headers={"Content-Type": ctype})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=600) as r:
        body = r.read()
        status = r.status
    return status, body, time.perf_counter() - t0


ARTIFACT_CHILD = r"""
import json, sys, time
for m in ("pylc_tpu", "jax", "jaxlib", "flax", "pylc_tpu_torch.models"):
    sys.modules[m] = None
import numpy as np, torch
from pylc_tpu_torch.export import ServingModel
from pylc_tpu_torch.ops.kernels.crf_kernel import crf_iteration
from pylc_tpu_torch.server import SegmentationService
from pylc_tpu_torch.utils.imageio import load_fitted
path, photo, out, n = sys.argv[1], sys.argv[2], sys.argv[3], int(sys.argv[4])
t0 = time.perf_counter()
model = ServingModel.load(path)
load_s = time.perf_counter() - t0
m = model.meta
fitted, _ = load_fitted(photo, m["ch"], 1.0, m["tile_size"], m["stride"])
t0 = time.perf_counter()
model.segment(fitted)
first_s = time.perf_counter() - t0
crf_iteration.launches = 0
res = model.segment(fitted)
per_photo = crf_iteration.launches
secs = []
for _ in range(n):
    t0 = time.perf_counter()
    model.segment(fitted)
    secs.append(time.perf_counter() - t0)
np.save(out, res["class_map"])
with open(photo, "rb") as f:
    served = SegmentationService(serving_model=model).segment_bytes(f.read())
with open(out + ".png", "wb") as f:
    f.write(served["mask_png"])
zoo = sorted(k for k, v in sys.modules.items()
             if k.startswith("pylc_tpu_torch.models") and v is not None)
print(json.dumps({"load_s": load_s, "first_s": first_s,
                  "launches_per_photo": per_photo, "seconds": secs,
                  "device": str(model.device), "models_imported": zoo,
                  "geometry": served["geometry"]}))
"""


def phase_serve(device, workdir, pth):
    """The serving path: ``server.build_service`` on the [slice] ``.pth``
    with the CRF, behind a ThreadingHTTPServer on an ephemeral port,
    POSTs of [cli]'s 3872x2592 JPEG; then an artifact of the same
    Segmenter at the photo's fitted geometry, loaded in a process that
    imports no model code.  Returns (K1 launches of the POSTs, K1
    launches of the artifact's timed photos)."""
    import threading
    import urllib.request
    from http.server import ThreadingHTTPServer

    from pylc_tpu_torch.export import save_artifact
    from pylc_tpu_torch.ops.kernels.crf_kernel import crf_iteration
    from pylc_tpu_torch.server import _png_bytes, build_service, make_handler
    from pylc_tpu_torch.utils import tracing
    from pylc_tpu_torch.utils.imageio import load_fitted

    photo = os.path.join(workdir, "photo.jpg")  # [cli]'s
    with open(photo, "rb") as f:
        data = f.read()
    t0 = time.perf_counter()
    svc = build_service(pth, use_crf=True, device=str(device))
    log(f"[serve] build_service({os.path.basename(pth)}, use_crf=True) in "
        f"{time.perf_counter() - t0:.2f} s: {svc.info()['backend']} backend, "
        f"{svc.seg.cfg.arch}/{svc.seg.cfg.backbone}, CRF on")
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(svc))
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    url = f"http://127.0.0.1:{httpd.server_port}"
    try:
        crf_iteration.launches = 0
        status, first_png, first_s = _post(f"{url}/segment", data)
        warm = [_post(f"{url}/segment", data) for _ in range(SERVE_WARM)]
        launches = crf_iteration.launches
        trace_dir = os.path.join(workdir, "trace")
        with tracing.trace(trace_dir), tracing.annotate("serve.post"):
            _, traced_png, traced_s = _post(f"{url}/segment", data)
        with urllib.request.urlopen(f"{url}/healthz", timeout=60) as r:
            health = json.loads(r.read())
        _, body, _ = _post(f"{url}/segment?format=json", data)
        keys = sorted(json.loads(body))
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.join(timeout=30)
    n_posts = 1 + SERVE_WARM + 1  # before /healthz: first, warm, traced
    expect = (1 + SERVE_WARM) * svc.seg.crf.params.n_iters
    if status != 200 or any(w[0] != 200 for w in warm):
        raise AssertionError(f"POST status {status}, {[w[0] for w in warm]}")
    if launches != expect:
        raise AssertionError(f"K1 launched {launches} times over "
                             f"{1 + SERVE_WARM} POSTs, not {expect}")
    if health["n_served"] != n_posts:
        raise AssertionError(f"/healthz n_served {health['n_served']}, "
                             f"{n_posts} POSTs")
    want_png = _png_bytes(svc.seg.segment_file(photo)["mask_rgb"])
    same = [png == want_png for png in
            (first_png, *(w[1] for w in warm), traced_png)]
    if not all(same):
        raise AssertionError(f"served mask PNGs equal to segment_file's: "
                             f"{same}")
    with open(os.path.join(trace_dir, tracing.TRACE_FILE)) as f:
        events = f.read()
    found = {name: name in events for name in (
        "serve.post", "serve.decode", "serve.segment", "serve.encode",
        "pylc::crf_iteration")}
    if not all(found.values()):
        raise AssertionError(f"annotations in the trace: {found}")
    # a region is a host event ("user_annotation") and, where device work
    # ran inside it, a device span of the same name ("gpu_user_annotation")
    stage_ms = {}
    for e in json.loads(events)["traceEvents"]:
        if str(e.get("name", "")).startswith("serve.") and "dur" in e:
            key = ("device " if e.get("cat") == "gpu_user_annotation"
                   else "host ") + e["name"]
            stage_ms[key] = stage_ms.get(key, 0) + e["dur"] / 1e3
    warm_s = sorted(w[2] for w in warm)
    log(f"[serve] POST /segment of a {CLI_PHOTO_HW[1]}x{CLI_PHOTO_HW[0]} "
        f"JPEG ({len(data) / 2 ** 20:.2f} MiB): first {first_s:.4f} s, warm "
        f"{[round(w, 4) for w in warm_s]} -> median "
        f"{warm_s[len(warm_s) // 2]:.4f} s; K1 launches {launches} "
        f"(expected {expect}); every mask PNG ({len(first_png)} B) equal to "
        f"segment_file's; /healthz n_served {health['n_served']}; "
        f"?format=json keys {keys}")
    log(f"[serve] one warm POST under tracing.trace: {traced_s:.4f} s; "
        f"annotations found in {tracing.TRACE_FILE} "
        f"({len(events) / 2 ** 20:.1f} MiB): {sorted(found)}; ms by region "
        f"{dict(sorted((k, round(v, 2)) for k, v in stage_ms.items()))}")

    # the artifact: the same Segmenter's canvas program at the fitted size
    n_iters = svc.seg.crf.params.n_iters
    fitted, _ = load_fitted(photo, svc.seg.cfg.ch, 1.0,
                            svc.seg.cfg.tile_size,
                            svc.seg.cfg.tile_size // 2)
    H, W = fitted.shape[:2]
    artifact = os.path.join(workdir, "slice.pylct")
    t0 = time.perf_counter()
    header = save_artifact(artifact, svc.seg, H, W)
    export_s = time.perf_counter() - t0
    live = svc.seg.segment_array(fitted)
    live_s = []
    for _ in range(ARTIFACT_PHOTOS):
        t0 = time.perf_counter()
        svc.seg.segment_array(fitted)
        live_s.append(time.perf_counter() - t0)
    del svc
    torch.cuda.empty_cache()
    out = os.path.join(workdir, "artifact_class_map.npy")
    child = subprocess.run(
        [sys.executable, "-c", ARTIFACT_CHILD, artifact, photo, out,
         str(ARTIFACT_PHOTOS)], env=dict(os.environ, PYTHONPATH=REPO),
        capture_output=True, text=True, timeout=900)
    if child.returncode != 0:
        raise AssertionError(f"the artifact's process failed:\n"
                             f"{child.stdout}\n{child.stderr}")
    got = json.loads(child.stdout.strip().splitlines()[-1])
    agree = float(np.mean(np.load(out) == live["class_map"]))
    with open(out + ".png", "rb") as f:
        png_equal = f.read() == want_png
    art_s = sorted(got["seconds"])
    live_s = sorted(live_s)
    log(f"[serve] artifact {os.path.basename(artifact)} "
        f"({os.path.getsize(artifact) / 2 ** 20:.1f} MiB) of the fitted "
        f"{W}x{H} canvas with the CRF: export {export_s:.2f} s (torch "
        f"{header['torch_version']}, {header['device']} "
        f"sm_{''.join(map(str, header['cuda_capability']))}); in a process "
        f"without the model zoo (imported: {got['models_imported']}): load "
        f"{got['load_s']:.2f} s, first photo {got['first_s']:.4f} s, then "
        f"{[round(v, 4) for v in art_s]} -> median "
        f"{art_s[len(art_s) // 2] * 1e3:.2f} ms per photo against the live "
        f"segment_array's {live_s[len(live_s) // 2] * 1e3:.2f} ms "
        f"({[round(v, 4) for v in live_s]}); K1 launches "
        f"{got['launches_per_photo']} per photo inside it; class map against "
        f"the live Segmenter {agree:.6f} (limit {CRF_AGREEMENT}); its "
        f"artifact-backend mask PNG equal to segment_file's: {png_equal}, "
        f"geometry {got['geometry']}")
    if got["models_imported"]:
        raise AssertionError(f"the artifact's process imported "
                             f"{got['models_imported']}")
    if got["launches_per_photo"] != n_iters:
        raise AssertionError(f"K1 launched {got['launches_per_photo']} "
                             f"times per photo inside the artifact, not "
                             f"{n_iters}")
    if agree < CRF_AGREEMENT:
        raise AssertionError(f"the artifact's class map agrees with the "
                             f"live Segmenter's on {agree}")
    phase_serve_cli(workdir, pth, photo, data, want_png, f"{H}x{W}")
    return launches, got["launches_per_photo"]


def phase_serve_cli(workdir, pth, photo, data, want_png, size):
    """The ``export`` and ``serve`` CLI modes on the card by default:
    ``export --crf`` of the [slice] ``.pth`` at the fitted size, then
    ``serve`` of that artifact on an ephemeral port, one POST whose mask
    PNG must be ``segment_file``'s, and the daemon stopped."""
    import urllib.request
    env = dict(os.environ, PYTHONPATH=REPO)
    artifact = os.path.join(workdir, "cli.pylct")
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "pylc_tpu_torch", "export", "-l", pth,
         "--size", size, "--crf", "-o", artifact], cwd=workdir, env=env,
        capture_output=True, text=True, timeout=900)
    if out.returncode != 0:
        raise AssertionError(f"export CLI failed:\n{out.stdout}\n"
                             f"{out.stderr}")
    export_wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "pylc_tpu_torch", "serve", "-l", artifact,
         "--port", "0"], cwd=workdir, env=env, stdout=subprocess.PIPE,
        text=True)
    try:
        line = proc.stdout.readline()
        if " on http://" not in line:
            raise AssertionError(f"serve CLI printed {line!r}")
        ready = time.perf_counter() - t0
        url = line.split(" on ")[1].split()[0]
        with urllib.request.urlopen(f"{url}/healthz", timeout=60) as r:
            health = json.loads(r.read())
        status, png, post_s = _post(f"{url}/segment", data)
    finally:
        proc.terminate()
        proc.wait(timeout=60)
        proc.stdout.close()
    if status != 200 or png != want_png:
        raise AssertionError(f"serve CLI: status {status}, mask PNG equal "
                             f"to segment_file's: {png == want_png}")
    log(f"[serve] CLI: export -l {os.path.basename(pth)} --size {size} --crf "
        f"in {export_wall:.1f} s of process wall "
        f"({out.stdout.strip().splitlines()[0]}); serve -l "
        f"{os.path.basename(artifact)} --port 0 ({health['backend']} "
        f"backend, geometry {health['geometry']}) ready in {ready:.1f} s, one "
        f"POST {post_s:.4f} s with the mask PNG of segment_file; stopped")


def structured_tiles(rng, n: int, tile: int, cfg):
    """n seeded tiles with something to learn: a mask of 8x8 cells of
    random classes, and an image whose colour is the class's palette
    colour plus noise.  Returns (img [n, 3, tile, tile], mask [n, tile,
    tile]), both uint8."""
    cells = rng.integers(0, cfg.n_classes, (n, 8, 8))
    rep = tile // 8
    mask = np.repeat(np.repeat(cells, rep, axis=1), rep, axis=2)
    colour = np.asarray(cfg.palette_rgb, np.float32)[mask]  # [n, T, T, 3]
    img = colour + rng.normal(0, 24, colour.shape)
    img = np.clip(img, 0, 255).astype(np.uint8).transpose(0, 3, 1, 2)
    return np.ascontiguousarray(img), mask.astype(np.uint8)


def profiled(fn):
    """``fn()`` once under torch.profiler -> (fn's result, its wall in ms,
    its device events by device time, largest first, the launches they
    count, their device ms).  The events are the CUDA ones (kernels and
    copies) less the ranges of user annotations (the optimizer's step),
    which span kernels already counted."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    return (out, wall_ms, events, sum(e.count for e in events),
            sum(e.self_device_time_total for e in events) / 1e3)


def _profile_step(step, img, mask, gen, step_ms: float):
    """One train step under torch.profiler: device time by kernel, and
    the device's busy share of the profiled step and of an unprofiled
    one (``step_ms``)."""
    _, wall_ms, kernels, n_launches, busy_ms = profiled(
        lambda: step(img, mask, gen))
    log(f"[train] profiled step: {n_launches} kernel launches, "
        f"{busy_ms:.2f} ms of device time; profiled wall "
        f"{wall_ms:.2f} ms; against the unprofiled median step "
        f"{step_ms:.2f} ms the idle share is {1 - busy_ms / step_ms:.3f}. "
        "Top kernels by device time:")
    for e in kernels[:15]:
        log(f"[train]   {e.self_device_time_total / 1e3:8.3f} ms "
            f"x{e.count:<5d} {e.key[:100]}")


def timed_steps(step, img, mask, gen, n: int):
    """``n`` train steps on one batch, each between two CUDA events ->
    (ms per step, total loss per step)."""
    ms, totals = [], []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        metrics = step(img, mask, gen)
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
        totals.append(float(metrics["total"]))
    return ms, totals


def phase_train(device, workdir):
    """The training path: trainer.train at full width on an in-memory DB,
    the JAX package's files it wrote beside its own (``check_jax_files``),
    the best model through tester.load_model, then FIXED_STEPS timed
    steps on one fixed batch."""
    from pylc_tpu_torch.config import Config
    from pylc_tpu_torch.db import TileDB
    from pylc_tpu_torch.infer import Segmenter
    from pylc_tpu_torch.ops.kernels.fused_loss import (
        fused_loss_backward, fused_loss_forward)
    from pylc_tpu_torch.tester import load_model
    from pylc_tpu_torch.train_state import make_optimizer, make_train_step
    from pylc_tpu_torch.trainer import train

    cfg = Config().replace(save_dir=os.path.join(workdir, "save"),
                           n_epochs=TRAIN_EPOCHS, report=2)
    T = cfg.tile_size
    img, mask = structured_tiles(np.random.default_rng(11), TRAIN_TILES, T,
                                 cfg)
    db = {"img": img, "mask": mask,
          "meta": cfg.replace(id="chip_smoke_db").to_meta()}
    n_train = TileDB(data=db, partition=(0.0, 1.0 - cfg.partition)
                     ).partition_size
    steps = TRAIN_EPOCHS * (n_train // cfg.batch_size)

    torch.cuda.reset_peak_memory_stats(device)
    fused_loss_forward.launches = fused_loss_backward.launches = 0
    t0 = time.perf_counter()
    summary = train(cfg, db, verbose=False, device=device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = (fused_loss_forward.launches, fused_loss_backward.launches)
    peak = torch.cuda.max_memory_allocated(device)
    log(f"[train] trainer.train: {summary['steps']} steps of "
        f"{cfg.batch_size} x {T} px in {TRAIN_EPOCHS} epochs, "
        f"{wall:.2f} s wall (3 validations, checkpoints); K2a launches "
        f"{launches[0]}, K2b launches {launches[1]} (expected {steps} "
        f"each: once per train step, never in validation); peak device "
        f"memory {peak / 2 ** 30:.3f} GiB")
    if summary["steps"] != steps or launches != (steps, steps):
        raise AssertionError(f"{summary['steps']} steps, K2 launches "
                             f"{launches}, expected {steps}")
    model_dir = os.path.join(cfg.save_dir, summary["model_id"])
    with open(os.path.join(model_dir, "losses.json")) as f:
        losses = json.load(f)
    rows = losses["train"] + losses["valid"]
    if not losses["valid"] or not np.isfinite(
            np.asarray([r[1:] for r in rows], np.float64)).all():
        raise AssertionError(f"losses.json rows not finite or no valid "
                             f"rows: {losses}")
    for name in ("train", "valid"):
        for r in losses[name]:
            log(f"[train] {name} at step {r[0]}: ce {r[1]:.4f} dice "
                f"{r[2]:.4f} focal {r[3]:.4f}")

    check_jax_files(summary, model_dir, n_train // cfg.batch_size, device)

    photo = np.random.default_rng(12).integers(
        0, 255, (*TRAIN_PHOTO_HW, 3), dtype=np.uint8)
    maps = {}
    for ext in (".pth", ".ckpt"):
        path = os.path.join(model_dir, summary["model_id"] + ext)
        lcfg, _, predict = load_model(path, Config(), device)
        cm = Segmenter(lcfg, predict, device,
                       batch_size=16).segment_array(photo)["class_map"]
        if cm.shape != TRAIN_PHOTO_HW or int(cm.max()) >= lcfg.n_classes:
            raise AssertionError(f"trained model's class map {cm.shape}")
        maps[ext] = cm
        log(f"[train] {os.path.basename(path)} "
            f"({os.path.getsize(path) / 2 ** 20:.1f} MiB) loaded through "
            f"tester.load_model and segmented a {TRAIN_PHOTO_HW[1]}x"
            f"{TRAIN_PHOTO_HW[0]} photo: classes {np.unique(cm).tolist()}")
    if not np.array_equal(maps[".pth"], maps[".ckpt"]):
        differ = float(np.mean(maps[".pth"] != maps[".ckpt"]))
        raise AssertionError(f"the best model's .ckpt and .pth class maps "
                             f"differ on {differ:.6%} of pixels")
    log("[train] the best model's .ckpt and .pth give the same class map")

    # FIXED_STEPS steps on one fixed batch, from the trained weights
    model = summary["model"]
    opt, sched = make_optimizer(cfg, model, 1)
    step = make_train_step(cfg, model, opt, sched)
    img = torch.from_numpy(db["img"][:cfg.batch_size]).to(device)
    mask = torch.from_numpy(db["mask"][:cfg.batch_size]).to(device)
    gen = torch.Generator().manual_seed(13)
    ms, totals = timed_steps(step, img, mask, gen, FIXED_STEPS)
    step_ms = float(np.median(ms[1:]))
    first, last = np.mean(totals[:3]), np.mean(totals[-3:])
    log(f"[train] {FIXED_STEPS} steps on one fixed batch of "
        f"{cfg.batch_size}: ms {[round(v, 2) for v in ms]}; median after "
        f"the first {step_ms:.3f} ms = {cfg.batch_size * 1e3 / step_ms:.2f}"
        f" tiles/s; total loss {[round(v, 4) for v in totals]} (mean of "
        f"the first 3 {first:.4f}, of the last 3 {last:.4f})")
    # dropout and the flips make single steps noisy: compare means
    if not np.isfinite(totals).all() or not last < first:
        raise AssertionError(f"total loss did not fall: {totals}")
    _profile_step(step, img, mask, gen, step_ms)
    return launches


def check_jax_files(summary, model_dir, steps_per_epoch, device):
    """The JAX package's files that ``trainer.train`` wrote beside its own:
    ``checkpoint.ckpt`` and ``<model_id>.ckpt`` with their ``.meta``;
    ``checkpoint.ckpt`` through ``convert.load_ckpt_checkpoint`` into a
    fresh model, optimizer and scheduler equal bit for bit to
    ``checkpoint.pth`` loaded into another; and the seconds of each save
    in each format."""
    from pylc_tpu_torch import convert
    from pylc_tpu_torch.checkpoint import Checkpoint
    from pylc_tpu_torch.train_state import init_model, make_optimizer
    cfg, mid = summary["config"], summary["model_id"]
    names = ["checkpoint.ckpt", "checkpoint.ckpt.meta", f"{mid}.ckpt",
             f"{mid}.ckpt.meta", "checkpoint.pth", f"{mid}.pth"]
    missing = [n for n in names
               if not os.path.exists(os.path.join(model_dir, n))]
    if missing:
        raise AssertionError(f"[train] trainer.train wrote no {missing}")
    sizes = {n: os.path.getsize(os.path.join(model_dir, n)) / 2 ** 20
             for n in names if not n.endswith(".meta")}
    for i, saved in enumerate(summary["save_s"]):
        log(f"[train] save {i + 1} of {len(summary['save_s'])}: the JAX "
            f"layout (checkpoint.ckpt, with {mid}.ckpt when best) "
            f"{saved['ckpt']:.3f} s, torch's (checkpoint.pth, with "
            f"{mid}.pth when best) {saved['pth']:.3f} s")
    log("[train] file sizes: " + ", ".join(f"{n} {v:.1f} MiB"
                                           for n, v in sizes.items()))

    def fresh(seed):
        model = init_model(cfg, seed=seed)
        model.to(device, memory_format=torch.channels_last)
        return (model, *make_optimizer(cfg, model, steps_per_epoch))
    from_pth, from_ckpt = fresh(61), fresh(62)
    # the port's own resume: checkpoint.pth, written after the .ckpt
    own = Checkpoint(mid, cfg.save_dir).load(*from_pth, cfg)
    info = convert.load_ckpt_checkpoint(
        os.path.join(model_dir, "checkpoint.ckpt"), cfg, *from_ckpt)
    at = (info["epoch"], info["iter"])
    differ = _carried_differences(from_pth, from_ckpt)
    log(f"[train] checkpoint.ckpt through convert.load_ckpt_checkpoint at "
        f"(epoch, iter) {at} against {os.path.basename(own['file'])} "
        f"through Checkpoint.load at {(own['epoch'], own['iter'])}: "
        f"{len(differ)} of the weights, statistics, moments, steps and lrs "
        f"differ {differ[:3]} (equality required)")
    if differ or own["file"] != os.path.join(model_dir, "checkpoint.pth") \
            or at != (own["epoch"], own["iter"]) or at[1] != summary["steps"]:
        raise AssertionError("[train] checkpoint.ckpt is not the run's "
                             "checkpoint.pth")


def _rel_errors(got, want):
    """Per tensor ||got - want|| / (||want|| + the whole of want's
    norm)."""
    whole = float(torch.cat([v.double().flatten()
                             for v in want.values()]).norm())
    return {k: float((got[k].double() - v.double()).norm())
            / (float(v.double().norm()) + whole) for k, v in want.items()}


def _one_remat_step(cfg, sd, device, img, mask, remat):
    """One AdamW step of a DeepLab from ``sd`` with the backbone's remat
    on or off -> (metrics, clipped gradients, state_dict after)."""
    from pylc_tpu_torch.models.registry import build_model
    from pylc_tpu_torch.train_state import make_optimizer, make_train_step
    model = build_model(cfg)
    model.load_state_dict(sd)
    _set_dropout_0(model)
    model.backbone.remat = remat
    model.to(device, memory_format=torch.channels_last)
    opt, sched = make_optimizer(cfg, model, 1)
    m = make_train_step(cfg, model, opt, sched)(img, mask, flip=True)
    return ({k: float(v) for k, v in m.items()},
            {n: p.grad.detach().clone() for n, p in model.named_parameters()},
            {k: v.detach().clone() for k, v in model.state_dict().items()})


def phase_remat(device, card):
    """``remat_backbone`` on the card: the f32 remat step against the
    plain one (TF32 off, cudnn.deterministic, batch 2, every bn3.weight x
    RESIDUAL_GAIN, dropout 0); the bf16 train step of DeepLabV3+/ResNet101
    at 512 px with AdamW and the fused loss, remat off and on in turns at
    each of REMAT_BATCHES (ms per step, peak memory, one profiled step
    each); one step each way of the other three backbones at batch 8.
    Returns K2a's and K2b's launches over the remat steps."""
    from pylc_tpu_torch.config import Config
    from pylc_tpu_torch.ops.kernels.fused_loss import (
        fused_loss_backward, fused_loss_forward)
    from pylc_tpu_torch.train_state import (init_model, make_optimizer,
                                            make_train_step)
    t_phase = time.perf_counter()
    rng = np.random.default_rng(41)

    # f32: the remat step against the plain one, and a second plain run
    cfg = Config().replace(compute_dtype="float32", batch_size=2)
    model = init_model(cfg, seed=41)
    with torch.no_grad():
        for key, prm in model.named_parameters():
            if key.endswith("bn3.weight"):
                prm.mul_(RESIDUAL_GAIN)
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    del model
    img, mask = (torch.from_numpy(a).to(device) for a in structured_tiles(
        rng, 2, cfg.tile_size, cfg))
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        plain, remat, plain2 = (_one_remat_step(cfg, sd, device, img, mask, r)
                                for r in (False, True, False))
    finally:
        torch.backends.cudnn.deterministic = deterministic
    loss_err = max(abs(remat[0][k] - plain[0][k]) / abs(plain[0][k])
                   for k in plain[0])
    grad_err = _rel_errors(remat[1], plain[1])
    grad_floor = _rel_errors(plain2[1], plain[1])
    worst = max(grad_err, key=lambda k: grad_err[k] - 4 * grad_floor[k])
    stats = [k for k in plain[2] if "running" in k]
    stat_err = max(float((remat[2][k] - plain[2][k]).abs().max())
                   / max(float(plain[2][k].abs().max()), 1e-30)
                   for k in stats)
    tracked = {int(v) for k, v in remat[2].items()
               if k.endswith("num_batches_tracked")}
    equal = sum(torch.equal(remat[1][k], plain[1][k]) for k in plain[1])
    log(f"[remat] f32 step, remat against plain (DeepLabV3+/ResNet101, "
        f"batch 2, TF32 off, cudnn.deterministic, bn3 x {RESIDUAL_GAIN}): "
        f"losses {plain[0]['total']:.6f} / {remat[0]['total']:.6f}, worst "
        f"rel diff {loss_err:.3e}; {equal} of {len(plain[1])} gradients bit-"
        f"equal, worst {grad_err[worst]:.3e} of the norms ({worst}; a "
        f"second plain run differs there by {grad_floor[worst]:.3e}, at "
        f"most {max(grad_floor.values()):.3e}); {len(stats)} running "
        f"statistics within {stat_err:.3e} of their largest entry; "
        f"num_batches_tracked {sorted(tracked)} (limit {REMAT_RTOL:g}, "
        "equality expected)")
    if not loss_err <= REMAT_RTOL or not stat_err <= REMAT_RTOL \
            or tracked != {1} or any(
                grad_err[k] > REMAT_RTOL + 4 * grad_floor[k]
                for k in grad_err):
        raise AssertionError("the remat step disagrees with the plain step")
    del plain, remat, plain2
    torch.cuda.empty_cache()

    # bf16 at REMAT_BATCHES, remat off and on in turns
    cfg = Config()
    model = init_model(cfg, seed=42).to(device,
                                        memory_format=torch.channels_last)
    opt, sched = make_optimizer(cfg, model, 1)
    step = make_train_step(cfg, model, opt, sched)
    gen = torch.Generator().manual_seed(43)
    launches = [0, 0]
    for B in REMAT_BATCHES:
        img, mask = (torch.from_numpy(a).to(device) for a in
                     structured_tiles(rng, B, cfg.tile_size, cfg))
        for remat in (False, True):  # the first call of each shape
            model.backbone.remat = remat
            step(img, mask, gen)
        ms = {False: [], True: []}
        peak = {False: 0, True: 0}
        for remat in (False, True, True, False):
            model.backbone.remat = remat
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(device)
            fused_loss_forward.launches = fused_loss_backward.launches = 0
            t, totals = timed_steps(step, img, mask, gen, REMAT_STEPS)
            got = (fused_loss_forward.launches, fused_loss_backward.launches)
            if got != (REMAT_STEPS, REMAT_STEPS) or \
                    not np.isfinite(totals).all():
                raise AssertionError(f"[remat] batch {B} remat {remat}: K2 "
                                     f"launches {got}, losses {totals}")
            if remat:
                launches = [a + b for a, b in zip(launches, got)]
            ms[remat] += t
            peak[remat] = max(peak[remat],
                              torch.cuda.max_memory_allocated(device))
        prof = {}
        for remat in (False, True):
            model.backbone.remat = remat
            prof[remat] = profiled(lambda: step(img, mask, gen))[3:]
        med = {r: float(np.median(v)) for r, v in ms.items()}
        for r, name in ((False, "none"), (True, "remat")):
            log(f"[remat] batch {B}, {name} ({card}): {2 * REMAT_STEPS} "
                f"steps in two blocks, ms {[round(v, 2) for v in ms[r]]}, "
                f"median {med[r]:.3f} ms = {B * 1e3 / med[r]:.2f} tiles/s; "
                f"peak {peak[r] / 2 ** 30:.3f} GiB; profiled step "
                f"{prof[r][0]} kernel launches, {prof[r][1]:.2f} ms of "
                "device time; K2a/K2b once per step")
        log(f"[remat] batch {B}: remat / none = {med[True] / med[False]:.3f}"
            f" in ms per step, {peak[True] / peak[False]:.3f} in peak "
            f"memory, {prof[True][1] / prof[False][1]:.3f} in device time")
    del model, opt, step
    torch.cuda.empty_cache()

    # the other backbones, one step each way at batch 8: the remat step's
    # loss comes from its first forward, before any recompute, so it must
    # equal the plain step's bit for bit (cudnn.deterministic: one forward
    # algorithm each way)
    torch.backends.cudnn.deterministic = True
    for name in REMAT_BACKBONES:
        bcfg = Config().replace(backbone=name)
        model = init_model(bcfg, seed=44)
        _set_dropout_0(model)  # so that both steps see one forward
        sd = {k: v.clone() for k, v in model.state_dict().items()}
        img, mask = (torch.from_numpy(a).to(device) for a in
                     structured_tiles(rng, bcfg.batch_size, bcfg.tile_size,
                                      bcfg))
        res = {}
        for remat in (False, True):
            model.load_state_dict(sd)
            model.backbone.remat = remat
            model.to(device, memory_format=torch.channels_last)
            opt, sched = make_optimizer(bcfg, model, 1)
            step = make_train_step(bcfg, model, opt, sched)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(device)
            fused_loss_forward.launches = fused_loss_backward.launches = 0
            total = float(step(img, mask, flip=True)["total"])
            got = (fused_loss_forward.launches, fused_loss_backward.launches)
            res[remat] = (total, torch.cuda.max_memory_allocated(device))
            if got != (1, 1) or not np.isfinite(total):
                raise AssertionError(f"[remat] {name}: K2 {got}, {total}")
            if remat:
                launches = [a + b for a, b in zip(launches, got)]
            del opt, step
        log(f"[remat] DeepLab/{name}, batch {bcfg.batch_size}, bf16, one "
            f"step each way: total loss {res[False][0]:.5f} / "
            f"{res[True][0]:.5f}; peak {res[False][1] / 2 ** 30:.3f} / "
            f"{res[True][1] / 2 ** 30:.3f} GiB (remat / none = "
            f"{res[True][1] / res[False][1]:.3f}); losses equal required")
        if res[True][0] != res[False][0]:
            raise AssertionError(f"[remat] {name}: the remat step's loss "
                                 f"{res[True][0]!r} is not the plain "
                                 f"step's {res[False][0]!r}")
        del model
        torch.cuda.empty_cache()
    torch.backends.cudnn.deterministic = deterministic
    log(f"[remat] {time.perf_counter() - t_phase:.1f} s")
    return tuple(launches)


def _carried_differences(src, dst):
    """What of (model, optimizer, scheduler) ``dst`` is not ``src``'s
    bit for bit: state_dict entries, optimizer state per parameter (by
    name), the schedule's position and each group's lr."""
    (ma, oa, sa), (mb, ob, sb) = src, dst
    a, b = ma.state_dict(), mb.state_dict()
    bad = [k for k in a if not torch.equal(a[k], b[k])]
    for (name, pa), (_, pb) in zip(ma.named_parameters(),
                                   mb.named_parameters()):
        for key, v in oa.state[pa].items():
            if not torch.equal(v.cpu(), ob.state[pb][key].cpu()):
                bad.append(f"{name} {key}")
    if sa.last_epoch != sb.last_epoch or \
            [g["lr"] for g in oa.param_groups] != \
            [g["lr"] for g in ob.param_groups]:
        bad.append("the schedule")
    return bad


def phase_resume(device, workdir):
    """A run carried across the JAX package's checkpoint: RESUME_STEPS[0]
    bf16 steps of DeepLabV3+/ResNet101 (AdamW, head_lr_mult 10, two steps
    per epoch, dropout 0, cudnn.deterministic), then the model, optimizer
    and schedule through a ``checkpoint.ckpt`` in the JAX package's layout
    (``convert.save_ckpt_checkpoint``, ``load_ckpt_checkpoint``) into a
    fresh model and optimizer on the card: equal bit for bit.  Then
    RESUME_STEPS[1] more steps in f32 with TF32 off on it, on the run and
    on a torch-native copy of the run.  Returns K2a's and K2b's launches in
    the resumed run."""
    from pylc_tpu_torch import convert
    from pylc_tpu_torch.config import Config
    from pylc_tpu_torch.ops.kernels.fused_loss import (
        fused_loss_backward, fused_loss_forward)
    from pylc_tpu_torch.train_state import (init_model, make_optimizer,
                                            make_train_step)
    t_phase = time.perf_counter()
    cfg = Config().replace(head_lr_mult=10.0)
    n_before, n_after = RESUME_STEPS
    rng = np.random.default_rng(51)
    batches = [tuple(torch.from_numpy(a).to(device) for a in
                     structured_tiles(rng, cfg.batch_size, cfg.tile_size,
                                      cfg))
               for _ in range(n_before + n_after)]
    flips = [bool(f) for f in rng.integers(0, 2, len(batches))]

    def run(seed):
        model = init_model(cfg, seed=seed)
        _set_dropout_0(model)
        model.to(device, memory_format=torch.channels_last)
        return (model, *make_optimizer(cfg, model, 2))

    def steps(step, ids):
        fused_loss_forward.launches = fused_loss_backward.launches = 0
        totals = [float(step(*batches[i], flip=flips[i])["total"])
                  for i in ids]
        return totals, (fused_loss_forward.launches,
                        fused_loss_backward.launches)

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        model, opt, sched = run(52)
        before, got = steps(make_train_step(cfg, model, opt, sched),
                            range(n_before))
        if got != (n_before, n_before):
            raise AssertionError(f"[resume] K2 launches {got}")
        t0 = time.perf_counter()
        fresh, opt2, sched2 = run(53)
        path = os.path.join(workdir, "checkpoint.ckpt")
        convert.save_ckpt_checkpoint(path, cfg, model, opt, sched, 1,
                                     n_before)
        info = convert.load_ckpt_checkpoint(path, cfg, fresh, opt2, sched2)
        got_at = (info["epoch"], info["iter"])
        carry_s = time.perf_counter() - t0
        differ = _carried_differences((model, opt, sched),
                                      (fresh, opt2, sched2))
        log(f"[resume] DeepLabV3+/ResNet101, bf16, AdamW, head_lr_mult "
            f"{cfg.head_lr_mult:g}: {n_before} steps (total loss "
            f"{[round(v, 4) for v in before]}), carried through "
            f"checkpoint.ckpt ({os.path.getsize(path) / 2 ** 20:.1f} MiB, "
            f"the JAX package's msgpack layout) in {carry_s:.2f} s into a "
            f"fresh model and optimizer at (epoch, iter) {got_at}: "
            f"{len(differ)} of the weights, statistics, "
            f"moments, steps and lrs differ from the run's "
            f"{differ[:3]} (equality required)")
        if differ or got_at != (1, n_before):
            raise AssertionError("[resume] the carry changed the run")
        twin, opt3, sched3 = run(54)
        twin.load_state_dict(model.state_dict())
        # a deep copy: load_state_dict keeps the given tensors when their
        # device and dtype fit, and the run's steps move them in place
        opt3.load_state_dict(copy.deepcopy(opt.state_dict()))
        sched3.load_state_dict(sched.state_dict())
        at_carry = {k: v.clone() for k, v in model.state_dict().items()}
        # f32, TF32 off (make_train_step sets it, after the bf16 steps'
        # builds): the steps' rounding differs only by the atomics
        f32 = cfg.replace(compute_dtype="float32")
        step, step2, step3 = (make_train_step(f32, *mos) for mos in (
            (model, opt, sched), (fresh, opt2, sched2), (twin, opt3, sched3)))
        after = range(n_before, n_before + n_after)
        cont, _ = steps(step, after)
        resumed, launches = steps(step2, after)
        copied, _ = steps(step3, after)
    finally:
        torch.cuda.synchronize(device)
        torch.backends.cudnn.deterministic = deterministic
    if launches != (n_after, n_after):
        raise AssertionError(f"[resume] resumed run's K2 launches {launches}")
    ref = model.state_dict()
    keys = [k for k, v in ref.items() if v.is_floating_point()]

    def dist(sd):
        return float(torch.cat([(sd[k].double() - ref[k].double()).flatten()
                                for k in keys]).norm())
    d_resumed, d_copy = dist(fresh.state_dict()), dist(twin.state_dict())
    update = dist(at_carry)
    log(f"[resume] then {n_after} f32 steps (TF32 off) on the run, the "
        f"resumed run and the copy: total loss "
        f"{[round(v, 5) for v in cont]} / {[round(v, 5) for v in resumed]}"
        f" / {[round(v, 5) for v in copied]}"
        f"; distance from the run {d_resumed:.4e} (resumed) and "
        f"{d_copy:.4e} (copy), the run's update {update:.4e} (limit 4 x the "
        f"copy's + {RESUME_RTOL:g} x the update); K2a/K2b launches in the "
        f"resumed run {launches}; {time.perf_counter() - t_phase:.1f} s")
    if not d_resumed <= 4 * d_copy + RESUME_RTOL * update:
        raise AssertionError("the resumed run left the run it came from")
    return launches


def phase_multi_photo(device, workdir, card):
    """[slice]'s model and photo through the mesh Segmenter on
    Mesh([cuda:0] * n), n in MULTI_BANDS, in turns with one device, then
    the archive path on each mesh (``phase_multi_many``).  Returns K1's
    launches over one photo at each n and over the archive paths."""
    from pylc_tpu_torch.config import Config
    from pylc_tpu_torch.infer import Segmenter
    from pylc_tpu_torch.ops.crf import make_crf
    from pylc_tpu_torch.ops.kernels.crf_kernel import crf_iteration
    from pylc_tpu_torch.ops.tiles import grid_dims
    from pylc_tpu_torch.parallel import sharded_crf
    from pylc_tpu_torch.parallel.mesh import Mesh
    from pylc_tpu_torch.tester import load_model
    from pylc_tpu_torch.train_state import init_model

    cfg = Config()
    pth = os.path.join(workdir, "deeplab_resnet101_random.pth")
    torch.save({"model": init_model(cfg, seed=0).state_dict(),
                "meta": cfg.to_meta()}, pth)  # [slice]'s weights
    cfg, _, predict = load_model(pth, cfg, device)
    crf = make_crf(cfg)
    p = crf.params
    photo = np.random.default_rng(0).integers(0, 255, (*SLICE_HW, 3),
                                              dtype=np.uint8)
    H, W = SLICE_HW
    stride = cfg.tile_size // 2
    one = Segmenter(cfg, predict, device, batch_size=16, crf=crf)
    segs = {n: Segmenter(cfg, predict, device, batch_size=16, crf=crf,
                         mesh=Mesh([device] * n)) for n in MULTI_BANDS}
    for n, seg in segs.items():
        routes = seg.mesh_routes(H, W, stride)
        if routes != {"forward_stitch": "banded", "crf": "banded"}:
            raise AssertionError(f"n = {n}: routes {routes}")
    one.segment_array_staged(photo)  # warm-up
    want = one.segment_array_staged(photo)

    # the main path: one photo at each n, K1's count from 0, every K1
    # launch of the banded CRF recorded with its operand's shape
    shapes = []
    launch = sharded_crf.crf_iteration

    def recording(q, *args):
        shapes.append(tuple(q.shape))
        return launch(q, *args)
    sharded_crf.crf_iteration = recording
    crf_iteration.launches = 0
    try:
        first = {n: segs[n].segment_array_staged(photo) for n in MULTI_BANDS}
    finally:
        sharded_crf.crf_iteration = launch
    launches = crf_iteration.launches
    expect = p.n_iters * sum(MULTI_BANDS)
    Hk, Wk = -(-H // p.downsample), -(-W // p.downsample)
    bands = [(n, -(-Hk // n)) for n in MULTI_BANDS]
    want_shapes = [(cfg.n_classes, h + 2 * p.radius, Wk)
                   for n, h in bands for _ in range(n * p.n_iters)]
    log(f"[multi] K1 launches {launches} over one photo at each of n = "
        f"{MULTI_BANDS} (expected {expect} = 5 x n per photo), on bands of "
        + ", ".join(f"{h} + 2 x {p.radius} rows at n = {n}"
                    for n, h in bands))
    if launches != expect or shapes != want_shapes:
        raise AssertionError(f"K1 launched {launches} times on "
                             f"{sorted(set(shapes))}")

    # in turns: one device, 2, 3, 4, 4, 3, 2, one device
    order = [None, *MULTI_BANDS, *reversed(MULTI_BANDS), None]
    timed = {n: [] for n in order}
    for n in order:
        seg = one if n is None else segs[n]
        timed[n].append(seg.segment_array_staged(photo))
    n_rows, n_cols = grid_dims(W, H, cfg.tile_size, stride)
    # the spill of one band to the next: k - 1 = 1 block row of sums and
    # counts
    spill = (n_cols + 1) * (stride * stride * cfg.n_classes + 1) * 4

    def ms(runs, stage):
        return float(np.mean([r["stages"][stage] for r in runs])) * 1e3

    def total(runs):
        return float(np.mean([r["seconds"] for r in runs])) * 1e3
    log(f"[multi] one device: forward_stitch {ms(timed[None], 'forward_stitch'):.2f} "
        f"ms, crf {ms(timed[None], 'crf'):.2f} ms, total "
        f"{total(timed[None]):.2f} ms per photo (mean of 2, in turns)")
    # the same photo at a batch of one tile row
    row = {n: Segmenter(cfg, predict, device, batch_size=n_cols, crf=crf,
                        mesh=None if n is None else Mesh([device] * n)
                        ).segment_array(photo) for n in (None, *MULTI_BANDS)}

    def against(res, base):
        return (float(np.mean(res["class_map"] == base["class_map"])),
                (res["probs"] - base["probs"]).abs().max().item())
    for n in MULTI_BANDS:
        agree16, diff16 = against(first[n], want)
        agree, diff = against(row[n], row[None])
        n_rows_p = -(-n_rows // n) * n
        crf_halo = sharded_crf.halo_bytes(H, W, cfg.n_classes, p, n)
        log(f"[multi] n = {n} on one card: forward_stitch "
            f"{ms(timed[n], 'forward_stitch'):.2f} ms, crf "
            f"{ms(timed[n], 'crf'):.2f} ms, total {total(timed[n]):.2f} ms "
            f"per photo (mean of 2, in turns); {n_rows_p * n_cols} tiles "
            f"forwarded against {n_rows * n_cols}; halos: the stitch's spill "
            f"{spill / 1e6:.3f} MB per seam once, the CRF's q "
            f"{crf_halo / 1e6:.3f} MB per iteration; against one device at "
            f"a batch of one tile row ({n_cols}): class map {agree:.6f} "
            f"(limit {MULTI_AGREEMENT}), canvas max_abs_diff {diff:.3e} "
            f"(limit {MULTI_CANVAS_ATOL:g}); at batch 16: class map "
            f"{agree16:.6f} (limit {CRF_AGREEMENT}), canvas max_abs_diff "
            f"{diff16:.3e}")
        if agree < MULTI_AGREEMENT or not diff <= MULTI_CANVAS_ATOL \
                or agree16 < CRF_AGREEMENT:
            raise AssertionError(f"n = {n}: the banded photo disagrees "
                                 "with one device")
    agree, _ = against(row[None], want)
    log(f"[multi] one device at batch {n_cols} against batch 16: class map "
        f"{agree:.6f} (bf16 convolutions of another batch shape)")

    # K1 on a halo-extended band against K1 on the whole grid: an
    # interior band and the padded last band of n = 3
    rng = np.random.default_rng(5)
    q = rng.random((cfg.n_classes, Hk, Wk)).astype(np.float32)
    q /= q.sum(0, keepdims=True)
    g = rng.integers(0, 256, (3, Hk, Wk)).astype(np.float32)
    q, g = (torch.from_numpy(a).to(device) for a in (q, g))
    u = torch.log(q + p.eps)
    sig = (p.sigma_spatial_app, p.sigma_color, p.sigma_spatial_sm,
           p.w_appearance, p.w_smoothness, p.eps)
    r = p.radius
    whole = crf_iteration(q, g, u, r, *sig)
    h = -(-Hk // 3)

    def extended(x, lo, hi):
        rows = torch.arange(lo - r, hi + r, device=device).clamp_(0, Hk - 1)
        return x[:, rows].contiguous()
    worst = 0.0
    for lo, hi in ((h, 2 * h), (2 * h, Hk)):
        # past the grid's end the rows are the last row, as the padding
        # and the bottom halo hold it
        band = crf_iteration(extended(q, lo, hi), extended(g, lo, hi),
                             extended(u, lo, hi), r, *sig)[:, r:r + hi - lo]
        worst = max(worst, (band - whole[:, lo:hi]).abs().max().item())
    log(f"[multi] K1 on an extended band of n = 3 (rows {h}-{2 * h} and "
        f"{2 * h}-{Hk}, padded) against K1 on the whole {Hk}x{Wk} grid: "
        f"max_abs_diff {worst:.3e} (bit-equal expected; limit {K1_ATOL:g})")
    if not worst <= K1_ATOL:
        raise AssertionError(f"K1 on a band differs by {worst}")
    return launches, phase_multi_many(segs, device, card)


def phase_multi_many(segs, device, card):
    """The archive path on a mesh: MANY_PHOTOS seeded photos through
    ``segment_many`` on each mesh Segmenter of ``segs`` (n -> Segmenter)
    and through its ``segment_array`` one after the other, timed many, one
    by one, one by one, many.  Every class map and mask equal; K1 5 x n
    times per photo in the first pass of ``segment_many``.  Returns K1's
    launches over those first passes, all n together."""
    from pylc_tpu_torch.ops.kernels.crf_kernel import crf_iteration
    rng = np.random.default_rng(22)
    photos = [rng.integers(0, 255, (*SLICE_HW, 3), dtype=np.uint8)
              for _ in range(MANY_PHOTOS)]
    mp = MANY_PHOTOS * SLICE_HW[0] * SLICE_HW[1] / 1e6

    def timed(seg, many):
        """(results without 'probs', wall seconds)."""
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        if many:
            out = seg.segment_many(photos)
        else:
            out = []
            for photo in photos:
                out.append(seg.segment_array(photo))
                del out[-1]["probs"]  # 264 MB of canvas each
        torch.cuda.synchronize(device)
        return out, time.perf_counter() - t0

    total = 0
    for n, seg in segs.items():
        seg.segment_many(photos[:2])  # warm-up: the pinned buffers, streams
        crf_iteration.launches = 0
        got, wall_a = timed(seg, True)
        launches = crf_iteration.launches
        expect = seg.crf.params.n_iters * n * MANY_PHOTOS
        want, seq_a = timed(seg, False)
        _, seq_b = timed(seg, False)
        again, wall_b = timed(seg, True)
        if launches != expect:
            raise AssertionError(f"[multi] n = {n}: K1 launched {launches} "
                                 f"times in segment_many, not {expect}")
        for i, w in enumerate(want):
            for g in (got[i], again[i]):
                if "probs" in g or not (
                        np.array_equal(g["class_map"], w["class_map"])
                        and np.array_equal(g["mask_rgb"], w["mask_rgb"])):
                    differ = float(np.mean(g["class_map"] != w["class_map"]))
                    raise AssertionError(
                        f"[multi] n = {n}, photo {i}: segment_many's class "
                        f"map differs from segment_array's on {differ:.6%} "
                        "of pixels")
        if abs(sum(r["seconds"] for r in got) - got[-1]["completed_s"]) \
                > 1e-6:
            raise AssertionError("[multi] segment_many's seconds do not add "
                                 "up to the last completion")
        log(f"[multi] n = {n}: segment_many on Mesh([cuda:0] x {n}), K1 "
            f"launches {launches} (expected {expect} = 5 x n x photos); "
            f"{MANY_PHOTOS} class maps and masks equal segment_array's in "
            f"both passes; completed_s "
            f"{[round(r['completed_s'], 4) for r in got]} and "
            f"{[round(r['completed_s'], 4) for r in again]}")
        for name, walls in (("segment_many", (wall_a, wall_b)),
                            ("segment_array one by one", (seq_a, seq_b))):
            mean = sum(walls) / 2
            log(f"[multi] n = {n}: {name}: total wall {walls[0]:.4f} s and "
                f"{walls[1]:.4f} s for {MANY_PHOTOS} photos of "
                f"{SLICE_HW[1]}x{SLICE_HW[0]} ({mp:.1f} MP), mean "
                f"{mean / MANY_PHOTOS * 1e3:.2f} ms per photo = "
                f"{mp / mean:.3f} MP/s ({card})")
        log(f"[multi] n = {n}: segment_many takes "
            f"{(wall_a + wall_b) / (seq_a + seq_b):.3f} of the one-by-one "
            f"wall (timed many, one by one, one by one, many; {card})")
        busy_ms, profiled = profiled_many(seg, photos[:3], device)
        per_photo = (wall_a + wall_b) / 2 / MANY_PHOTOS * 1e3
        log(f"[multi] n = {n}: profiled segment_many (3 photos): "
            f"{busy_ms:.2f} ms per photo on the compute stream; the "
            f"profiled run {profiled:.2f} ms per photo (idle share "
            f"{1 - busy_ms / profiled:.3f}), the unprofiled run of "
            f"{MANY_PHOTOS} {per_photo:.2f} ms (idle share "
            f"{1 - busy_ms / per_photo:.3f})")
        total += launches
    return total


def _set_dropout_0(model):
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0


def _multi_rank(cfg, sd, img, mask, flips, tcfg, db):
    """One rank of [multi]'s training (``parallel.mesh.spawn`` runs it):
    len(flips) f32 steps on this rank's rows of a fixed batch, timed bf16
    steps, the gradients' all-reduce alone, then ``trainer.train``.
    Returns rank 0's f32 metrics and weights and every rank's counts and
    times."""
    import torch.distributed as dist

    from pylc_tpu_torch.models.registry import build_model
    from pylc_tpu_torch.ops.kernels.fused_loss import (
        fused_loss_backward, fused_loss_forward)
    from pylc_tpu_torch.parallel.mesh import rank, world_size
    from pylc_tpu_torch.train_state import make_optimizer, make_train_step
    from pylc_tpu_torch.trainer import train

    device = torch.device("cuda", torch.cuda.current_device())
    r, n = rank(), world_size()
    per = img.shape[0] // n
    x = img[r * per:(r + 1) * per].to(device)
    y = mask[r * per:(r + 1) * per].to(device)

    def stepper(c):
        model = build_model(c)
        model.load_state_dict(sd)
        _set_dropout_0(model)
        model.to(device, memory_format=torch.channels_last)
        opt, sched = make_optimizer(c, model, 1)
        return model, make_train_step(c, model, opt, sched)

    model, step = stepper(cfg)
    fused_loss_forward.launches = fused_loss_backward.launches = 0
    metrics = [{k: float(v) for k, v in step(x, y, flip=f).items()}
               for f in flips]
    mine = {"f32_launches": (fused_loss_forward.launches,
                             fused_loss_backward.launches)}
    out = {"metrics": metrics,
           "sd": {k: v.cpu() for k, v in model.state_dict().items()}}
    del model, step
    torch.cuda.empty_cache()

    bf16 = cfg.replace(compute_dtype="bfloat16")
    model, step = stepper(bf16)
    gen = torch.Generator().manual_seed(13)
    times = []
    for _ in range(1 + MULTI_BF16_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(x, y, gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    flat = torch.zeros(sum(p.numel() for p in model.parameters()),
                       device=device)
    del model, step
    dist.all_reduce(flat)
    reduce_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dist.all_reduce(flat)
        torch.cuda.synchronize()
        reduce_ms.append((time.perf_counter() - t0) * 1e3)
    mine.update(step_ms=float(np.median(times[1:])), first_ms=times[0],
                reduce_ms=float(np.median(reduce_ms)),
                reduce_mb=flat.numel() * 4 / 1e6)
    del flat
    torch.cuda.empty_cache()

    fused_loss_forward.launches = fused_loss_backward.launches = 0
    save = os.path.join(tcfg.save_dir, f"rank{r}")
    summary = train(tcfg.replace(save_dir=save), db, None, False,
                    device="cuda")
    mine.update(train_launches=(fused_loss_forward.launches,
                                fused_loss_backward.launches),
                steps=summary["steps"], model_id=summary["model_id"],
                save=save, backend=dist.get_backend())
    ranks = [None] * n
    dist.all_gather_object(ranks, mine)
    out["ranks"] = ranks
    return out


def _nccl_rank(tcfg, db):
    """``trainer.train`` on a rank of a one-rank NCCL group: DDP and the
    K2 sums' all-reduce over NCCL."""
    import torch.distributed as dist

    from pylc_tpu_torch.ops.kernels.fused_loss import (
        fused_loss_backward, fused_loss_forward)
    from pylc_tpu_torch.trainer import train
    fused_loss_forward.launches = fused_loss_backward.launches = 0
    summary = train(tcfg, db, None, False, device="cuda")
    return {"backend": dist.get_backend(), "steps": summary["steps"],
            "model_id": summary["model_id"],
            "launches": (fused_loss_forward.launches,
                         fused_loss_backward.launches)}


def phase_multi_train(device, workdir, card):
    """2 ranks on cuda:0 under gloo against one process, then
    ``trainer.train`` on them and on one NCCL rank.  Returns K2a's and
    K2b's launches in the ranks' ``trainer.train``, summed over them."""
    from pylc_tpu_torch.config import Config
    from pylc_tpu_torch.ops.kernels.fused_loss import (
        fused_loss_backward, fused_loss_forward)
    from pylc_tpu_torch.parallel.mesh import spawn
    from pylc_tpu_torch.train_state import (init_model, make_optimizer,
                                            make_train_step)

    cfg = Config().replace(compute_dtype="float32", optim_type="sgd",
                           lr=1e-2)
    model = init_model(cfg, seed=0)
    with torch.no_grad():
        for key, prm in model.named_parameters():
            if key.endswith("bn3.weight"):
                prm.mul_(RESIDUAL_GAIN)
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    rng = np.random.default_rng(17)
    img, mask = (torch.from_numpy(a) for a in structured_tiles(
        rng, 2 * 4, cfg.tile_size, cfg))
    flips = [False, True, False][:MULTI_STEPS]

    _set_dropout_0(model)
    model.to(device, memory_format=torch.channels_last)
    opt, sched = make_optimizer(cfg, model, 1)
    step = make_train_step(cfg, model, opt, sched)
    fused_loss_forward.launches = fused_loss_backward.launches = 0
    one = [{k: float(v) for k, v in step(img.to(device), mask.to(device),
                                         flip=f).items()} for f in flips]
    one_sd = {k: v.cpu() for k, v in model.state_dict().items()}
    del model, opt, step
    torch.cuda.empty_cache()

    tcfg = Config().replace(save_dir=os.path.join(workdir, "ranks"),
                            n_epochs=1)
    timg, tmask = structured_tiles(rng, MULTI_TRAIN_TILES, cfg.tile_size,
                                   tcfg)
    db = {"img": timg, "mask": tmask,
          "meta": tcfg.replace(id="chip_smoke_multi").to_meta()}
    t0 = time.perf_counter()
    out = spawn(_multi_rank, 2, (cfg, sd, img, mask, flips, tcfg, db),
                devices=[device, device], backend="gloo", timeout_s=900)
    wall = time.perf_counter() - t0

    worst = max(abs(out["metrics"][0][k] - one[0][k]) / abs(one[0][k])
                for k in ("ce", "dice", "focal", "total"))
    update = {k: one_sd[k].double() - sd[k].double() for k in sd
              if sd[k].is_floating_point() and "running" not in k}
    whole = float(torch.cat([v.flatten() for v in update.values()]).norm())
    err = {k: float((out["sd"][k].double() - one_sd[k].double()).norm())
           / (float(v.norm()) + whole) for k, v in update.items()}
    key = max(err, key=err.get)
    ranks = out["ranks"]
    log(f"[multi] 2 ranks on one card under gloo (f32, TF32 off, every "
        f"bn3.weight x {RESIDUAL_GAIN}, dropout 0, SGD lr {cfg.lr}) against "
        f"one process at batch 8 on the same rows: first-step losses "
        f"{[round(out['metrics'][0][k], 6) for k in ('ce', 'dice', 'focal', 'total')]}"
        f" against {[round(one[0][k], 6) for k in ('ce', 'dice', 'focal', 'total')]}"
        f", worst rel diff {worst:.3e} (limit {MULTI_LOSS_RTOL:g}); after "
        f"{MULTI_STEPS} steps the worst parameter update differs by "
        f"{err[key]:.3e} of its norm plus the whole update's ({key}; limit "
        f"{MULTI_UPDATE_RTOL:g}); K2a/K2b launches per rank "
        f"{[rk['f32_launches'] for rk in ranks]} (expected {MULTI_STEPS} "
        f"each)")
    if not worst <= MULTI_LOSS_RTOL or not err[key] <= MULTI_UPDATE_RTOL:
        raise AssertionError("2 ranks disagree with one process")
    if any(rk["f32_launches"] != (MULTI_STEPS,) * 2 for rk in ranks):
        raise AssertionError("K2 did not run once per step per rank")
    for i, rk in enumerate(ranks):
        log(f"[multi] rank {i} (one card shared by two ranks, {card}): bf16 "
            f"step at batch 4 {rk['step_ms']:.2f} ms (median of "
            f"{MULTI_BF16_STEPS} after a first of {rk['first_ms']:.1f} ms); "
            f"the gradients' all-reduce alone ({rk['reduce_mb']:.1f} MB, "
            f"gloo through the host) {rk['reduce_ms']:.2f} ms = "
            f"{rk['reduce_ms'] / rk['step_ms']:.3f} of the step (an upper "
            "bound: DDP overlaps its buckets with the backward)")

    # trainer.train on the ranks
    tr_rows = MULTI_TRAIN_TILES - int(np.ceil(tcfg.partition
                                              * MULTI_TRAIN_TILES))
    steps = tr_rows // tcfg.batch_size
    launches = [rk["train_launches"] for rk in ranks]
    mid = ranks[0]["model_id"]
    written = [sorted(os.listdir(os.path.join(rk["save"], mid)))
               if os.path.isdir(os.path.join(rk["save"], mid)) else []
               for rk in ranks]
    log(f"[multi] trainer.train on the 2 ranks ({wall:.1f} s of spawn wall "
        f"for everything above): {[rk['steps'] for rk in ranks]} steps "
        f"(expected {steps}), K2a/K2b launches per rank {launches} "
        f"(expected {steps} each: once per step per rank); rank 0 wrote "
        f"{written[0]}, rank 1 {written[1]}; backend "
        f"{ranks[0]['backend']}")
    if any(rk["steps"] != steps for rk in ranks) or \
            launches != [(steps, steps)] * 2:
        raise AssertionError("trainer.train on 2 ranks")
    if f"{mid}.pth" not in written[0] or any(written[1:]):
        raise AssertionError("rank 0 alone writes the checkpoints")

    # one NCCL rank
    ncfg = tcfg.replace(save_dir=os.path.join(workdir, "nccl"))
    t0 = time.perf_counter()
    nccl = spawn(_nccl_rank, 1, (ncfg, db), devices=[device],
                 timeout_s=600)
    pth = os.path.join(ncfg.save_dir, nccl["model_id"],
                       nccl["model_id"] + ".pth")
    log(f"[multi] trainer.train on one {nccl['backend']} rank (DDP and the "
        f"K2 sums' all-reduce over NCCL at world size 1): {nccl['steps']} "
        f"steps, K2a/K2b launches {nccl['launches']}, "
        f"{time.perf_counter() - t0:.1f} s of spawn wall; wrote "
        f"{os.path.basename(pth)}")
    if nccl["backend"] != "nccl" or nccl["steps"] != steps or \
            nccl["launches"] != (steps, steps) or not os.path.exists(pth):
        raise AssertionError(f"the NCCL rank: {nccl}")
    return tuple(sum(v) for v in zip(*launches))


def write_data_photos(workdir, cfg):
    """DATA_PHOTOS seeded photos (JPEG) and their palette-exact masks
    (PNG) under workdir/images and workdir/masks, made in parallel.
    Returns (image dir, mask dir)."""
    import cv2
    from pylc_tpu_torch.utils.synthetic import textured_scene
    img_dir, mask_dir = (os.path.join(workdir, d) for d in ("images",
                                                            "masks"))
    os.makedirs(img_dir)
    os.makedirs(mask_dir)
    pal = np.asarray(cfg.palette_rgb, np.uint8)

    def one(i):
        true, photo, _ = textured_scene(*DATA_PHOTO_HW, cfg.n_classes,
                                        np.random.default_rng(60 + i))
        cv2.imwrite(os.path.join(img_dir, f"scan{i}.jpg"), photo[..., ::-1],
                    [cv2.IMWRITE_JPEG_QUALITY, 95])
        cv2.imwrite(os.path.join(mask_dir, f"scan{i}.png"),
                    pal[true][..., ::-1])

    with ThreadPoolExecutor(max_workers=DATA_PHOTOS) as ex:
        for f in [ex.submit(one, i) for i in range(DATA_PHOTOS)]:
            f.result()
    return img_dir, mask_dir


def _profile_fields(meta):
    return {k: getattr(meta, k) for k in (
        "px_dist", "dset_px_dist", "dset_px_count", "probs", "weights",
        "m2", "jsd", "n_samples", "tile_px_count")}


def device_share(tag, fn):
    """``fn()`` once under torch.profiler: its wall, the device time of
    its CUDA events (kernels and copies) and the busy share, and the top
    five events.  Returns fn's result."""
    out, wall_ms, events, _, busy_ms = profiled(fn)
    log(f"{tag} profiled: wall {wall_ms:.1f} ms, device {busy_ms:.2f} ms, "
        f"busy share {busy_ms / wall_ms:.3f}; top: " + "; ".join(
            f"{e.self_device_time_total / 1e3:.2f} ms x{e.count} "
            f"{e.key[:40]}" for e in events[:5]))
    return out


def _extract_stages(cfg, device, img_path, mask_path):
    """One photo's extraction stage by stage, on the host clock: the two
    decodes, then the image's and the mask's upload, unfold (and encode)
    and download, each ending in its download."""
    import cv2
    from pylc_tpu_torch.extract import Extractor
    from pylc_tpu_torch.utils.imageio import get_image
    ex = Extractor(cfg, device)
    ms = []
    for fn in (lambda: get_image(img_path, 3, scale=1.0)[0],
               lambda: get_image(mask_path, 3, scale=1.0,
                                 interpolate=cv2.INTER_NEAREST)[0]):
        t0 = time.perf_counter()
        arrays = fn()
        ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        (ex._tile_image if len(ms) == 1 else ex._encode_mask)(arrays,
                                                              cfg.stride)
        ms.append((time.perf_counter() - t0) * 1e3)
    return ms


def phase_data(device, workdir, card):
    """The data-preparation path on the card (extract, profile, optimize,
    oversample, two train steps), each stage held against the CPU.
    Returns the K2a and K2b launches of the train steps."""
    from pylc_tpu_torch.augment import Augmentor
    from pylc_tpu_torch.config import Config
    from pylc_tpu_torch.db import TileDB
    from pylc_tpu_torch.extract import Extractor
    from pylc_tpu_torch.ops.kernels.fused_loss import (
        fused_loss_backward, fused_loss_forward)
    from pylc_tpu_torch.trainer import train

    cfg = Config().replace(save_dir=os.path.join(workdir, "save"),
                           n_epochs=1)
    t0 = time.perf_counter()
    img_dir, mask_dir = write_data_photos(workdir, cfg)
    log(f"[data] {DATA_PHOTOS} seeded {DATA_PHOTO_HW[1]}x{DATA_PHOTO_HW[0]} "
        f"photos and masks written in {time.perf_counter() - t0:.2f} s "
        "(set-up)")
    torch.cuda.reset_peak_memory_stats(device)

    # each photo on its own, timed
    mp = DATA_PHOTO_HW[0] * DATA_PHOTO_HW[1] / 1e6
    for name in sorted(os.listdir(img_dir)):
        stem = os.path.splitext(name)[0]
        t0 = time.perf_counter()
        one = Extractor(cfg, device).load(
            os.path.join(img_dir, name),
            os.path.join(mask_dir, stem + ".png")).extract(verbose=False)
        secs = time.perf_counter() - t0
        log(f"[data] extract {name}: {one.meta.n_tiles} tiles and masks in "
            f"{secs:.3f} s = {mp / secs:.2f} MP/s (decode, upload, unfold, "
            f"encode, download) ({card})")

    name = sorted(os.listdir(img_dir))[0]
    d_img, tile_ms, d_mask, enc_ms = _extract_stages(
        cfg, device, os.path.join(img_dir, name),
        os.path.join(mask_dir, os.path.splitext(name)[0] + ".png"))
    log(f"[data] {name} by stage: decode the JPEG {d_img:.1f} ms, upload, "
        f"unfold and download its tiles {tile_ms:.1f} ms; decode the PNG "
        f"mask {d_mask:.1f} ms, upload, unfold, encode and download "
        f"{enc_ms:.1f} ms ({card})")

    # the directory, as a user runs it
    ex = Extractor(cfg, device).load(img_dir, mask_dir)
    t0 = time.perf_counter()
    ex.extract(verbose=False).coshuffle()
    secs = time.perf_counter() - t0
    t0 = time.perf_counter()
    ex.profile()
    torch.cuda.synchronize()
    prof_s = time.perf_counter() - t0
    db = ex.get_data()
    n = db.size
    log(f"[data] extract of the directory: {n} tiles and masks "
        f"({db.data['img'].nbytes / 2 ** 20:.1f} + "
        f"{db.data['mask'].nbytes / 2 ** 20:.1f} MiB) in {secs:.3f} s = "
        f"{DATA_PHOTOS * mp / secs:.2f} MP/s; profile {prof_s:.3f} s "
        f"({card})")

    ref = Extractor(cfg, "cpu").load(img_dir, mask_dir)
    ref.extract(verbose=False).coshuffle().profile()
    rdb = ref.get_data()
    for k in ("img", "mask"):
        if not np.array_equal(db.data[k], rdb.data[k]):
            raise AssertionError(f"[data] extracted {k} differ from the CPU")
    if ex.meta.extract != ref.meta.extract or \
            ex.meta.n_tiles != ref.meta.n_tiles:
        raise AssertionError(f"[data] extract meta {ex.meta.extract} != "
                             f"{ref.meta.extract}")
    if _profile_fields(ex.meta) != _profile_fields(ref.meta):
        raise AssertionError("[data] profile histograms differ from the CPU")
    worst = 0.0
    for k in ("px_mean", "px_std"):
        a, b = np.asarray(getattr(ex.meta, k)), np.asarray(
            getattr(ref.meta, k))
        worst = max(worst, float(np.max(np.abs(a - b) / np.abs(b))))
    if worst > DATA_PROFILE_RTOL:
        raise AssertionError(f"[data] px_mean/px_std differ by {worst:.3e}")
    log(f"[data] card against CPU: tiles, masks and the extract meta equal "
        f"byte for byte; profile histograms equal, px_mean/px_std within "
        f"{worst:.3e} (limit {DATA_PROFILE_RTOL})")

    device_share("[data] profile of the DB", ex.profile)
    aug = Augmentor(cfg, device).load(db)
    t0 = time.perf_counter()
    aug.optimize()
    opt_s = time.perf_counter() - t0
    ref_aug = Augmentor(cfg, "cpu").load(rdb).optimize()
    om = aug.optim_meta
    if not np.array_equal(aug.rates, ref_aug.rates) or any(
            not np.array_equal(om[k], v)
            for k, v in ref_aug.optim_meta.items()):
        raise AssertionError("[data] optimize differs from the CPU's")
    if om["aug_n_samples"] < 1:
        raise AssertionError("[data] optimize chose no copies to warp")
    log(f"[data] optimize: {opt_s:.3f} s, threshold {om['threshold']:.2f}, "
        f"rate_coef {om['rate_coef']:.0f}, +{om['aug_n_samples']} copies, "
        f"JSD {ex.meta.jsd:.4f} -> {om['jsd']:.4f}; equal to the CPU's "
        f"({card})")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    aug.oversample(seed=0)
    torch.cuda.synchronize()
    over_s = time.perf_counter() - t0
    ref_aug.oversample(seed=0)
    n_out = len(aug.out_imgs)
    diff = np.abs(aug.out_imgs.astype(np.int16) - ref_aug.out_imgs)
    img_share = float(np.mean(diff <= 1))
    mask_share = float(np.mean(aug.out_masks == ref_aug.out_masks))
    log(f"[data] oversample: {om['aug_n_samples']} copies warped and "
        f"{n_out} tiles profiled in {over_s:.3f} s = "
        f"{om['aug_n_samples'] / over_s:.2f} warped tiles/s, "
        f"{n_out / over_s:.2f} output tiles/s ({card}); against the CPU at "
        f"the same seed: images within 1 grey level on {img_share:.6f} of "
        f"the pixels (max difference {int(diff.max())}), masks equal on "
        f"{mask_share:.6f} (limits {DATA_AGREEMENT})")
    if n_out != len(ref_aug.out_imgs) or img_share < DATA_AGREEMENT or \
            mask_share < DATA_AGREEMENT:
        raise AssertionError("[data] oversample disagrees with the CPU")
    again = Augmentor(cfg, device).load(db).optimize()
    device_share("[data] oversample", lambda: again.oversample(seed=0))
    peak = torch.cuda.max_memory_allocated(device)

    data = aug.get_data().data
    data = {"img": data["img"][:DATA_TRAIN_TILES],
            "mask": data["mask"][:DATA_TRAIN_TILES], "meta": data["meta"]}
    fused_loss_forward.launches = fused_loss_backward.launches = 0
    t0 = time.perf_counter()
    summary = train(cfg, data, None, False, device=device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = (fused_loss_forward.launches, fused_loss_backward.launches)
    with open(os.path.join(cfg.save_dir, summary["model_id"],
                           "losses.json")) as f:
        losses = json.load(f)
    rows = losses["train"] + losses["valid"]
    finite = bool(rows) and bool(np.isfinite(
        np.asarray([r[1:] for r in rows], np.float64)).all())
    log(f"[data] trainer.train on the augmented DB's first "
        f"{DATA_TRAIN_TILES} tiles: {summary['steps']} steps of "
        f"{cfg.batch_size} in {wall:.2f} s wall (2 validations, "
        f"checkpoints); K2a launches {launches[0]}, K2b launches "
        f"{launches[1]} (expected {DATA_STEPS} each); losses "
        f"{[[round(v, 4) for v in r[1:]] for r in rows]}; peak device "
        f"memory of extract to oversample {peak / 2 ** 30:.3f} GiB ({card})")
    if summary["steps"] != DATA_STEPS or launches != (DATA_STEPS,) * 2 \
            or not finite:
        raise AssertionError(f"[data] {summary['steps']} steps, K2 launches "
                             f"{launches}, finite losses {finite}")
    return launches


# [zoo]: (name, what differs from the default config)
ZOO_MODELS = [
    ("deeplab_xception", dict(backbone="xception")),
    ("deeplab_mobilenet", dict(backbone="mobilenet")),
    ("deeplab_drn", dict(backbone="drn")),
    ("unet_upsample", dict(arch="unet")),
    ("resunet_upsample", dict(arch="resunet")),
    ("unet_upconv", dict(arch="unet", up_mode="upconv")),
    ("deeplab_resnet_instance", dict(norm_type="instance")),
    ("unet_layer", dict(arch="unet", norm_type="layer")),
]


# substrings of the names of cuDNN's, cuBLAS's and PyTorch's own
# convolution and GEMM kernels, as torch.profiler reports them
CONV_KERNEL_MARKS = ("xmma", "cutlass", "cudnn", "nvjet", "gemm", "conv",
                     "fprop", "dgrad", "wgrad")


def forward_times(tag, cfg, model, device):
    """The forward ``make_predict`` gives the Segmenter (bf16 autocast),
    on one batch of 16 tiles: ms per batch by CUDA events, and under
    ``torch.profiler`` the launches and the device time, in all and in
    convolutions and GEMMs."""
    from pylc_tpu_torch.train_state import make_predict
    predict = make_predict(cfg, model)
    T = cfg.tile_size
    tiles = torch.from_numpy(np.random.default_rng(8).integers(
        0, 255, (16, T, T, cfg.ch), dtype=np.uint8)).to(device)
    ms = cuda_ms(lambda: predict(tiles), 3)
    _, _, kernels, n_launches, busy = profiled(lambda: predict(tiles))
    conv = sum(e.self_device_time_total for e in kernels
               if any(m in e.key.lower() for m in CONV_KERNEL_MARKS)) / 1e3
    top = "; ".join(f"{e.self_device_time_total / 1e3:.2f} ms x{e.count} "
                    f"{e.key[:60]}" for e in kernels[:3])
    log(f"{tag} {cfg.compute_dtype} forward of 16 tiles of {T} px: "
        f"{ms:.2f} ms per batch; profiled: {n_launches} launches, "
        f"{busy:.2f} ms of device time, {conv:.2f} ms of it in "
        f"convolutions and GEMMs (share {conv / busy:.3f}), idle share "
        f"of the unprofiled batch {max(0.0, 1 - busy / ms):.3f}; top: {top}")


def zoo_train_steps(name, cfg, model, device, phase="[zoo]", want=None):
    """ZOO_STEPS steps of ``make_train_step`` on one fixed batch of
    structured tiles, K2a and K2b on the kernels ``want`` names (the
    compile-time direct and staged ones by default).  Returns (K2a
    launches, K2b launches, median ms, the optimizer, the scheduler)."""
    from pylc_tpu_torch.ops.kernels.fused_loss import (
        backward_variant, forward_variant, fused_loss_backward,
        fused_loss_forward)
    from pylc_tpu_torch.train_state import (make_optimizer, make_train_step,
                                            prepare_batch)
    tag = f"{phase} train {name}"
    T, B = cfg.tile_size, cfg.batch_size
    img, mask = structured_tiles(np.random.default_rng(31), B, T, cfg)
    img, mask = (torch.from_numpy(a).to(device) for a in (img, mask))
    model.to(device, memory_format=torch.channels_last)
    opt, sched = make_optimizer(cfg, model, 1)
    step = make_train_step(cfg, model, opt, sched)
    gen = torch.Generator().manual_seed(32)
    torch.cuda.reset_peak_memory_stats(device)
    fused_loss_forward.launches = fused_loss_backward.launches = 0
    ms, totals = timed_steps(step, img, mask, gen, ZOO_STEPS)
    launches = (fused_loss_forward.launches, fused_loss_backward.launches)
    peak = torch.cuda.max_memory_allocated(device)

    # the kernels this model's logits get: a train-mode forward as the
    # step runs it
    x, _ = prepare_batch(cfg, img.permute(0, 2, 3, 1), mask)
    with torch.no_grad(), torch.autocast(
            "cuda", dtype=torch.bfloat16,
            enabled=cfg.compute_dtype == "bfloat16"):
        logits = model.train()(x.permute(0, 3, 1, 2))
    C = cfg.n_classes
    ran = (forward_variant(logits), backward_variant(logits))
    step_ms = float(np.median(ms[1:]))
    log(f"{tag}: {ZOO_STEPS} steps on one fixed batch of {B} x {T} px, "
        f"{C} classes, logits {tuple(logits.shape)} "
        f"{'channels_last' if logits.stride(1) == 1 else 'contiguous'}: ms "
        f"{[round(v, 2) for v in ms]}, median after the first "
        f"{step_ms:.3f} ms = {B * 1e3 / step_ms:.2f} tiles/s; total loss "
        f"{[round(v, 4) for v in totals]}; K2a {ran[0]} launches "
        f"{launches[0]}, K2b {ran[1]} launches {launches[1]} (expected "
        f"{ZOO_STEPS} each); peak device memory {peak / 2 ** 30:.3f} GiB")
    if launches != (ZOO_STEPS, ZOO_STEPS):
        raise AssertionError(f"{tag}: K2 launches {launches}")
    if ran != (want or (f"direct<C={C}>", f"staged<C={C}>")):
        raise AssertionError(f"{tag}: K2a ran {ran[0]} and K2b {ran[1]}")
    if not np.isfinite(totals).all() or not totals[-1] < totals[0]:
        raise AssertionError(f"{tag}: total loss did not fall: {totals}")
    return launches[0], launches[1], step_ms, opt, sched


def phase_zoo(device, workdir):
    """The models beside DeepLab/ResNet101, at full width and depth."""
    from pylc_tpu_torch.checkpoint import Checkpoint
    from pylc_tpu_torch.config import Config
    from pylc_tpu_torch.infer import Segmenter
    from pylc_tpu_torch.tester import load_model
    from pylc_tpu_torch.train_state import init_model

    for name, kw in ZOO_MODELS:
        cfg = Config().replace(**kw)
        model = init_model(cfg, seed=1)
        tag = f"[zoo] net {name}:"
        if cfg.arch == "deeplab" and cfg.norm_type != "batch":
            # a normalizer that takes its statistics from the input, at a
            # gain of 1 in all 33 residual branches: rounding grows so much
            # layer by layer that f32 does not fix the logits (the CPU in
            # f32 against itself in f64: 7e-4 of the logit scale at 256 px,
            # 2e-6 at this gain)
            with torch.no_grad():
                for key, p in model.named_parameters():
                    if key.endswith("bn3.weight"):
                        p.mul_(RESIDUAL_GAIN)
            tag += f" (every bottleneck's last norm scaled by {RESIDUAL_GAIN})"
        phase_network_check(model.to(device), cfg, device, tag)
        forward_times(f"[zoo] net {name}:", cfg, model, device)
        del model
    torch.cuda.empty_cache()

    counts = {}
    rng = np.random.default_rng(41)
    photo = rng.integers(0, 255, (*SLICE_HW, 3), dtype=np.uint8)
    small = rng.integers(0, 255, (*ZOO_PHOTO_HW, 3), dtype=np.uint8)
    gray = np.ascontiguousarray(photo[..., :1])

    # the two full-size photos
    unet_cfg = Config().replace(arch="unet")
    unet = init_model(unet_cfg, seed=2).to(device)
    counts["zoo_unet_photo"], _, _ = drive_photo(
        "[zoo] photo unet:", unet_cfg, unet, device, photo, N_PHOTOS)
    xcp_cfg = Config().replace(backbone="xception", schema="schema_b", ch=1)
    xcp = init_model(xcp_cfg, seed=3).to(device)
    counts["zoo_xception_photo"], _, _ = drive_photo(
        "[zoo] photo deeplab/xception schema_b gray:", xcp_cfg, xcp, device,
        gray, N_PHOTOS)
    del xcp
    for name, kw in (("deeplab/mobilenet", dict(backbone="mobilenet")),
                     ("deeplab/drn", dict(backbone="drn")),
                     ("resunet", dict(arch="resunet"))):
        cfg = Config().replace(**kw)
        model = init_model(cfg, seed=4).to(device)
        counts[f"zoo_{name.split('/')[-1]}_photo"], _, _ = drive_photo(
            f"[zoo] photo {name}:", cfg, model, device, small, N_PHOTOS)
        del model
    torch.cuda.empty_cache()

    # the two train-step runs
    k2a, k2b, _, opt, sched = zoo_train_steps("unet schema_a", unet_cfg,
                                              unet, device)
    counts["zoo_unet_train"] = (k2a, k2b)
    xcp_cfg = Config().replace(backbone="xception", schema="schema_b")
    xcp = init_model(xcp_cfg, seed=5)
    counts["zoo_xception_train"] = zoo_train_steps(
        "deeplab/xception schema_b", xcp_cfg, xcp, device)[:2]
    del xcp

    # the trained U-Net as the trainer's best model, back through the
    # tester's loader
    unet_cfg.id = unet_cfg.gen_model_id()
    ckpt = Checkpoint(unet_cfg.id, os.path.join(workdir, "save"))
    ckpt.save(unet, opt, sched, unet_cfg, epoch=1, iteration=ZOO_STEPS,
              is_best=True)
    lcfg, loaded, predict = load_model(ckpt.model_file, unet_cfg, device)
    for (k, a), b in zip(unet.state_dict().items(),
                         loaded.state_dict().values()):
        if not torch.equal(a, b):
            raise AssertionError(f"{k} changed through {ckpt.model_file}")
    res = Segmenter(lcfg, predict, device, batch_size=16).segment_array(small)
    cm = res["class_map"]
    if cm.shape != ZOO_PHOTO_HW or int(cm.max()) >= lcfg.n_classes:
        raise AssertionError(f"the U-Net's class map {cm.shape}")
    log(f"[zoo] {os.path.basename(ckpt.model_file)} "
        f"({os.path.getsize(ckpt.model_file) / 2 ** 20:.1f} MiB, keys "
        f"enc0.conv0.weight ... head.bias) written by checkpoint.Checkpoint, "
        f"loaded through tester.load_model and segmented a "
        f"{ZOO_PHOTO_HW[1]}x{ZOO_PHOTO_HW[0]} photo: classes "
        f"{np.unique(cm).tolist()}")
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    import pylc_tpu_torch  # noqa: F401  (fails outside a checkout)

    device = torch.device("cuda", 0)
    card = card_line()
    log(f"[card] {card}; {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}; torch {torch.__version__} CUDA "
        f"{torch.version.cuda}; python {sys.version.split()[0]}")
    phase_build()
    k1_err, k1, k1_checked = phase_k1(device)
    loss_err, dx_err, k2, k2_checked = phase_k2(device)
    build_root = os.path.join(REPO, "pylc_tpu_torch", "_build")
    os.makedirs(build_root, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_root) as workdir:
        launches, pth, seg = phase_slice(device, workdir)
        many_launches = phase_many(seg, device)
        del seg
        radius_launches = phase_radius(device, pth)
        phase_cli(pth, workdir)
        serve_launches, artifact_launches = phase_serve(device, workdir, pth)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(dir=build_root) as workdir:
        wide_launches, wide_train = phase_wide(device, workdir)
        schema_train = phase_schema(device, workdir)
    with tempfile.TemporaryDirectory(dir=build_root) as workdir:
        k2a_launches, k2b_launches = phase_train(device, workdir)
    torch.cuda.empty_cache()
    remat_launches = phase_remat(device, card)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(dir=build_root) as workdir:
        resume_launches = phase_resume(device, workdir)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(dir=build_root) as workdir:
        t0 = time.perf_counter()
        banded_launches, banded_many_launches = phase_multi_photo(
            device, workdir, card)
        torch.cuda.empty_cache()
        ranks_launches = phase_multi_train(device, workdir, card)
        log(f"[multi] {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(dir=build_root) as workdir:
        data_launches = phase_data(device, workdir, card)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(dir=build_root) as workdir:
        zoo = phase_zoo(device, workdir)
    # each path's launches: the count set to 0 just before it, read just
    # after; "launches" is the first path's
    k1_paths = {"slice": launches, "many": many_launches,
                **{f"radius{r}_photo": n for r, n in radius_launches.items()},
                "serve": serve_launches, "artifact": artifact_launches,
                "wide_photo": wide_launches, "banded_photo": banded_launches,
                "banded_many": banded_many_launches,
                **{k: v for k, v in zoo.items() if k.endswith("_photo")}}
    k2_paths = [{"train": n, "remat_train": remat_launches[i],
                 "resume_train": resume_launches[i],
                 "data": data_launches[i],
                 "ranks_train": ranks_launches[i],
                 "wide_train": wide_train[i],
                 **{k: v[i] for k, v in schema_train.items()},
                 **{k: v[i] for k, v in zoo.items() if k.endswith("_train")}}
                for i, n in enumerate((k2a_launches, k2b_launches))]
    for paths in (k1_paths, *k2_paths):
        idle = [k for k, v in paths.items() if v < 1]
        if idle:
            raise AssertionError(f"paths that launched no kernel: {idle}")

    def entry(name, source, replaces, paths, per_unit, err, m, checked):
        n_launches = next(iter(paths.values()))
        # no single PyTorch call computes any of the three functions (K1 is
        # a per-pixel bilateral window, K2a/K2b fuse three losses), so
        # there is no library yardstick
        out = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": n_launches,
               "max_abs_err": err, "ms": m["ms"], "plain_ms": m["plain_ms"],
               "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
               "library_ms": None,
               "share_of_bound": m["bound_ms"] / m["ms"],
               "host_loop_ms": m["host_loop_ms"],
               "launches_per_unit": per_unit, "variant": m["variant"],
               "launches_by_path": paths, "variants": checked}
        if "direct_ms" in m:
            out["direct_ms"] = m["direct_ms"]
        return out

    loss_src = "pylc_tpu_torch/csrc/fused_loss.cu"
    print(json.dumps({"kernels": [
        entry("crf_iteration", "pylc_tpu_torch/csrc/crf_iteration.cu",
              "pylc_tpu/ops/pallas/crf_kernel.py:120", k1_paths,
              "5 per photo", k1_err, k1, k1_checked),
        entry("fused_loss_forward", loss_src,
              "pylc_tpu/ops/pallas/fused_loss.py:131", k2_paths[0],
              "1 per train step", loss_err, k2["fwd"], k2_checked["fwd"]),
        entry("fused_loss_backward", loss_src,
              "pylc_tpu/ops/pallas/fused_loss.py:307", k2_paths[1],
              "1 per train step", dx_err, k2["bwd"], k2_checked["bwd"]),
    ]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
