"""Parity of the port's tile grid with pylc_tpu/ops/tiles.py and with the
reference's own outputs in tests/golden/reference_goldens.npz."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pylc_tpu import native
from pylc_tpu.config import DEFAULT_SCHEMA, Schema
from pylc_tpu.ops import tiles as jt
from pylc_tpu_torch.ops import tiles as tt

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "reference_goldens.npz")


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


@pytest.mark.parametrize("w,h,tile,stride", [
    (3872, 2592, 512, 256), (2592, 3872, 512, 256), (1000, 700, 512, 512),
    (640, 480, 64, 32), (513, 1031, 128, 64),
])
def test_geometry_matches_jax(w, h, tile, stride):
    assert tt.adjust_to_tile_dims(w, h, tile, stride) == \
        jt.adjust_to_tile_dims(w, h, tile, stride)
    assert tt.grid_dims(w, h, tile, stride) == \
        jt.grid_dims(w, h, tile, stride)


def test_geometry_matches_reference_golden(golden):
    for w, h, wf, hf, crop in golden["adjust_dims"]:
        assert tt.adjust_to_tile_dims(int(w), int(h), 512, 256) == \
            (wf, hf, crop)


@pytest.mark.parametrize("H,W,tile,stride", [
    (128, 192, 64, 32), (96, 64, 32, 32), (100, 90, 32, 16),  # remainder
])
def test_unfold_matches_jax(H, W, tile, stride):
    img = np.random.default_rng(0).integers(0, 256, (H, W, 3), np.uint8)
    want = np.asarray(jt.unfold_tiles(jnp.asarray(img), tile, stride))
    got = tt.unfold_tiles(torch.from_numpy(img), tile, stride).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stitch_matches_jax(dtype):
    n_rows, n_cols, tile, stride, C = 3, 5, 64, 32, 9
    p = np.random.default_rng(1).random(
        (n_rows * n_cols, tile, tile, C)).astype(np.float32)
    jp = jnp.asarray(p).astype(dtype)
    tp = torch.from_numpy(p).to(getattr(torch, dtype))
    want = np.asarray(jt.stitch_probs(jp, n_rows, n_cols, tile, stride))
    got = tt.stitch_probs(tp, n_rows, n_cols, tile, stride)
    assert got.dtype == torch.float32  # f32 sums from bf16 too
    # the same f32 additions in the same order; one division
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    acc, cnt = tt.accumulate_blocks(tp, n_rows, n_cols, tile, stride)
    jacc, jcnt = jt.accumulate_blocks(jp, n_rows, n_cols, tile, stride)
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(jcnt))
    np.testing.assert_allclose(acc.numpy(), np.asarray(jacc), rtol=1e-6)


def test_reconstruct_matches_reference_golden(golden):
    """softmax -> stitch -> argmax -> colourize against the reference's
    sequential reconstruct: equal everywhere except the quadruple-overlap
    corners the reference double-softmaxes (docs/DEVIATIONS.md D1)."""
    palette = np.asarray(Schema.load(DEFAULT_SCHEMA).palette_rgb, np.uint8)
    logits = torch.from_numpy(golden["reconstruct_logits"])  # [N, C, t, t]
    want = golden["reconstruct_mask_rgb"]
    tile, stride, n_rows, n_cols = 64, 32, 3, 4
    probs = torch.softmax(logits.permute(0, 2, 3, 1), dim=-1)
    canvas = tt.stitch_probs(probs, n_rows, n_cols, tile, stride)
    cm = canvas.argmax(-1).to(torch.uint8).numpy()
    got = native.colourize(cm, palette)
    assert got.shape == want.shape
    assert np.mean(np.all(got == want, axis=-1)) > 0.97
    mask = np.ones(cm.shape, bool)
    olap = tile - stride
    for i in range(1, n_rows):
        for j in range(1, n_cols):
            mask[i * stride:i * stride + olap,
                 j * stride:j * stride + olap] = False
    np.testing.assert_array_equal(got[mask], want[mask])


def test_bad_geometry_raises():
    with pytest.raises(ValueError):
        tt.adjust_to_tile_dims(1000, 700, 512, 300)
    with pytest.raises(ValueError):
        tt.stitch_probs(torch.zeros(5, 64, 64, 2), 2, 3, 64, 32)
