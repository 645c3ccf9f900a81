"""Dense-CRF mean-field refinement (local-window ConvCRF form).

Port of ``pylc_tpu/ops/crf.py``, following the steps of its kernel
branch: mean-pool the probabilities and the guide by ``downsample``, set
the unary to log(q + eps), run ``n_iters`` channel-major iterations of
kernel K1 (``ops/kernels/crf_kernel.py``), upsample with align corners
to ``downsample`` times the pooled size, crop to H x W, renormalize.

The iteration follows the Pallas kernel's bilateral weight, a product of
two exps; the JAX package's XLA branch takes the exp of their sum.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from pylc_tpu_torch.models.layers import resize_bilinear_align_corners
from pylc_tpu_torch.ops.kernels.crf_kernel import crf_iteration


class CRFParams(NamedTuple):
    n_iters: int = 5
    radius: int = 3
    w_appearance: float = 3.0
    sigma_spatial_app: float = 3.0
    sigma_color: float = 13.0
    w_smoothness: float = 1.0
    sigma_spatial_sm: float = 1.5
    downsample: int = 2        # message-passing grid subsampling
    eps: float = 1e-8


def _pool(x: torch.Tensor, k: int) -> torch.Tensor:
    """Mean-pool [H, W, C] by factor k, edge-padding to a multiple."""
    H, W, C = x.shape
    Hp, Wp = -(-H // k) * k, -(-W // k) * k
    if (Hp, Wp) != (H, W):
        rows = torch.arange(Hp, device=x.device).clamp_(max=H - 1)
        cols = torch.arange(Wp, device=x.device).clamp_(max=W - 1)
        x = x[rows][:, cols]
    return x.reshape(Hp // k, k, Wp // k, k, C).mean(dim=(1, 3))


def _upsample(x: torch.Tensor, H: int, W: int, k: int) -> torch.Tensor:
    """[h, w, C] -> align-corners resize to [h*k, w*k], cropped to
    [H, W, C] (not a resize straight to H x W)."""
    h, w, _ = x.shape
    up = resize_bilinear_align_corners(x.permute(2, 0, 1)[None], h * k, w * k)
    return up[0, :, :H, :W].permute(1, 2, 0)


def mean_field(probs: torch.Tensor, guide: torch.Tensor,
               params: CRFParams = CRFParams()) -> torch.Tensor:
    """Refine a label distribution.

    probs: [H, W, C] (the stitched softmax; the unary is log(probs)).
    guide: [H, W, G] or [H, W] guidance image (uint8 or float).
    Returns the refined [H, W, C] f32 distribution at full resolution."""
    H, W, _ = probs.shape
    g = guide.float()
    if g.dim() == 2:
        g = g[..., None]
    k = max(1, params.downsample)
    q0 = probs.float()
    if k > 1:
        q0, g = _pool(q0, k), _pool(g, k)
    unary = torch.log(q0 + params.eps)

    q_cf = q0.permute(2, 0, 1).contiguous()
    g_cf = g.permute(2, 0, 1).contiguous()
    u_cf = unary.permute(2, 0, 1).contiguous()
    for _ in range(params.n_iters):
        q_cf = crf_iteration(q_cf, g_cf, u_cf, params.radius,
                             params.sigma_spatial_app, params.sigma_color,
                             params.sigma_spatial_sm, params.w_appearance,
                             params.w_smoothness, params.eps)
    q = q_cf.permute(1, 2, 0)
    if k > 1:
        q = _upsample(q, H, W, k)
        q = q / q.sum(dim=-1, keepdim=True)
    return q


def make_crf(cfg=None, **overrides) -> Callable:
    """CRF callable (canvas_probs, guide_img) -> refined probs for the
    Segmenter, with parameters from the Config's ``crf_*`` fields and
    keyword ``overrides`` on top."""
    kw = {}
    if cfg is not None:
        kw = dict(n_iters=cfg.crf_iters, radius=cfg.crf_radius,
                  downsample=cfg.crf_downsample,
                  w_appearance=cfg.crf_w_app,
                  sigma_spatial_app=cfg.crf_sigma_app,
                  sigma_color=cfg.crf_sigma_color,
                  w_smoothness=cfg.crf_w_smooth,
                  sigma_spatial_sm=cfg.crf_sigma_smooth)
    kw.update(overrides)
    params = CRFParams(**kw)

    def crf(canvas, guide):
        return mean_field(canvas, guide, params)

    crf.params = params
    return crf
