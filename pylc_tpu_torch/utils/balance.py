"""Class-balance metrics (JSD, M2) — reference utils/metrics.py:90-132.

A copy of ``pylc_tpu/utils/balance.py`` (numpy only), so that the port
needs nothing of the JAX package; ``tests/test_torch_config.py`` holds
the two equal."""

from __future__ import annotations

import numpy as np


def jsd(p, q):
    """Jensen-Shannon divergence between distributions p and q
    (reference utils/metrics.py:90-111, same eps placement)."""
    p = np.asarray(p, dtype=np.float64)
    q = np.asarray(q, dtype=np.float64)
    eps = 1e-8
    m = 0.5 * (p + q + eps)
    return 0.5 * np.sum(p * np.log(p / m + eps)) + \
        0.5 * np.sum(q * np.log(q / m + eps))


def m2(p, n_classes: int):
    """M2 Gibbs index — variance of a multinomial distribution
    (reference utils/metrics.py:114-132)."""
    assert n_classes > 1, "M2 variance for multiple classes."
    p = np.asarray(p, dtype=np.float64)
    return (n_classes / (n_classes - 1)) * (1 - np.sum(p ** 2))
