"""PyLC on PyTorch and CUDA: the port of ``pylc_tpu`` to an NVIDIA H100.

The file layout mirrors ``pylc_tpu/``, so each module here has one
reference module there.  The package imports ``torch`` and never
``jax``, nor anything of the JAX package: where it needs a jax-free
module of it (config, schemas, CLI parser, host palette look-ups,
evaluator, numpy utilities) it keeps its own copy.  Its hand-written
kernels are the dense-CRF mean-field iteration
(``ops/kernels/crf_kernel.py``) and the fused loss's forward and
backward (``ops/kernels/fused_loss.py``).

Entry point: ``python -m pylc_tpu_torch <mode>``.
"""

__version__ = "0.1.0"
