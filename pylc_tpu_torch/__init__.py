"""PyLC on PyTorch and CUDA: the port of ``pylc_tpu`` to an NVIDIA H100.

The file layout mirrors ``pylc_tpu/``, so each module here has one
reference module there.  The package imports ``torch`` and never
``jax``; of the JAX package it uses only the parts that are free of jax
(``config``, ``native``, ``convert.load_reference_pth``, the CLI parser
and the ``Evaluator`` base class).  Its one hand-written kernel is the
dense-CRF mean-field iteration (``ops/kernels/crf_kernel.py``).

Entry point: ``python -m pylc_tpu_torch <mode>``.
"""

__version__ = "0.1.0"
