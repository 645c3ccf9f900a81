"""Run configuration.

The JAX package's ``Config`` is free of jax and is the one source of
defaults, schemas and checkpoint meta for both packages, so the port
uses it as it is; the port's modules and scripts import it from here.
"""

from pylc_tpu.config import Config  # noqa: F401
