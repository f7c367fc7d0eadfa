"""cglb_tpu_torch: the PyTorch + CUDA port of cglb_tpu.

CGLB (Artemev, Burt & van der Wilk, ICML 2021) on an NVIDIA H100: the models
and bounds in PyTorch, and the three kernels the JAX package wrote in Pallas
for the TPU as CUDA C++ for sm_90a (``csrc/``, built at first use).  The JAX
package ``cglb_tpu`` is the reference; this package never imports it, nor
jax.
"""

from . import config
from .config import (default_float, default_jitter, set_default_float,
                     set_default_jitter, set_default_seed)

__version__ = "0.1.0"

__all__ = ["config", "default_float", "default_jitter", "set_default_float",
           "set_default_jitter", "set_default_seed"]
