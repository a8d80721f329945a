"""linne_tpu_torch — the LINNE codec's batched encode and pooled decode in
PyTorch, with the decode recurrence as a hand-written CUDA kernel.

The JAX package `linne_tpu` is the reference. This package imports its
jax-free host layers (format, presets, parameters, WAV I/O, the native host
library, the host decoder and the byte-exact host encoder) and never imports
jax itself.
"""

__version__ = "0.1.0"
