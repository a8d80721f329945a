"""linne_tpu_torch — the LINNE codec's batched encode and pooled decode in
PyTorch, with the decode recurrence as a hand-written CUDA kernel.

The JAX package `linne_tpu` is the reference, but this package imports
nothing of it and never imports jax. It keeps its own copies of the host
layers it needs, under the same relative paths: `constants`, `presets`,
`codec/params`, `format/`, `io/wav`, `native` (with `csrc/linne_host.cpp`),
the byte-exact host encoder `exact/` and the host decoder `codec/decoder`.
"""

__version__ = "0.1.0"
