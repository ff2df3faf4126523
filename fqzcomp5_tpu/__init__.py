"""fqzcomp5-tpu: a FASTQ/FASTA compression framework with a JAX device
engine.

A from-scratch reimplementation of the capabilities of fqzcomp5 (a
single-binary C compressor):

- Entropy coding (interleaved-state rANS Nx16) runs as JAX kernels
  (Pallas through Triton on a GPU) with the 32 rANS states of a
  stream on the 32 lanes of a warp.
- Adaptive-context codecs (fqzcomp quality model, order-k sequence
  model) have a bit-exact native C++ engine for the sequential parity
  path, plus batched JAX formulations for device execution across many
  independent blocks.
- Blocks are independent (models reset per block), so files scale
  data-parallel over a `jax.sharding.Mesh` of chips/hosts; compressed
  payloads and index entries are gathered to host 0 which writes the
  FQZ5 container.

The on-disk FQZ5 format (header/blocks/index/trailer) is byte-
compatible with the reference (fqzcomp5.c:35-82).
"""

__version__ = "0.1.0"

from fqzcomp5_tpu.options import Options  # noqa: F401
