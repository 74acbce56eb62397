"""oswald-tpu: a Smith-Waterman protein database-search engine for GPUs.

A from-scratch JAX/XLA/Pallas implementation with the capabilities of the
reference OSWALD engine (score-only affine-gap Smith-Waterman database
search, CPU+FPGA hybrid):

- inter-sequence data parallelism, one GPU thread per database sequence
  (a Pallas kernel compiled through Triton), replacing the reference's
  SSE/AVX2 lanes and FPGA char16 pipeline
- length-binned, fixed-shape database packing, replacing dynamic chunking
- int32 exact arithmetic, replacing the 8/16/32-bit overflow-rescue ladder
- multi-device sharding via jax.sharding.Mesh + shard_map with a collective
  top-k merge, replacing the multi-FPGA round-robin chunk scheduler and the
  host/FPGA calibration balancer
"""

__version__ = "0.1.0"

from oswald_tpu.alphabet import encode, decode, ALPHABET, DUMMY
from oswald_tpu.submat import get_submat, MATRIX_NAMES

__all__ = [
    "encode", "decode", "ALPHABET", "DUMMY",
    "get_submat", "MATRIX_NAMES", "__version__",
]
