"""Hand-written CUDA kernels of the port, one package per kernel.

  sketch_probe    — immutable-sketch MPHF probe
  bitset_ops      — posting-plane AND/OR fold over the token axis + popcount
  bitmap_extract  — hit bitmap -> ascending posting ids
  token_hash      — ingest-side batched token fingerprinting
  csc_probe       — CSC baseline probe (the sketch-vs-sketch comparison)

Each package has ``ops.py`` (the wrapper: checks, launch on CUDA tensors,
plain version on CPU tensors, ``launch_count``) and ``ref.py`` (the plain
PyTorch version).  Sources live in ``csrc/``; ``build.py`` compiles them
with nvcc at first use.
"""
from .bitmap_extract.ops import bitmap_extract
from .bitset_ops.ops import bitset_reduce, bitset_reduce_batch
from .csc_probe.ops import csc_partition_mask
from .sketch_probe.ops import mphf_probe_arrs
from .token_hash.ops import token_fingerprints

__all__ = ["bitmap_extract", "bitset_reduce", "bitset_reduce_batch",
           "csc_partition_mask", "mphf_probe_arrs", "token_fingerprints"]
