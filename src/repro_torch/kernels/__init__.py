"""Hand-written CUDA kernels of the query path, one package per kernel.

  sketch_probe    — immutable-sketch MPHF probe
  bitset_ops      — posting-plane AND/OR fold over the token axis + popcount
  bitmap_extract  — hit bitmap -> ascending posting ids

Each package has ``ops.py`` (the wrapper: checks, launch on CUDA tensors,
plain version on CPU tensors, ``launch_count``) and ``ref.py`` (the plain
PyTorch version).  Sources live in ``csrc/``; ``build.py`` compiles them
with nvcc at first use.
"""
