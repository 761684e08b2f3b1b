"""PyTorch + CUDA port of the DynaWarp (COPR) log store.

Layout mirrors the JAX package ``repro``: ``core/`` (hashing, sketches,
segments, the wave query engine), ``kernels/<name>/`` (hand-written CUDA
kernels for Hopper, each beside its plain PyTorch version) and
``logstore/`` (batched storage, the stores, the dataset generator).  The
port imports torch and numpy only.  Entry points run on the GPU unless the
caller passes ``device="cpu"``.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
