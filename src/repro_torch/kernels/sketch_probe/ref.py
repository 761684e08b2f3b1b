"""Plain PyTorch version of the sketch_probe kernel: the MPHF's own torch
lookup (``core/mphf.py lookup_torch``)."""
from ...core.mphf import lookup_torch as sketch_probe_ref

__all__ = ["sketch_probe_ref"]
