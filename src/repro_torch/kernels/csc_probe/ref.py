"""Plain PyTorch version of the csc_probe kernel: the CSC sketch's own
torch partition mask (``baselines/csc.py CSCSketch.partition_mask_torch``,
the mirror of the JAX package's ``partition_mask_jnp``)."""
from __future__ import annotations

import torch


def csc_probe_ref(sketch, fps: torch.Tensor) -> torch.Tensor:
    return sketch.partition_mask_torch(fps)
