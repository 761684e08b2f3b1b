"""Plain PyTorch version of the token_hash kernel: the port's mirror of
``np_token_fingerprints`` (``core/hashing.py torch_token_fingerprints``),
returned as int32 bits like the kernel's output."""
from __future__ import annotations

import torch

from ...core.hashing import as_i32, torch_token_fingerprints


def token_hash_ref(tokens_u8: torch.Tensor, lengths: torch.Tensor
                   ) -> torch.Tensor:
    """(N, L) uint8 + (N,) lengths -> (N,) int32-viewed u32 fingerprints."""
    return as_i32(torch_token_fingerprints(tokens_u8, lengths))
