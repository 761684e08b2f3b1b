"""Wrapper of the token_hash kernel: batched token fingerprints of a packed
(N, L) u8 token matrix (the ingest path's term matrices and every query
wave's tokens)."""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import build
from .ref import token_hash_ref


@functools.cache
def _kernel():
    lib = build.library("token_hash")
    p, i = ctypes.c_void_p, ctypes.c_int
    return lib, build.declare(lib, "token_hash_launch", p, p, i, i, p, p)


def token_fingerprints(tokens_u8: torch.Tensor, lengths: torch.Tensor
                       ) -> torch.Tensor:
    """(N, L) uint8 zero-padded tokens + (N,) int32 lengths -> (N,) int32
    tensor of u32 fingerprints, bit-identical to ``token_fingerprint`` of
    each row's first ``lengths[i]`` bytes.  A CUDA tensor launches the
    kernel; a CPU tensor takes the plain version."""
    if (tokens_u8.dim() != 2 or tokens_u8.dtype != torch.uint8
            or not tokens_u8.is_contiguous()):
        raise ValueError("tokens_u8 must be a contiguous (N, L) uint8 tensor")
    n, l = tokens_u8.shape
    if (lengths.shape != (n,) or lengths.dtype != torch.int32
            or not lengths.is_contiguous()
            or lengths.device != tokens_u8.device):
        raise ValueError(f"lengths must be a contiguous ({n},) int32 tensor "
                         f"on {tokens_u8.device}")
    if tokens_u8.device.type == "cpu":
        return token_hash_ref(tokens_u8, lengths)
    if tokens_u8.device.type != "cuda":
        raise ValueError(f"token_hash runs on cuda or cpu, not "
                         f"{tokens_u8.device}")
    out = torch.empty(n, dtype=torch.int32, device=tokens_u8.device)
    if n:
        lib, fn = _kernel()
        with torch.cuda.device(tokens_u8.device):
            err = fn(tokens_u8.data_ptr(), lengths.data_ptr(), n, l,
                     out.data_ptr(), build.stream_of(tokens_u8))
        build.check(lib, err, "token_hash")
        build.count_launch(token_fingerprints)
    return out


token_fingerprints.launch_count = 0
