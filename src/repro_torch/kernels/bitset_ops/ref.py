"""Plain PyTorch version of the bitset_ops kernel (mirrors the JAX
``kernels/bitset_ops/ref.py``).  Planes are int32 tensors of u32 bits."""
from __future__ import annotations

import torch

from ...core.hashing import torch_popcount32


def bitset_reduce_batch_ref(planes: torch.Tensor, *, op: str = "and"
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """(Q, T, W) -> ((Q, W) combined, (Q,) int32 popcounts)."""
    combined = planes[:, 0]
    for t in range(1, planes.shape[1]):
        combined = (combined & planes[:, t]) if op == "and" \
            else (combined | planes[:, t])
    counts = torch_popcount32(combined).sum(dim=-1).to(torch.int32)
    return combined.contiguous(), counts


def bitset_reduce_ref(planes: torch.Tensor, *, op: str = "and"
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """(T, W) -> ((W,) combined, () int32 popcount)."""
    combined, counts = bitset_reduce_batch_ref(planes[None], op=op)
    return combined[0], counts[0]


def bitset_reduce_ragged_ref(planes: torch.Tensor, lens: torch.Tensor, *,
                             op: str = "and"
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """(Qb, T, W) planes, (Q,) token counts -> ((Q, W), (Q,)): the first Q
    rows, each slot past its row's count set to the fold's neutral word
    (as the reference engine's ``jnp.where`` of the pad slots), folded."""
    q, t = lens.shape[0], planes.shape[1]
    mask = torch.arange(t, device=planes.device) < lens[:, None]
    neutral = -1 if op == "and" else 0
    return bitset_reduce_batch_ref(
        torch.where(mask[:, :, None], planes[:q], neutral), op=op)
