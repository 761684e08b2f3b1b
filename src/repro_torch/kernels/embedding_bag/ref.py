"""Plain PyTorch version of the embedding_bag kernel: gather + sum over
the bag axis (``models/recsys.py embedding_bag(mode="sum")``)."""
from __future__ import annotations

import torch


def embedding_bag_ref(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(V, D) table, (B, BAG) int32 -> (B, D) bag sums."""
    return table[idx].sum(dim=-2)
