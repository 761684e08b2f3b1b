"""Plain PyTorch versions of the EmbeddingBag oracles: the fixed-bag sum
the embedding_bag kernel computes (``models/recsys.py
embedding_bag(mode="sum")``), and the ragged sum of
``models/recsys.py embedding_bag_ragged``, which has no kernel."""
from __future__ import annotations

import torch


def embedding_bag_ref(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(V, D) table, (B, BAG) int32 -> (B, D) bag sums."""
    return table[idx].sum(dim=-2)


def embedding_bag_ragged_ref(table: torch.Tensor, indices: torch.Tensor,
                             segment_ids: torch.Tensor, n_bags: int
                             ) -> torch.Tensor:
    """(V, D) table, indices (nnz,), segment_ids (nnz,) bag ids ->
    (n_bags, D) bag sums, an empty bag zero (a scatter-add, independent of
    the model's ``index_add_``)."""
    rows = table[indices.long()]
    seg = segment_ids.long()[:, None].expand_as(rows)
    return torch.zeros(n_bags, table.shape[1], dtype=table.dtype,
                       device=table.device).scatter_add_(0, seg, rows)
