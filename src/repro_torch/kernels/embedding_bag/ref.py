"""Plain PyTorch versions of the EmbeddingBag oracles: the fixed-bag sum
the embedding_bag kernel computes (``models/recsys.py
embedding_bag(mode="sum")``), its gradient with respect to the table (the
backward kernel's), and the ragged sum of ``models/recsys.py
embedding_bag_ragged``, which has no kernel."""
from __future__ import annotations

import torch


def embedding_bag_ref(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(V, D) table, (B, BAG) int32 -> (B, D) bag sums."""
    return table[idx].sum(dim=-2)


def embedding_bag_backward_ref(grad_out: torch.Tensor, idx: torch.Tensor,
                               rows: int) -> torch.Tensor:
    """(B, D) gradient of the bag sums, (B, BAG) ids -> the (rows, D)
    gradient of the table: a zeroed table and ``index_add_`` of each bag's
    gradient at each of its ids, duplicates summed."""
    b, bag = idx.shape
    d = grad_out.shape[1]
    return torch.zeros(rows, d, dtype=grad_out.dtype,
                       device=grad_out.device).index_add_(
        0, idx.reshape(-1).long(),
        grad_out[:, None, :].expand(b, bag, d).reshape(b * bag, d))


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
