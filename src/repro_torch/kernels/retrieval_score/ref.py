"""Plain PyTorch version of the retrieval_score kernel: the corpus GEMV."""
from __future__ import annotations

import torch


def retrieval_score_ref(corpus: torch.Tensor, query: torch.Tensor
                        ) -> torch.Tensor:
    """(C, D) corpus, (D,) query -> (C,) f32 scores."""
    return (corpus @ query).to(torch.float32)
