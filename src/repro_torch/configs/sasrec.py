"""sasrec [arXiv:1808.09781; paper]: embed_dim=50 n_blocks=2 n_heads=1
seq_len=50 interaction=self-attn-seq.  Item corpus scaled to 1M rows."""
import numpy as np
import torch

from ..models.recsys import SASRecConfig
from .base import ArchSpec, recsys_shapes

CONFIG = SASRecConfig(name="sasrec", n_items=1_000_000, embed_dim=50,
                      n_blocks=2, n_heads=1, seq_len=50)

SMOKE = SASRecConfig(name="sasrec-smoke", n_items=512, embed_dim=16,
                     n_blocks=2, n_heads=1, seq_len=10)

SERVE_CANDS = 1024  # ranking-stage candidate count per request


def smoke_batch(cfg, rng: np.random.Generator, device="cpu"):
    b, L = 8, cfg.seq_len

    def ids():
        return torch.from_numpy(np.asarray(
            rng.integers(1, cfg.n_items, (b, L)), np.int32)).to(device)

    return {"seq": ids(), "pos": ids(), "neg": ids()}


SPEC = ArchSpec(
    id="sasrec", family="recsys", source="arXiv:1808.09781; paper",
    config=CONFIG, smoke_config=SMOKE, shapes=recsys_shapes(),
    optimizer="adamw", smoke_batch=smoke_batch,
    notes="sequential self-attention recommender; serve scores 1024 "
          "candidates/request, retrieval scores the 1M-item corpus")
