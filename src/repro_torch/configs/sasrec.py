"""sasrec [arXiv:1808.09781; paper]: embed_dim=50 n_blocks=2 n_heads=1
seq_len=50 interaction=self-attn-seq.  Item corpus scaled to 1M rows."""
import numpy as np
import torch

from ..models.recsys import SASRecConfig
from .base import ArchSpec, recsys_shapes, sds

CONFIG = SASRecConfig(name="sasrec", n_items=1_000_000, embed_dim=50,
                      n_blocks=2, n_heads=1, seq_len=50)

SMOKE = SASRecConfig(name="sasrec-smoke", n_items=512, embed_dim=16,
                     n_blocks=2, n_heads=1, seq_len=10)

SERVE_CANDS = 1024  # ranking-stage candidate count per request


def inputs(cfg, shape):
    d = shape.dims
    L = cfg.seq_len
    if shape.kind == "train":
        return {"seq": sds((d["batch"], L), "int32"),
                "pos": sds((d["batch"], L), "int32"),
                "neg": sds((d["batch"], L), "int32")}
    if shape.kind == "serve":
        return {"seq": sds((d["batch"], L), "int32"),
                "cand": sds((d["batch"], SERVE_CANDS), "int32")}
    if shape.kind == "retrieval":
        return {"seq": sds((1, L), "int32"),
                "cand": sds((d["n_candidates"],), "int32")}
    raise ValueError(shape.kind)


def smoke_batch(cfg, rng: np.random.Generator, device="cpu"):
    b, L = 8, cfg.seq_len

    def ids():
        return torch.from_numpy(np.asarray(
            rng.integers(1, cfg.n_items, (b, L)), np.int32)).to(device)

    return {"seq": ids(), "pos": ids(), "neg": ids()}


SPEC = ArchSpec(
    id="sasrec", family="recsys", source="arXiv:1808.09781; paper",
    config=CONFIG, smoke_config=SMOKE, shapes=recsys_shapes(),
    optimizer="adamw", inputs=inputs, smoke_batch=smoke_batch,
    notes="sequential self-attention recommender; serve scores 1024 "
          "candidates/request, retrieval scores the 1M-item corpus")
