"""xdeepfm [arXiv:1803.05170; paper]: n_sparse=39 embed_dim=10
cin_layers=200-200-200 mlp=400-400 interaction=cin.

Embedding substrate: 39 hashed fields x 1M rows x dim 10 = 390M rows in
one concatenated table, plus the 39M-row wide (linear) table.
"""
import numpy as np
import torch

from ..models.recsys import XDeepFMConfig
from .base import ArchSpec, recsys_shapes, sds

CONFIG = XDeepFMConfig(name="xdeepfm", n_sparse=39, vocab_per_field=1_000_000,
                       embed_dim=10, cin_layers=(200, 200, 200),
                       mlp_sizes=(400, 400))

SMOKE = XDeepFMConfig(name="xdeepfm-smoke", n_sparse=5, vocab_per_field=128,
                      embed_dim=8, cin_layers=(8, 8), mlp_sizes=(16, 16))


def inputs(cfg, shape):
    d = shape.dims
    if shape.kind == "train":
        return {"idx": sds((d["batch"], cfg.n_sparse), "int32"),
                "label": sds((d["batch"],), "float32")}
    if shape.kind == "serve":
        return {"idx": sds((d["batch"], cfg.n_sparse), "int32")}
    if shape.kind == "retrieval":
        return {"idx": sds((1, cfg.n_sparse), "int32"),
                "cand": sds((d["n_candidates"],), "int32")}
    raise ValueError(shape.kind)


def smoke_batch(cfg, rng: np.random.Generator, device="cpu"):
    b = 16
    idx = np.asarray(rng.integers(0, cfg.vocab_per_field, (b, cfg.n_sparse)),
                     np.int32)
    label = np.asarray(rng.integers(0, 2, b), np.float32)
    return {"idx": torch.from_numpy(idx).to(device),
            "label": torch.from_numpy(label).to(device)}


SPEC = ArchSpec(
    id="xdeepfm", family="recsys", source="arXiv:1803.05170; paper",
    config=CONFIG, smoke_config=SMOKE, shapes=recsys_shapes(),
    optimizer="adamw", inputs=inputs, smoke_batch=smoke_batch,
    notes="CIN interaction; wide term through kernels/embedding_bag")
