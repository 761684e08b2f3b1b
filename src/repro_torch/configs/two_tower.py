"""two-tower-retrieval [RecSys'19 (YouTube); unverified]: embed_dim=256
tower_mlp=1024-512-256 interaction=dot, sampled-softmax retrieval with
logQ correction.  8 user / 4 item hashed feature fields x 1M rows x 64,
1M-item precomputed serving corpus."""
import numpy as np
import torch

from ..models.recsys import TwoTowerConfig
from .base import ArchSpec, recsys_shapes, sds

CONFIG = TwoTowerConfig(name="two-tower-retrieval", embed_dim=256,
                        tower_mlp=(1024, 512, 256), n_user_fields=8,
                        n_item_fields=4, field_vocab=1_000_000,
                        field_dim=64, n_corpus=1_048_576)

SMOKE = TwoTowerConfig(name="two-tower-smoke", embed_dim=32,
                       tower_mlp=(64, 32), n_user_fields=4,
                       n_item_fields=2, field_vocab=128, field_dim=8,
                       n_corpus=1024)


def inputs(cfg, shape):
    d = shape.dims
    if shape.kind == "train":
        return {"user_idx": sds((d["batch"], cfg.n_user_fields), "int32"),
                "item_idx": sds((d["batch"], cfg.n_item_fields), "int32"),
                "logq": sds((d["batch"],), "float32")}
    if shape.kind == "serve":
        return {"user_idx": sds((d["batch"], cfg.n_user_fields), "int32"),
                "item_idx": sds((d["batch"], cfg.n_item_fields), "int32")}
    if shape.kind == "retrieval":
        return {"user_idx": sds((1, cfg.n_user_fields), "int32")}
    raise ValueError(shape.kind)


def smoke_batch(cfg, rng: np.random.Generator, device="cpu"):
    b = 8

    def ids(fields):
        return torch.from_numpy(np.asarray(
            rng.integers(0, cfg.field_vocab, (b, fields)), np.int32)).to(device)

    return {"user_idx": ids(cfg.n_user_fields),
            "item_idx": ids(cfg.n_item_fields),
            "logq": torch.zeros(b, dtype=torch.float32, device=device)}


SPEC = ArchSpec(
    id="two-tower-retrieval", family="recsys",
    source="RecSys'19 (YouTube); unverified",
    config=CONFIG, smoke_config=SMOKE, shapes=recsys_shapes(),
    optimizer="adamw", inputs=inputs, smoke_batch=smoke_batch,
    notes="in-batch sampled softmax + logQ; retrieval_cand is the 1M-corpus "
          "GEMV (kernels/retrieval_score)")
