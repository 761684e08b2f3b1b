"""mind [arXiv:1904.08030; unverified]: embed_dim=64 n_interests=4
capsule_iters=3 interaction=multi-interest.  1M-item corpus, 50-step
behavior sequences, 20 sampled negatives."""
import numpy as np
import torch

from ..models.recsys import MINDConfig
from .base import ArchSpec, recsys_shapes, sds

CONFIG = MINDConfig(name="mind", n_items=1_000_000, embed_dim=64,
                    n_interests=4, capsule_iters=3, seq_len=50)

SMOKE = MINDConfig(name="mind-smoke", n_items=512, embed_dim=16,
                   n_interests=4, capsule_iters=3, seq_len=10)

N_NEG = 20
SERVE_CANDS = 1024


def inputs(cfg, shape):
    d = shape.dims
    L = cfg.seq_len
    if shape.kind == "train":
        return {"seq": sds((d["batch"], L), "int32"),
                "pos": sds((d["batch"],), "int32"),
                "neg": sds((d["batch"], N_NEG), "int32")}
    if shape.kind == "serve":
        return {"seq": sds((d["batch"], L), "int32"),
                "cand": sds((d["batch"], SERVE_CANDS), "int32")}
    if shape.kind == "retrieval":
        return {"seq": sds((1, L), "int32"),
                "cand": sds((d["n_candidates"],), "int32")}
    raise ValueError(shape.kind)


def smoke_batch(cfg, rng: np.random.Generator, device="cpu"):
    b, L = 8, cfg.seq_len

    def ids(shape):
        return torch.from_numpy(np.asarray(
            rng.integers(1, cfg.n_items, shape), np.int32)).to(device)

    return {"seq": ids((b, L)), "pos": ids((b,)), "neg": ids((b, N_NEG))}


SPEC = ArchSpec(
    id="mind", family="recsys", source="arXiv:1904.08030; unverified",
    config=CONFIG, smoke_config=SMOKE, shapes=recsys_shapes(),
    optimizer="adamw", inputs=inputs, smoke_batch=smoke_batch,
    notes="B2I capsule routing (3 iters, 4 interests); max-over-interests "
          "scoring")
