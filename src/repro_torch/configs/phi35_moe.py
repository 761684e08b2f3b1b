"""phi3.5-moe-42b-a6.6b [hf:microsoft/Phi-3.5-MoE-instruct; hf]: 32L
d_model=4096 32H (GQA kv=8) d_ff=6400 vocab=32064, MoE 16 experts top-2.

long_500k skipped: pure full-attention arch."""
import numpy as np
import torch

from ..models.transformer import LMConfig
from .base import ArchSpec, lm_input_specs, lm_shapes

CONFIG = LMConfig(
    name="phi3.5-moe-42b-a6.6b", n_layers=32, d_model=4096, n_heads=32,
    n_kv_heads=8, d_ff=6400, vocab=32064, rope_theta=10000.0,
    n_experts=16, top_k=2, moe_dff=6400, tie_embeddings=False,
    dtype="bfloat16")

SMOKE = LMConfig(
    name="phi35-smoke", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
    d_ff=64, vocab=128, n_experts=8, top_k=2, moe_dff=64,
    tie_embeddings=False, dtype="float32",
    q_chunk=16, kv_chunk=16, ce_chunk=16)


def smoke_batch(cfg, rng: np.random.Generator, device="cpu"):
    toks = np.asarray(rng.integers(0, cfg.vocab, (2, 32)), np.int32)
    return {"tokens": torch.from_numpy(toks).to(device),
            "labels": torch.from_numpy(np.roll(toks, -1, 1)).to(device),
            "mask": torch.ones((2, 32), dtype=torch.float32, device=device)}


SPEC = ArchSpec(
    id="phi3.5-moe-42b-a6.6b", family="lm",
    source="hf:microsoft/Phi-3.5-MoE-instruct; hf",
    config=CONFIG, smoke_config=SMOKE,
    shapes=lm_shapes(n_micro={"train_4k": 4},
                     skip_long="pure full-attention arch: 500k decode cell "
                               "skipped"),
    optimizer="adamw", fsdp=True,
    inputs=lm_input_specs, smoke_batch=smoke_batch,
    notes="16 experts top-2; expert dim shards 1 expert/chip at model=16")
