"""llama3-8b [arXiv:2407.21783; unverified]: 32L d_model=4096 32H (GQA kv=8)
d_ff=14336 vocab=128256 — RoPE theta 500000, SwiGLU, untied embeddings.

long_500k skipped: pure full-attention arch."""
import numpy as np
import torch

from ..models.transformer import LMConfig
from .base import ArchSpec, lm_input_specs, lm_shapes

CONFIG = LMConfig(
    name="llama3-8b", n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=128256, rope_theta=500000.0, tie_embeddings=False,
    dtype="bfloat16")

SMOKE = LMConfig(
    name="llama3-smoke", n_layers=3, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=160, vocab=384, rope_theta=500000.0, tie_embeddings=False,
    dtype="float32", q_chunk=16, kv_chunk=16, ce_chunk=16)


def smoke_batch(cfg, rng: np.random.Generator, device="cpu"):
    toks = np.asarray(rng.integers(0, cfg.vocab, (2, 32)), np.int32)
    return {"tokens": torch.from_numpy(toks).to(device),
            "labels": torch.from_numpy(np.roll(toks, -1, 1)).to(device),
            "mask": torch.ones((2, 32), dtype=torch.float32, device=device)}


SPEC = ArchSpec(
    id="llama3-8b", family="lm", source="arXiv:2407.21783; unverified",
    config=CONFIG, smoke_config=SMOKE,
    shapes=lm_shapes(n_micro={"train_4k": 4},
                     skip_long="pure full-attention arch: 500k decode cell "
                               "skipped"),
    optimizer="adamw", fsdp=True, inputs=lm_input_specs,
    smoke_batch=smoke_batch,
    notes="GQA kv=8, 128k vocab")
