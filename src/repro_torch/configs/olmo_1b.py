"""olmo-1b [arXiv:2402.00838; hf]: 16L d_model=2048 16H (MHA, kv=16)
d_ff=8192 vocab=50304 — non-parametric LayerNorm, tied embeddings.

long_500k skipped: pure full-attention arch."""
import numpy as np
import torch

from ..models.transformer import LMConfig
from .base import ArchSpec, lm_input_specs, lm_shapes

CONFIG = LMConfig(
    name="olmo-1b", n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=8192, vocab=50304, rope_theta=10000.0, norm="nonparam",
    tie_embeddings=True, dtype="bfloat16")

SMOKE = LMConfig(
    name="olmo-smoke", n_layers=3, d_model=48, n_heads=4, n_kv_heads=4,
    d_ff=96, vocab=256, norm="nonparam", tie_embeddings=True,
    dtype="float32", q_chunk=16, kv_chunk=16, ce_chunk=16)


def smoke_batch(cfg, rng: np.random.Generator, device="cpu"):
    toks = np.asarray(rng.integers(0, cfg.vocab, (2, 32)), np.int32)
    return {"tokens": torch.from_numpy(toks).to(device),
            "labels": torch.from_numpy(np.roll(toks, -1, 1)).to(device),
            "mask": torch.ones((2, 32), dtype=torch.float32, device=device)}


SPEC = ArchSpec(
    id="olmo-1b", family="lm", source="arXiv:2402.00838; hf",
    config=CONFIG, smoke_config=SMOKE,
    shapes=lm_shapes(n_micro={"train_4k": 1},
                     skip_long="pure full-attention arch: 500k decode cell "
                               "skipped"),
    optimizer="adamw", fsdp=False,
    inputs=lm_input_specs, smoke_batch=smoke_batch,
    notes="non-parametric LN; MHA (kv=16) shards cleanly over model=16")
