"""gemma2-9b [arXiv:2408.00118; hf]: 42L d_model=3584 16H (GQA kv=8)
d_ff=14336 vocab=256000 — local(4096)+global alternating attention,
attn-logit softcap 50, final-logit softcap 30, sandwich norms, tied
embeddings, head_dim 256.

long_500k: gemma2 alternates local sliding-window layers with global
layers; its local half is sub-quadratic, and decode with a KV cache is
O(S)/step, so the 524288-token decode cell IS run (cache sequence-sharded
over data x model — context parallelism)."""
import numpy as np
import torch

from ..models.transformer import LMConfig
from .base import ArchSpec, lm_input_specs, lm_shapes

CONFIG = LMConfig(
    name="gemma2-9b", n_layers=42, d_model=3584, n_heads=16, n_kv_heads=8,
    d_ff=14336, vocab=256000, d_head=256, rope_theta=10000.0,
    attn_softcap=50.0, final_softcap=30.0, sliding_window=4096,
    local_global_period=2, post_norm=True, tie_embeddings=True,
    embed_scale=True, norm="rms", dtype="bfloat16")

SMOKE = LMConfig(
    name="gemma2-smoke", n_layers=4, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab=512, d_head=16, attn_softcap=50.0, final_softcap=30.0,
    sliding_window=8, local_global_period=2, post_norm=True,
    tie_embeddings=True, embed_scale=True, dtype="float32",
    q_chunk=16, kv_chunk=16, ce_chunk=16)


def smoke_batch(cfg, rng: np.random.Generator, device="cpu"):
    toks = np.asarray(rng.integers(0, cfg.vocab, (2, 32)), np.int32)
    return {"tokens": torch.from_numpy(toks).to(device),
            "labels": torch.from_numpy(np.roll(toks, -1, 1)).to(device),
            "mask": torch.ones((2, 32), dtype=torch.float32, device=device)}


SPEC = ArchSpec(
    id="gemma2-9b", family="lm", source="arXiv:2408.00118; hf",
    config=CONFIG, smoke_config=SMOKE,
    shapes=lm_shapes(n_micro={"train_4k": 4}),
    optimizer="adamw", fsdp=True,
    inputs=lm_input_specs, smoke_batch=smoke_batch,
    notes="local+global alternating, logit softcap; long_500k RUN "
          "(hybrid local/global; decode is O(S)/step with seq-sharded KV)")
