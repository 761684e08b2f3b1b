"""arctic-480b [hf:Snowflake/snowflake-arctic-base; hf]: 35L d_model=7168
56H (GQA kv=8) d_ff=4864 vocab=32000, MoE 128 experts top-2 PLUS a dense
residual FFN in parallel (Arctic's dense-MoE hybrid).

Scale notes: ~480B params.  At 256 chips this trains only with
  * FSDP over 'data' for every weight (params bf16: 3.75 GB/chip),
  * expert parallelism over 'model' (8 experts/chip),
  * factored second-moment optimizer (adafactor) with bf16 first moment,
  * 16 microbatches (1 sequence/chip/microbatch) + full remat.
56 heads % 16 != 0: attention weights shard on the fused (H*Dh)=7168 dim.

long_500k skipped: pure full-attention arch."""
import numpy as np
import torch

from ..models.transformer import LMConfig
from .base import ArchSpec, lm_input_specs, lm_shapes

CONFIG = LMConfig(
    name="arctic-480b", n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=4864, vocab=32000, d_head=128, rope_theta=10000.0,
    n_experts=128, top_k=2, moe_dff=4864, dense_residual=True,
    dense_residual_dff=4864, tie_embeddings=False, dtype="bfloat16")

SMOKE = LMConfig(
    name="arctic-smoke", n_layers=2, d_model=32, n_heads=7, n_kv_heads=1,
    d_ff=48, vocab=128, d_head=8, n_experts=8, top_k=2, moe_dff=48,
    dense_residual=True, dense_residual_dff=48, tie_embeddings=False,
    dtype="float32", q_chunk=16, kv_chunk=16, ce_chunk=16)


def smoke_batch(cfg, rng: np.random.Generator, device="cpu"):
    toks = np.asarray(rng.integers(0, cfg.vocab, (2, 32)), np.int32)
    return {"tokens": torch.from_numpy(toks).to(device),
            "labels": torch.from_numpy(np.roll(toks, -1, 1)).to(device),
            "mask": torch.ones((2, 32), dtype=torch.float32, device=device)}


SPEC = ArchSpec(
    id="arctic-480b", family="lm",
    source="hf:Snowflake/snowflake-arctic-base; hf",
    config=CONFIG, smoke_config=SMOKE,
    shapes=lm_shapes(n_micro={"train_4k": 16},
                     skip_long="pure full-attention arch: 500k decode cell "
                               "skipped"),
    optimizer="adafactor", grad_accum_dtype="bfloat16", fsdp=True,
    inputs=lm_input_specs, smoke_batch=smoke_batch,
    notes="128e top-2 + dense residual; adafactor+bf16 accum for memory")
