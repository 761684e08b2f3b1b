"""Plain PyTorch version of the flash_decode kernel: the model's own decode
attention, with its sliding window and logit soft-cap."""
from __future__ import annotations

import torch


def flash_decode_ref(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len: int, *,
                     window: int | None = None,
                     softcap: float | None = None) -> torch.Tensor:
    """q (B, Hq, D), caches (B, S, Hkv, D) -> (B, Hq, D) in q's dtype."""
    from ...models.attention import decode_attention
    return decode_attention(q[:, None], k_cache, v_cache, cache_len,
                            window=window, attn_softcap=softcap)[:, 0]
