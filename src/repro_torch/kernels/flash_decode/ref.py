"""Plain PyTorch version of the flash_decode kernel: the model's own decode
attention (no window, no softcap)."""
from __future__ import annotations

import torch


def flash_decode_ref(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len: int) -> torch.Tensor:
    """q (B, Hq, D), caches (B, S, Hkv, D) -> (B, Hq, D) in q's dtype."""
    from ...models.attention import decode_attention
    return decode_attention(q[:, None], k_cache, v_cache, cache_len)[:, 0]
