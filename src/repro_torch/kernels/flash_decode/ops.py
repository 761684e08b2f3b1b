"""Wrapper of the flash_decode kernel: one-token GQA attention against a KV
cache, split over the cache (FlashDecoding) and merged by a second pass,
with an optional sliding window (a shorter range of the cache) and logit
soft-capping."""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import build
from .ref import flash_decode_ref

TILE = 64               # cache positions per shared-memory tile (the .cu's kTile)
MAX_D, MAX_ROWS_X_D = 256, 1024


@functools.cache
def _kernel():
    lib = build.library("flash_decode")
    p, i = ctypes.c_void_p, ctypes.c_int
    f = ctypes.c_float
    return lib, build.declare(lib, "flash_decode_launch", p, p, p, i, i, i, i,
                              i, i, i, i, i, i, f, f, p, p, p, p, p)


@functools.cache
def _blocks_per_sm(bf16: int, n_rep: int, d: int, cap: int,
                   index: int) -> int:
    lib = build.library("flash_decode")
    fn = build.declare(lib, "flash_decode_blocks_per_sm", ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.POINTER(ctypes.c_int))
    out = ctypes.c_int(0)
    with torch.cuda.device(index):
        err = fn(bf16, n_rep, d, cap, ctypes.byref(out))
    build.check(lib, err, "flash_decode occupancy")
    return out.value


def blocks_per_sm(n_rep: int, d: int, dtype: torch.dtype,
                  device: torch.device, capped: bool = False) -> int:
    """Split blocks that one SM of ``device`` holds at once for (n_rep, D)
    in ``dtype``, with or without a soft-cap, as the CUDA runtime computes
    it (the bf16 kernel's shared-memory ring sets it: 2 at D = 128, 1 at
    D = 256)."""
    device = torch.device(device)
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    return _blocks_per_sm(int(dtype == torch.bfloat16), n_rep, d,
                          int(capped), index)


def window_start(cache_len: int, window: int | None) -> int:
    """The first position a query at ``cache_len`` reads: 0, or
    ``cache_len - window`` under a sliding window shorter than the cache."""
    return 0 if window is None else max(0, cache_len - int(window))


def split_plan(b: int, hkv: int, cache_len: int, sms: int, per_sm: int
               ) -> tuple[int, int]:
    """(chunk, n_splits): ``cache_len`` positions (the window's, from its
    first position: ``window_start``) cut into n_splits
    non-empty ranges of ``chunk`` positions (a multiple of the tile).  One
    wave is ``sms * per_sm`` blocks; the B * Hkv * n_splits blocks fill at
    least 90% of a wave, and their last wave at least 90% (the fewest
    splits that do); where the cache has too few tiles for that, they come
    as close as they can."""
    tiles = -(-cache_len // TILE)
    wave, rows = sms * max(1, per_sm), b * hkv

    def plan(want):
        chunk = -(-(-(-cache_len // want)) // TILE) * TILE
        return chunk, -(-cache_len // chunk)

    def last_wave(n):
        return rows * n % wave or wave

    least = -(-9 * wave // (10 * rows))
    if least >= tiles:
        return plan(tiles)
    best = plan(least)
    for want in range(least, min(tiles, least + wave) + 1):
        got = plan(want)
        if 10 * last_wave(got[1]) >= 9 * wave:
            return got
        if last_wave(got[1]) > last_wave(best[1]):
            best = got
    return best


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, cache_len: int, *,
                 window: int | None = None,
                 softcap: float | None = None) -> torch.Tensor:
    """q (B, Hq, D); k_cache, v_cache (B, S, Hkv, D); ``cache_len`` (an int,
    1 <= cache_len <= S) valid positions -> (B, Hq, D) attention output in
    q's dtype (float32 or bfloat16), accumulated in float32.  Query head h
    reads kv head h // (Hq // Hkv).  A ``window`` (>= 1) keeps only the
    trailing ``window`` positions; a ``softcap`` (> 0) caps each score s =
    dot * D^-0.5 to softcap * tanh(s / softcap) before the softmax.  A
    CUDA tensor launches the kernel; a CPU tensor takes the plain
    version."""
    if q.dim() != 3 or k_cache.dim() != 4 or v_cache.shape != k_cache.shape:
        raise ValueError("q must be (B, Hq, D) and both caches (B, S, Hkv, D)")
    b, hq, d = q.shape
    _, s, hkv, _ = k_cache.shape
    if (k_cache.shape[0] != b or k_cache.shape[3] != d or hq % hkv
            or len({q.dtype, k_cache.dtype, v_cache.dtype}) != 1
            or q.dtype not in (torch.float32, torch.bfloat16)
            or len({q.device, k_cache.device, v_cache.device}) != 1):
        raise ValueError(f"flash_decode shapes q {tuple(q.shape)}, caches "
                         f"{tuple(k_cache.shape)} or dtypes/devices disagree")
    cache_len = int(cache_len)
    if not 1 <= cache_len <= s:
        raise ValueError(f"cache_len must lie in [1, {s}], not {cache_len}")
    if window is not None and int(window) < 1:
        raise ValueError(f"window must be None or >= 1, not {window}")
    if softcap is not None and not float(softcap) > 0:
        raise ValueError(f"softcap must be None or > 0, not {softcap}")
    if q.device.type == "cpu":
        return flash_decode_ref(q, k_cache, v_cache, cache_len,
                                window=window, softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode runs on cuda or cpu, not {q.device}")
    n_rep = hq // hkv
    if d % 8 or d > MAX_D or n_rep * d > MAX_ROWS_X_D or b * hkv > 65_535:
        raise ValueError(f"flash_decode takes D % 8 == 0, D <= {MAX_D}, "
                         f"n_rep * D <= {MAX_ROWS_X_D} and B * Hkv <= 65535; "
                         f"got D={d}, n_rep={n_rep}, B * Hkv={b * hkv}")
    q, k_cache, v_cache = (t.contiguous() for t in (q, k_cache, v_cache))
    if any(t.data_ptr() % 16 for t in (q, k_cache, v_cache)):
        raise ValueError("flash_decode needs 16-byte-aligned tensors")
    lo = window_start(cache_len, window)
    cap = 0.0 if softcap is None else float(softcap)
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    chunk, n_splits = split_plan(
        b, hkv, cache_len - lo, sms,
        blocks_per_sm(n_rep, d, q.dtype, q.device, cap > 0))
    f32 = dict(dtype=torch.float32, device=q.device)
    m = torch.empty(b * hq * n_splits, **f32)
    l = torch.empty(b * hq * n_splits, **f32)
    acc = torch.empty(b * hq * n_splits * d, **f32)
    out = torch.empty_like(q)
    lib, fn = _kernel()
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                 int(q.dtype == torch.bfloat16), b, s, hkv, n_rep, d, lo,
                 cache_len, chunk, n_splits, float(d) ** -0.5, cap,
                 m.data_ptr(), l.data_ptr(), acc.data_ptr(), out.data_ptr(),
                 build.stream_of(q))
    build.check(lib, err, "flash_decode")
    build.count_launch(flash_decode)
    return out


flash_decode.launch_count = 0
