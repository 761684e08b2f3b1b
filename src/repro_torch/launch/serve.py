"""Serving driver: ``python -m repro_torch.launch.serve --arch <id> [...]``.

LM archs: prefill a batch of prompts, then greedy-decode N tokens with the
KV cache (``flash_decode`` on the card).  RecSys archs: a batched scoring
loop (the ``serve_p99`` kind) with latency stats.  Runs the reduced smoke
config unless ``--full`` (the published config), on the GPU unless
``--device cpu``.  Weights are random, drawn from a seeded generator.
``--arch dynawarp`` (the log-store server) is not yet ported.
"""
from __future__ import annotations

import argparse
import sys
import time
from dataclasses import replace

import numpy as np

# (flag, type) of the log-store server's options
STORE_FLAGS = (("--store", str), ("--lines", int), ("--clients", int),
               ("--replicas", int), ("--max-live-waves", int),
               ("--flush-deadline-ms", float), ("--cost-model", str))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--decode-tokens", type=int, default=16)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: the GPU)")
    ap.add_argument("--full", action="store_true",
                    help="the published config instead of the smoke config")
    # the log-store server's knobs (--arch dynawarp), named as in the JAX
    # driver; that server is not yet ported, so setting one raises
    for flag, typ in STORE_FLAGS:
        ap.add_argument(flag, type=typ, default=argparse.SUPPRESS,
                        help="--arch dynawarp only (not yet ported)")
    args = ap.parse_args(argv)

    given = [f for f, _ in STORE_FLAGS
             if hasattr(args, f[2:].replace("-", "_"))]
    if args.arch in ("dynawarp", "copr") or given:
        raise NotImplementedError("the store server (--arch dynawarp"
                                  + "".join(", " + f for f in given)
                                  + ") is not yet ported")

    import torch

    from ..configs import get_arch
    from ..device import generator, resolve_device
    from .steps import family_init, serve_fn

    spec = get_arch(args.arch)
    dev = resolve_device(args.device)
    cfg = spec.config if args.full else spec.smoke_config
    params = family_init(spec, cfg_override=cfg)(generator(0, dev))
    rng = np.random.default_rng(0)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    if spec.family == "lm":
        from ..models.transformer import decode_step, init_cache, prefill
        b, s = args.batch, args.prompt_len
        prompts = torch.from_numpy(
            rng.integers(1, cfg.vocab, (b, s)).astype(np.int32)).to(dev)
        with torch.inference_mode():
            t0 = time.perf_counter()
            cache_pref, logits = prefill(cfg, params, prompts)
            cache = init_cache(cfg, b, s + args.decode_tokens, device=dev)
            cache["k"][:, :, :s] = cache_pref["k"]
            cache["v"][:, :, :s] = cache_pref["v"]
            del cache_pref
            tok = logits.argmax(-1).to(torch.int32)
            out_tokens = [tok]
            for i in range(args.decode_tokens - 1):
                cache, tok, _ = decode_step(cfg, params, cache, tok, s + i)
                out_tokens.append(tok)
            sync()
            dt = time.perf_counter() - t0
        gen = torch.stack(out_tokens, 1)
        print(f"[serve] {cfg.name} on {dev}: generated {tuple(gen.shape)} "
              f"tokens in {dt:.2f}s ({b * args.decode_tokens / dt:.1f} tok/s "
              f"incl. the first call)")
        print("[serve] sample:", gen[0][:8].cpu().numpy())
        return 0

    fn = serve_fn(replace(spec, config=cfg), spec.shapes["serve_p99"])
    lat = []
    with torch.inference_mode():
        for r in range(args.requests):
            batch = spec.smoke_batch(cfg, np.random.default_rng(r), dev)
            t0 = time.perf_counter()
            scores = fn(params, batch)
            sync()
            lat.append(time.perf_counter() - t0)
    lat_ms = np.asarray(lat[1:] or lat) * 1e3      # drop the first call
    print(f"[serve] {cfg.name} on {dev}: {args.requests} requests; p50 "
          f"{np.percentile(lat_ms, 50):.2f}ms p99 "
          f"{np.percentile(lat_ms, 99):.2f}ms scores {tuple(scores.shape)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
