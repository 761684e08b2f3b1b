"""Serving driver: ``python -m repro_torch.launch.serve --arch <id> [...]``.

``--arch dynawarp`` (alias ``copr``) runs the log-store serving loop:
a :class:`~repro_torch.core.serving.StoreServer` wave scheduler over a
store (freshly built, or ``--store <dir>`` to open a durable one),
driven by a pool of concurrent clients; prints q/s, p50/p99 latency,
and wave coalescing stats.  Knobs: ``--clients``, ``--requests`` (per
client), ``--replicas``, ``--max-live-waves``, ``--flush-deadline-ms``,
``--cost-model <json>`` (from ``core.serving.measure_dispatch_costs``).

LM archs (llama3-8b, gemma2-9b, olmo-1b, phi3.5-moe-42b-a6.6b,
arctic-480b): prefill a batch of prompts, then greedy-decode N tokens with
the KV cache (``flash_decode`` on the card, with gemma2's sliding window
and soft-cap).  ``--full`` on one 80 GB card fits llama3-8b (17 GB of
bf16 weights), gemma2-9b (18.5 GB) and olmo-1b (2.4 GB); phi3.5-moe (84 GB)
and arctic-480b (~960 GB) do not.  RecSys archs (xdeepfm,
two-tower-retrieval, sasrec, mind): a batched scoring loop (the
``serve_p99`` kind) with latency stats; SASRec and MIND score 32
candidates a request.  meshgraphnet has no serve shape and is refused, as
in the JAX package.  Runs the reduced smoke
config unless ``--full`` (the published config), on the GPU unless
``--device cpu``.  Weights are random, drawn from a seeded generator.
"""
from __future__ import annotations

import argparse
import sys
import time
from dataclasses import replace

import numpy as np

# (flag, type, default) of the log-store server's options (--arch dynawarp)
STORE_FLAGS = (("--store", str, None), ("--lines", int, 6_000),
               ("--clients", int, 8), ("--replicas", int, 2),
               ("--max-live-waves", int, 2),
               ("--flush-deadline-ms", float, 2.0),
               ("--cost-model", str, None))


def _serve_dynawarp(args) -> int:
    import threading

    from ..core.serving import CostModel
    from ..logstore.datasets import (generate_dataset, id_queries,
                                     present_id_queries)
    from ..logstore.store import DynaWarpStore

    if args.store:
        store = DynaWarpStore.open(args.store, device=args.device)
        print(f"[serve] opened store {args.store}: "
              f"{store.n_batches} batches, "
              f"{len(store.segments)} segments on {store.device}", flush=True)
        terms = id_queries(5, 16)       # contents unknown: generic probes
    else:
        ds = generate_dataset("serve", n_lines=args.lines, n_sources=24,
                              seed=11)
        store = DynaWarpStore(batch_lines=64, mode="segmented",
                              memory_limit_bytes=1 << 15, device=args.device)
        store.ingest(ds.lines)
        store.finish()
        print(f"[serve] built store: {store.n_batches} batches, "
              f"{len(store.segments)} segments on {store.device}", flush=True)
        terms = present_id_queries(ds, 5, 16)

    cost_model = None
    if args.cost_model:
        cost_model = CostModel.load(args.cost_model)
        print(f"[serve] cost model {args.cost_model}: "
              f"host {cost_model.host_us_per_query:.0f} us/query",
              flush=True)

    server = store.serving(n_replicas=args.replicas,
                           max_live_waves=args.max_live_waves,
                           flush_deadline_s=args.flush_deadline_ms / 1e3,
                           cost_model=cost_model)
    lat: list[list[float]] = [[] for _ in range(args.clients)]

    def client(ci: int) -> None:
        rng = np.random.default_rng(ci)
        for _ in range(args.requests):
            term = terms[int(rng.integers(len(terms)))]
            t0 = time.perf_counter()
            server.query_term(term, timeout=120)
            lat[ci].append(time.perf_counter() - t0)

    try:
        server.query_term(terms[0], timeout=300)      # warm-up
        threads = [threading.Thread(target=client, args=(ci,), daemon=True)
                   for ci in range(args.clients)]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        dt = time.perf_counter() - t0
    finally:
        server.close()
        store.close()

    lat_ms = np.asarray([x for per in lat for x in per]) * 1e3
    n = len(lat_ms)
    if n < args.clients * args.requests:
        raise RuntimeError(f"{n} of {args.clients * args.requests} queries "
                           "answered")
    st = server.scheduler.stats()
    print(f"[serve] {n} queries from {args.clients} clients in {dt:.2f}s "
          f"({n / dt:.1f} q/s)  p50 {np.percentile(lat_ms, 50):.2f}ms  "
          f"p99 {np.percentile(lat_ms, 99):.2f}ms", flush=True)
    print(f"[serve] {st.waves} waves ({st.host_waves} host / "
          f"{st.device_waves} device; {st.size_flushes} size / "
          f"{st.deadline_flushes} deadline flushes), max wave "
          f"{st.max_wave}, replicas used: "
          f"{sorted(st.replica_waves)}", flush=True)
    return 0


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
    # the log-store server's knobs (--arch dynawarp), named and defaulted
    # as in the JAX package's serve.py; an LM or recsys arch refuses them
    for flag, typ, default in STORE_FLAGS:
        ap.add_argument(flag, type=typ, default=argparse.SUPPRESS,
                        help=f"--arch dynawarp only (default {default})")
    args = ap.parse_args(argv)

    given = [f for f, _, _ in STORE_FLAGS
             if hasattr(args, f[2:].replace("-", "_"))]
    if args.arch in ("dynawarp", "copr"):
        for flag, _, default in STORE_FLAGS:
            name = flag[2:].replace("-", "_")
            setattr(args, name, getattr(args, name, default))
        if args.requests == 8:          # store default differs from LM
            args.requests = 25
        return _serve_dynawarp(args)
    if given:
        raise ValueError(", ".join(given) + " apply to --arch dynawarp "
                         "only")

    import torch

    from ..configs import get_arch
    from ..device import generator, resolve_device
    from .steps import family_init, serve_fn

    spec = get_arch(args.arch)
    if spec.family != "lm" and "serve_p99" not in spec.shapes:
        raise ValueError(f"{spec.id} has no serve shape ('serve_p99'); its "
                         f"shapes are {sorted(spec.shapes)}")
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
            if spec.id in ("sasrec", "mind"):     # 32 candidates a request
                b = batch["seq"].shape[0]
                batch["cand"] = torch.from_numpy(np.random.default_rng(
                    r).integers(1, cfg.n_items, (b, 32)).astype(np.int32)
                ).to(dev)
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
