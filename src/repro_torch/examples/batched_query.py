"""Batched device query engine demo: a wave of term queries answered in
one device dispatch per segment, vs the paper's sequential host loop —
plus the segmented (no-merge) ingest mode fanning the same wave out
across per-spill immutable segments.

    PYTHONPATH=src python -m repro_torch.examples.batched_query [--device cpu]
"""
import argparse
import sys
import time

from repro_torch.core.query import query_and
from repro_torch.core.tokenizer import term_query_tokens
from repro_torch.logstore.datasets import generate_dataset, present_id_queries
from repro_torch.logstore.store import DynaWarpStore


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    ap.add_argument("--n-lines", type=int, default=20000)
    ap.add_argument("--repeat", type=int, default=40,
                    help="the wave is 16 present ids, this many times")
    args = ap.parse_args(argv)

    ds = generate_dataset("wave", n_lines=args.n_lines, n_sources=32, seed=5)

    store = DynaWarpStore(batch_lines=128, device=args.device)  # monolithic
    store.ingest(ds.lines)
    store.finish()

    wave = present_id_queries(ds, 7, 16) * args.repeat
    token_lists = [term_query_tokens(t) for t in wave]

    store.engine.query_batch(token_lists)           # warm the kernels
    t0 = time.perf_counter()
    batched = store.engine.query_batch(token_lists)
    t_engine = time.perf_counter() - t0

    t0 = time.perf_counter()
    looped = [query_and(store.sketch, toks) for toks in token_lists]
    t_host = time.perf_counter() - t0

    assert all((a == b).all() for a, b in zip(batched, looped))
    print(f"wave of {len(wave)} term queries")
    print(f"  host loop : {len(wave)/t_host:10.0f} q/s")
    print(f"  engine    : {len(wave)/t_engine:10.0f} q/s "
          f"({t_host/t_engine:.1f}x, bit-identical candidates)")

    # segmented mode: per-spill segments stay queryable, no merge at finish()
    seg_store = DynaWarpStore(batch_lines=128, mode="segmented",
                              memory_limit_bytes=1 << 19, device=args.device)
    seg_store.ingest(ds.lines)
    seg_store.finish()
    print(f"\nsegmented store: {len(seg_store.segments)} segments, "
          f"{seg_store.stats.index_bytes/1e3:.0f} KB index")
    for term in wave[:3]:
        a = sorted(store.query_term(term).matches)
        b = sorted(seg_store.query_term(term).matches)
        assert a == b
        print(f"  {term!r}: {len(a)} matches from both stores")
    return 0


if __name__ == "__main__":
    sys.exit(main())
