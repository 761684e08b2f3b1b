"""Sharded multi-segment retrieval: per-spill immutable segments (the
Grail layout) assigned to shards and probed through the
ShardedQueryEngine — one fused probe launch a segment on its shard's
device, the shards' partial bitmaps OR-ed before the wave's one fold and
one extraction, bit-identical to the single-device engine.

    PYTHONPATH=src python -m repro_torch.examples.distributed_query \\
        [--device cpu] [--shards 8] [--n-lines N]

Without ``--shards`` the store's own engine (``shard_axes=("data",)``)
spreads over every visible device of the store's type.  ``--shards N``
lays N logical shards on the one device instead, the counterpart of the
JAX package's run on a forced 8-device host mesh.
"""
import argparse
import sys
import time
from collections import Counter

import numpy as np

from repro_torch.core.distributed import ShardedQueryEngine
from repro_torch.core.query_engine import QueryEngine
from repro_torch.core.tokenizer import term_query_tokens
from repro_torch.logstore.datasets import generate_dataset, present_id_queries
from repro_torch.logstore.store import DynaWarpStore


def _engine(store, shards):
    if shards is None:
        return store.engine
    return ShardedQueryEngine(store.segments, n_postings=store.n_batches,
                              devices=[store.device] * shards)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    ap.add_argument("--n-lines", type=int, default=20000)
    ap.add_argument("--shards", type=int, default=None,
                    help="logical shards on the one device (default: one "
                         "shard per visible device, through the store)")
    args = ap.parse_args(argv)

    ds = generate_dataset("sharded", n_lines=args.n_lines, n_sources=32,
                          seed=5)
    # with --shards the store keeps the plain engine, so that only the
    # example's N-shard engine places the segments
    store = DynaWarpStore(batch_lines=128, mode="segmented",
                          memory_limit_bytes=1 << 16, compact_fanout=16,
                          auto_compact=False,
                          shard_axes=None if args.shards else ("data",),
                          device=args.device)
    store.ingest(ds.lines)
    store.finish()
    eng = _engine(store, args.shards)
    per_shard = Counter(eng.slots)
    print(f"{len(store.segments)} segments over {eng.n_shards} shard(s) on "
          f"{sorted({str(d) for d in eng.devices})}: segments per shard "
          f"{[per_shard[k] for k in range(eng.n_shards)]}")

    wave = present_id_queries(ds, 7, 16) * 40       # 640 term queries
    token_lists = [term_query_tokens(t) for t in wave]
    single = QueryEngine(store.segments, n_postings=store.n_batches,
                         device=store.device)
    res_sharded = eng.query_batch(token_lists)      # stages every segment
    res_single = single.query_batch(token_lists)

    t0 = time.perf_counter()
    eng.query_batch(token_lists)
    t_shard = time.perf_counter() - t0
    print(f"sharded wave   : {len(wave) / t_shard:10.0f} q/s "
          f"({eng.upload_count} uploads in all: each segment once)")
    t0 = time.perf_counter()
    single.query_batch(token_lists)
    t_single = time.perf_counter() - t0
    print(f"single engine  : {len(wave) / t_single:10.0f} q/s")

    same = all(np.array_equal(a, b) for a, b in zip(res_sharded, res_single))
    print(f"sharded candidates bit-identical to the single-device engine: "
          f"{same}")

    # compaction keeps the sharding: unchanged segments keep their shards
    # and their buffers, merged segments upload once
    placed = [(seg, slot) for (_, seg), slot in zip(eng._plane_segs,
                                                    eng.slots)]
    merges = store.compact(fanout=2)
    eng = _engine(store, args.shards)
    after = eng.query_batch(token_lists)
    kept = all(slot == was
               for (_, seg), slot in zip(eng._plane_segs, eng.slots)
               for old, was in placed if old is seg)
    same_after = all(np.array_equal(a, eng.host_query(t))
                     for a, t in zip(after[:16], token_lists[:16]))
    print(f"compacted ({merges} merges) into {len(store.segments)} "
          f"segments: engine rebuilt over {eng.n_shards} shard(s), "
          f"{eng.upload_count} new uploads (merged segments only), "
          f"surviving segments kept their shards: {kept}, wave equal to "
          f"the host path: {same_after}")
    return 0 if same and kept and same_after else 1


if __name__ == "__main__":
    sys.exit(main())
