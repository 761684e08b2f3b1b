"""Quickstart: ingest logs, seal the segment, run term/contains queries,
then make the store durable — save to disk, reopen, query again —
survive a crash mid-ingest (open() the unfinished store, resume
appending, finish()), and finally serve the store to concurrent clients
through the wave-coalescing front end (serving()).

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
import argparse
import os
import sys
import tempfile
import threading

from repro_torch.logstore.datasets import generate_dataset
from repro_torch.logstore.store import DynaWarpStore


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    ap.add_argument("--n-lines", type=int, default=5000)
    args = ap.parse_args(argv)
    dev = args.device

    # 1. generate a LogHub-style synthetic dataset (the paper's generator)
    ds = generate_dataset("quickstart", n_lines=args.n_lines, n_sources=16,
                          seed=0)

    # 2. ingest into a DynaWarp-indexed log store (128-line zstd batches)
    store = DynaWarpStore(batch_lines=128, device=dev)
    store.ingest(ds.lines)
    store.finish()
    print(f"ingested {ds.n_lines} lines -> {store.n_batches} batches, "
          f"index {store.stats.index_bytes/1e3:.1f} KB "
          f"({100*store.stats.index_bytes/max(store.stats.data_bytes,1):.1f}% "
          f"of compressed data)")

    # 3. term query (needle-in-the-haystack)
    r = store.query_term("alice")
    print(f"term 'alice': {len(r.matches)} lines from "
          f"{len(r.candidate_batches)}/{r.batches_total} candidate batches "
          f"(error rate {r.error_rate:.2e})")

    # 4. contains query across token borders (n-gram powered)
    r = store.query_contains("jndi")   # Log4Shell-style pattern
    print(f"contains 'jndi': {len(r.matches)} lines")

    # 5. a term that does not exist: the sketch answers from ~1 KB of reads
    r = store.query_term("zzzzunknownzzzz")
    print(f"absent term: {len(r.candidate_batches)} candidate batches "
          f"(decompressed nothing)")

    # 6. durable store: pass path=... and the compressed batches stream to
    # an on-disk blob file while sealed segments publish as flat files
    # under an atomically-swapped MANIFEST.json (§4.2 fault tolerance)
    alice = store.query_term("alice").matches
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "logstore")
        durable = DynaWarpStore(batch_lines=128, mode="segmented", path=path,
                                device=dev)
        durable.ingest(ds.lines)
        durable.finish()
        durable.close()
        print(f"saved durable store: {sorted(os.listdir(path))}")

        # 7. reopen and query — segments are served straight from np.memmap
        # (only header pages are read up front) and answers are
        # bit-identical to the in-RAM store above
        reopened = DynaWarpStore.open(path, device=dev)
        r = reopened.query_term("alice")
        print(f"reopened term 'alice': {len(r.matches)} lines from "
              f"{len(reopened.segments)} memmapped segments (matches "
              f"in-RAM store: {r.matches == alice})")
        r = reopened.query_contains("jndi")
        print(f"reopened contains 'jndi': {len(r.matches)} lines")
        reopened.close()

    # 8. crash-safe live ingest: a durable segmented store publishes its
    # manifest at EVERY spill, so a writer that dies mid-ingest loses at
    # most the lines since the last spill.  open() of the unfinished
    # directory rehydrates the writer: resume-append, then an idempotent
    # finish().
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "live")
        writer = DynaWarpStore(batch_lines=128, mode="segmented", path=path,
                               memory_limit_bytes=1 << 16, device=dev)
        writer.ingest(ds.lines[:ds.n_lines * 3 // 5])
        writer.blobs.close()               # simulate the process dying here
        del writer

        resumed = DynaWarpStore.open(path, device=dev)  # reads MANIFEST.json
        recovered = resumed._n_lines
        print(f"crashed mid-ingest; recovered {recovered} lines "
              f"(finished={resumed._finished})")
        resumed.ingest(ds.lines[recovered:])        # reopen-for-append
        resumed.finish()
        r = resumed.query_term("alice")
        print(f"resumed + finished: term 'alice' matches in-RAM store: "
              f"{r.matches == alice}")
        resumed.close()

    # 9. serve it: store.serving() puts a wave-coalescing scheduler in
    # front of the engine — concurrent clients' queries group into
    # shape-bucketed waves (deadline- or size-flushed, max_live_waves
    # admission control), and a cost model picks the host or device path
    # per wave.  core.serving.measure_dispatch_costs measures one on the
    # card; pass cost_model=CostModel.load(path) to use it.
    seg_store = DynaWarpStore(batch_lines=128, mode="segmented",
                              memory_limit_bytes=1 << 16, device=dev)
    seg_store.ingest(ds.lines)
    seg_store.finish()
    hits: list[int] = []
    with seg_store.serving(n_replicas=2, flush_deadline_s=0.005) as server:
        def client():
            for term in ("alice", "jndi", "error"):
                hits.append(len(server.query_term(term, timeout=60).matches))

        clients = [threading.Thread(target=client) for _ in range(8)]
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=120)
    st = server.scheduler.stats()
    print(f"served {st.completed} queries from {len(clients)} clients in "
          f"{st.waves} coalesced waves ({st.host_waves} host / "
          f"{st.device_waves} device, max wave {st.max_wave}), answers "
          f"match direct queries: {hits.count(len(alice)) >= 8}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
