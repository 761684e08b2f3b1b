"""Live tail ingest: stream lines into a durable store with per-spill
manifest publishes, while a standing query runs on a cadence against
point-in-time snapshots (logservatory-style).

    PYTHONPATH=src python -m repro_torch.examples.tail_ingest [--device cpu]
    tail -f app.log | PYTHONPATH=src python -m repro_torch.examples.tail_ingest --stdin

Every spill atomically swaps MANIFEST.json, so killing this process at
any moment loses at most the lines since the last spill —
``DynaWarpStore.open()`` on the same directory resumes where the last
publish left off (see ``repro_torch.examples.quickstart`` step 8).  The
standing query never blocks the writer: ``snapshot()`` captures the
published prefix under the swap lock and serves exact results over it.
"""
import argparse
import os
import sys
import tempfile
import time

from repro_torch.logstore.store import DynaWarpStore


def demo_stream(n_lines=20_000, chunk=256):
    """A synthetic `tail -f`: the paper's generator, drained in chunks."""
    from repro_torch.logstore.datasets import generate_dataset
    ds = generate_dataset("tail", n_lines=n_lines, n_sources=24, seed=3)
    for i in range(0, len(ds.lines), chunk):
        yield ds.lines[i:i + chunk]


def stdin_stream(chunk=256):
    buf = []
    for line in sys.stdin:
        buf.append(line.rstrip("\n"))
        if len(buf) >= chunk:
            yield buf
            buf = []
    if buf:
        yield buf


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--stdin", action="store_true",
                    help="read the line stream from stdin (e.g. tail -f)")
    ap.add_argument("--query", default="error",
                    help="standing term query (default: 'error')")
    ap.add_argument("--every", type=float, default=0.5,
                    help="standing-query cadence in seconds")
    ap.add_argument("--path", default=None,
                    help="store directory (default: a temp dir)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    ap.add_argument("--n-lines", type=int, default=20_000,
                    help="lines of the demo stream")
    args = ap.parse_args(argv)

    path = args.path or os.path.join(tempfile.mkdtemp(), "tailstore")
    store = DynaWarpStore(batch_lines=128, mode="segmented", path=path,
                          memory_limit_bytes=1 << 16, auto_compact=False,
                          device=args.device)
    print(f"[tail] durable store at {path} (manifest swaps per spill)")

    stream = stdin_stream() if args.stdin else demo_stream(args.n_lines)
    seen = 0                     # matches already reported
    last_check = time.monotonic()
    for chunk in stream:
        store.ingest(chunk)
        now = time.monotonic()
        if now - last_check < args.every and not args.stdin:
            # the demo stream arrives faster than wall-clock cadence;
            # still check periodically by ingested volume
            if store._n_lines % 2048 >= 256:
                continue
        last_check = now
        snap = store.snapshot()              # point-in-time, non-blocking
        r = snap.query_term(args.query)
        fresh = len(r.matches) - seen
        print(f"[tail] {store._n_lines:>7} lines in "
              f"({snap.n_lines} published, gen {store._manifest_gen}) | "
              f"standing query {args.query!r}: {len(r.matches)} matches"
              + (f" (+{fresh} new)" if fresh else ""))
        seen = len(r.matches)

    store.finish()
    r = store.query_term(args.query)
    print(f"[tail] stream ended: finished store holds {store._n_lines} "
          f"lines, {store.n_batches} batches, {len(store.segments)} "
          f"segments; {args.query!r} matched {len(r.matches)} lines")
    store.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
