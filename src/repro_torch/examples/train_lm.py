"""Train a reduced LM config end to end with checkpoint and resume: the
training loop (``launch/train.py``) plus the DynaWarp-backed data
filter, which selects training batches by sketch membership queries
instead of decompress-and-grep.

    PYTHONPATH=src python -m repro_torch.examples.train_lm [--device cpu]

A 4,000-line store, the batches whose sketch holds "error", a
deterministic token stream over them; then olmo-1b's smoke config for 30
steps with a checkpoint every 10, and a resume to 40 (a preemption and a
restart).  The checkpoints go to a fresh directory under ``build/``
(``--ckpt-dir`` names another), removed at the end.
"""
import argparse
import shutil
import sys
import tempfile

from repro_torch.data import LMTokenPipeline, SketchFilteredCorpus
from repro_torch.launch import train
from repro_torch.logstore.datasets import generate_dataset
from repro_torch.logstore.store import DynaWarpStore


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the GPU)")
    ap.add_argument("--ckpt-dir", default=None)
    args = ap.parse_args(argv)

    ds = generate_dataset("corpus", n_lines=4000, n_sources=8, seed=1)
    store = DynaWarpStore(batch_lines=128, device=args.device)
    store.ingest(ds.lines)
    store.finish()
    # train only on the batches that mention errors (a sketch probe, no scan)
    corpus = SketchFilteredCorpus(store, include_terms=("error",))
    print(f"[pipeline] sketch selected {len(corpus.selected_batches())}/"
          f"{store.n_batches} training batches containing 'error'")
    pipe = LMTokenPipeline(corpus.lines(), vocab=256, batch=2, seq=32, seed=0)
    b0 = pipe.batch_at(0)
    print(f"[pipeline] deterministic batch stream ready: tokens "
          f"{b0['tokens'].shape} (batch_at(t) is pure in (seed, t): an "
          f"exact resume after preemption)")

    if args.ckpt_dir is None:
        train.DEFAULT_CKPT_DIR.parent.mkdir(parents=True, exist_ok=True)
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(
        prefix="train_lm-", dir=train.DEFAULT_CKPT_DIR.parent)
    common = ["--arch", "olmo-1b", "--ckpt-dir", ckpt_dir, "--device",
              args.device]
    try:
        rc = train.main(common + ["--steps", "30", "--ckpt-every", "10"])
        if rc == 0:   # a preemption, then a resume
            rc = train.main(common + ["--steps", "40", "--resume"])
    finally:
        if args.ckpt_dir is None:
            shutil.rmtree(ckpt_dir, ignore_errors=True)
    if rc == 0:
        print("[train_lm] resume after a checkpoint exercised OK")
    return rc


if __name__ == "__main__":
    sys.exit(main())
