"""Batched LM serving: prefill a prompt batch, greedy-decode with the KV
cache, through ``launch/serve.py``'s ``prefill`` / ``decode_step``
(gemma2-9b's smoke config: local and global layers, soft-capping,
sandwich norms; ``flash_decode`` on the card).

    PYTHONPATH=src python -m repro_torch.examples.serve_lm [--device cpu]
"""
import argparse
import sys

from repro_torch.launch import serve


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)
    return serve.main(["--arch", "gemma2-9b", "--batch", "4", "--prompt-len",
                       "16", "--decode-tokens", "12", "--device",
                       args.device])


if __name__ == "__main__":
    sys.exit(main())
