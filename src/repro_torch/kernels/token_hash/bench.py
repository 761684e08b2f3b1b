"""Time token_hash at the shapes the port launches it with, with
``chip_smoke.device_ms``, for the ``repro_torch`` package under ``--src``:
this checkout's by default, or another checkout's, so that two designs can
be timed in turns on one card (old, new, new, old).  The shapes:

- the median ingest launch, 12,456 x 22: rules 1-5 tokens of generated log
  lines of at most 22 bytes, packed at width 22 (the segmented ingest's
  median flush batch, ``chip_smoke.py`` phase 4);
- the term wave, 4096 id terms packed at their longest length, and the
  contains wave, the trigram tokens of 1024 needles of 5-10 characters
  (``QueryEngine.query_batch``'s one launch per wave);
- 32,768 x 64, ``chip_smoke.py`` phase 3's main case.

    python src/repro_torch/kernels/token_hash/bench.py [--src DIR]
        [--cu FILE ...] [--rounds N]

``--cu`` adds other sources of the kernel with this checkout's C interface
(``token_hash_launch(tokens, lengths, n, l, out, stream)``), built with the
package's nvcc flags; ``thread_per_row.cu`` beside this file, the first
design, is always one of them.  Each contender is held to the plain
version bit for bit, then all are timed in turns (forward, then backward,
``--rounds`` times), warm (the same call repeated) and cold (the L2
flushed by a 100 MB write before each run, ``chip_smoke.l2_flush``).
There is no PyTorch call for the same function.

Needs one CUDA card.  Prints the compiler's register counts, the card's
name and power limit, the launch floor (one empty launch), then one JSON
line per shape: each contender's warm and cold device ms in the order
timed, the bytes bound (each row's hashed bytes, the lengths and the
fingerprints, each moved once) and each contender's host time to launch
one call (median of 100, microseconds).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[4]
HERE = Path(__file__).resolve().parent


def shapes(np, cs):
    """(label, (N, L) u8 matrix, (N,) int32 lengths) of each timed call."""
    from repro_torch.core.tokenizer import (contains_query_tokens,
                                            pack_tokens_batch,
                                            term_query_tokens,
                                            tokenize_lines_columnar)
    from repro_torch.logstore.datasets import generate_dataset, id_queries
    lines = generate_dataset("tokens", n_lines=8192, n_sources=64,
                             seed=cs.SEED).lines
    toks = tokenize_lines_columnar(lines, ngrams=False)[0]
    short = [t for t in toks if len(t) <= 22][:12_456]
    rng = np.random.default_rng(cs.SEED)
    terms = [t for x in id_queries(cs.SEED, 4096) for t in term_query_tokens(x)]
    needles = []
    for x in id_queries(cs.SEED + 1, 1024):
        n = int(rng.integers(5, 11))
        s = int(rng.integers(0, max(len(x) - n, 0) + 1))
        needles.extend(contains_query_tokens(x[s:s + n]))
    out = []
    for label, group, width in (
            ("median ingest launch", short, 22),
            ("term wave", terms, max(len(t) for t in terms)),
            ("contains wave", needles, max(len(t) for t in needles)),
            ("phase 3 main", toks[:32_768], 64)):
        mat, lens = pack_tokens_batch(group, width)
        out.append((label, mat, lens))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the directory that holds the repro_torch package")
    ap.add_argument("--cu", action="append", default=[], type=Path,
                    help="another source of the kernel to time beside it")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    sys.path[0] = str(Path(args.src).resolve())   # not this file's folder
    sys.path.insert(1, str(ROOT))
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.token_hash.ops import token_fingerprints
    from repro_torch.kernels.token_hash.ref import token_hash_ref
    if not torch.cuda.is_available():
        print("bench: needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda")
    logs = build.build(("token_hash",), ptxas_verbose=True)
    cs.print_registers("token_hash", logs.get("token_hash", ""))
    variants = {}
    p, i = ctypes.c_void_p, ctypes.c_int
    for name, (lib, log) in build.build_variants(
            [HERE / "thread_per_row.cu", *args.cu]).items():
        cs.print_registers(name, log)
        variants[name] = (lib, build.declare(lib, "token_hash_launch",
                                             p, p, i, i, p, p))
    floor = cs.launch_floor_ms(torch)
    flush = cs.l2_flush(torch, dev)
    print(f"launch floor: {floor:.4f} ms", flush=True)

    for label, mat, lens in shapes(np, cs):
        t = torch.from_numpy(mat).to(dev)
        ln = torch.from_numpy(lens).to(dev)
        n, l = mat.shape
        want = token_hash_ref(t, ln)

        def variant(lib, fn, t=t, ln=ln):
            out = torch.empty(t.shape[0], dtype=torch.int32, device=dev)
            err = fn(t.data_ptr(), ln.data_ptr(), t.shape[0], t.shape[1],
                     out.data_ptr(), build.stream_of(t))
            build.check(lib, err, "token_hash variant")
            return out

        fns = {"kernel": lambda t=t, ln=ln: token_fingerprints(t, ln)}
        for name, (lib, fn) in variants.items():
            fns[name] = lambda lib=lib, fn=fn: variant(lib, fn)
        before = token_fingerprints.launch_count
        for name, fn in fns.items():
            got = fn()
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise RuntimeError(f"{name} differs from the plain version "
                                   f"at {label}")
        if token_fingerprints.launch_count != before + 1:
            raise RuntimeError("token_hash did not launch its kernel")
        names = list(fns)
        warm, cold = ({name: [] for name in fns} for _ in range(2))
        for r in range(args.rounds):
            for name in (names if r % 2 == 0 else names[::-1]):
                warm[name].append(cs.device_ms(torch, fns[name]))
                cold[name].append(cs.device_ms(torch, fns[name], flush))
        host_us = {name: cs.host_us(torch, fn) for name, fn in fns.items()}
        hashed = int(np.clip(lens, 0, l).sum())
        bound = (hashed + 8 * n) / cs.HBM_BYTES_PER_S * 1e3
        print(json.dumps(dict(
            card=card, src=args.src, call=label, n=n, l=l,
            launch_floor_ms=floor, bound_ms=bound, warm_ms=warm,
            cold_ms=cold, host_us=host_us)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
