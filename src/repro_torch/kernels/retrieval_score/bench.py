"""Time retrieval_score beside ``torch.mv`` at the main shape
(``chip_smoke.RETRIEVAL_SHAPES[0]``, seeded random inputs) and at the
two-tower path's own call (the corpus that ``family_init`` makes and one
user tower's output), with ``chip_smoke.device_ms``, for the
``repro_torch`` package under ``--src``: this checkout's by default, or
another checkout's, so that two designs can be timed in turns on one card
(old, new, new, old).

    python src/repro_torch/kernels/retrieval_score/bench.py [--src DIR]
        [--cu FILE ...] [--rounds N]

``--cu`` adds other sources of the kernel with the same C interface
(``retrieval_score_launch``), built with the package's nvcc flags, each
held to the plain version and then timed in turns with the package's
kernel and ``torch.mv`` (forward, then backward, ``--rounds`` times).

Needs one CUDA card.  Prints the compiler's register counts, then one
JSON line per shape: the card's name and
power limit, each contender's device ms in the order timed, the bytes
bound (the corpus and the query read once, the scores written once), each
median's share of it, and each contender's host time to launch one call
(median of 100, microseconds).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[4]


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
    from repro_torch.configs import get_arch
    from repro_torch.device import generator
    from repro_torch.kernels import build
    from repro_torch.kernels.retrieval_score.ops import retrieval_scores
    from repro_torch.kernels.retrieval_score.ref import retrieval_score_ref
    from repro_torch.launch.steps import family_init
    from repro_torch.models import recsys
    if not torch.cuda.is_available():
        print("bench: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    logs = build.build(("retrieval_score",), ptxas_verbose=True)
    cs.print_registers("retrieval_score", logs.get("retrieval_score", ""))
    variants = {}
    p, i = ctypes.c_void_p, ctypes.c_int
    for name, (lib, log) in (build.build_variants(args.cu) if args.cu
                             else {}).items():
        cs.print_registers(name, log)
        variants[name] = (lib, build.declare(
            lib, "retrieval_score_launch", p, p, i, i, i, p, p))

    gen = generator(cs.SEED, dev)
    c, d = cs.RETRIEVAL_SHAPES[0]
    shapes = [("main", torch.randn((c, d), generator=gen, device=dev),
               torch.randn(d, generator=gen, device=dev))]
    spec = get_arch("two-tower-retrieval")
    params = family_init(spec)(generator(cs.SEED, dev))
    user = torch.from_numpy(np.random.default_rng(cs.SEED).integers(
        0, spec.config.field_vocab, (1, spec.config.n_user_fields))
        .astype(np.int32)).to(dev)
    with torch.inference_mode():
        u = recsys._user(spec.config, params, user)[0].contiguous()
    shapes.append(("two_tower", params["corpus"], u))

    for label, x, q in shapes:
        want = retrieval_score_ref(x, q)

        def variant(lib, fn, x=x, q=q):
            out = torch.empty(x.shape[0], dtype=torch.float32, device=dev)
            vec = int(x.shape[1] % 4 == 0 and x.data_ptr() % 16 == 0
                      and q.data_ptr() % 16 == 0)
            err = fn(x.data_ptr(), q.data_ptr(), x.shape[0], x.shape[1], vec,
                     out.data_ptr(), build.stream_of(x))
            build.check(lib, err, "retrieval_score variant")
            return out

        fns = {"kernel": lambda x=x, q=q: retrieval_scores(x, q)}
        for name, (lib, fn) in variants.items():
            fns[name] = lambda lib=lib, fn=fn: variant(lib, fn)
        before = retrieval_scores.launch_count
        for name, fn in fns.items():
            got = fn()
            torch.cuda.synchronize()
            torch.testing.assert_close(got, want, rtol=2e-5, atol=1e-4,
                                       msg=lambda m: f"{name}: {m}")
        if retrieval_scores.launch_count != before + 1:
            raise RuntimeError("retrieval_score did not launch its kernel")
        fns["torch_mv"] = lambda x=x, q=q: torch.mv(x, q)
        names, times = list(fns), {name: [] for name in fns}
        for r in range(args.rounds):
            for name in (names if r % 2 == 0 else names[::-1]):
                times[name].append(cs.device_ms(torch, fns[name]))
        host_us = {name: cs.host_us(torch, fn) for name, fn in fns.items()}
        bound = (cs.nbytes(x, q) + 4 * x.shape[0]) / cs.HBM_BYTES_PER_S * 1e3
        print(json.dumps(dict(
            card=card, src=args.src, shape=label, c=x.shape[0], d=x.shape[1],
            bound_ms=bound, ms=times,
            share={k: bound / statistics.median(v) for k, v in times.items()},
            host_us=host_us)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
