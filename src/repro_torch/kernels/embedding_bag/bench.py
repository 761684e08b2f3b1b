"""Time embedding_bag beside ``F.embedding_bag(mode="sum")`` at
``chip_smoke.EBAG_SHAPES`` (the first is xDeepFM's wide term: V 39M, D 1,
B 512, BAG 39, one id in each of 39 fields), with ``chip_smoke.device_ms``,
for the ``repro_torch`` package under ``--src``: this checkout's by
default, or another checkout's, so that two designs can be timed in turns
on one card (old, new, new, old).

    python src/repro_torch/kernels/embedding_bag/bench.py [--src DIR]
        [--cu FILE ...] [--rounds N]

``--cu`` adds other sources of the kernel with the same C interface
(``embedding_bag_launch``), built with the package's nvcc flags, each held
to the plain version and then timed in turns with the package's kernel and
``F.embedding_bag`` (forward, then backward, ``--rounds`` times).

Each contender is read twice: warm, the same call repeated (the rows it
gathers stay in the L2), and cold, with the L2 flushed by a 100 MB write
before each run, outside the events (``chip_smoke.l2_flush``), as a
request that gathers other rows finds it.

Needs one CUDA card.  Prints the compiler's register counts, the card's
name and power limit, the launch floor (one empty launch), then one JSON
line per shape: each contender's warm and cold device ms in the order
timed, the bytes bound (the indices, the rows they name and the output,
each moved once) and each contender's host time to launch one call
(median of 100, microseconds).
"""
from __future__ import annotations

import argparse
import ctypes
import json
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
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.embedding_bag.ops import embedding_bag_sum
    from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref
    if not torch.cuda.is_available():
        print("bench: needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda")
    logs = build.build(("embedding_bag",), ptxas_verbose=True)
    cs.print_registers("embedding_bag", logs.get("embedding_bag", ""))
    variants = {}
    p, i = ctypes.c_void_p, ctypes.c_int
    for name, (lib, log) in (build.build_variants(args.cu) if args.cu
                             else {}).items():
        cs.print_registers(name, log)
        variants[name] = (lib, build.declare(
            lib, "embedding_bag_launch", p, p, i, i, i, p, p))
    floor = cs.launch_floor_ms(torch)
    flush = cs.l2_flush(torch, dev)
    print(f"launch floor: {floor:.4f} ms", flush=True)

    gen = torch.Generator(dev).manual_seed(cs.SEED)
    for v, d, b, bag, fields in cs.EBAG_SHAPES:
        table = torch.randn((v, d), generator=gen, device=dev)
        idx = torch.randint(0, v // fields, (b, bag), generator=gen,
                            device=dev, dtype=torch.int32)
        if fields > 1:
            idx += torch.arange(bag, device=dev, dtype=torch.int32) * (v // fields)
        want = embedding_bag_ref(table, idx)

        def variant(lib, fn, table=table, idx=idx):
            out = torch.empty((idx.shape[0], table.shape[1]),
                              dtype=torch.float32, device=dev)
            err = fn(table.data_ptr(), idx.data_ptr(), idx.shape[0],
                     idx.shape[1], table.shape[1], out.data_ptr(),
                     build.stream_of(table))
            build.check(lib, err, "embedding_bag variant")
            return out

        fns = {"kernel": lambda table=table, idx=idx: embedding_bag_sum(
            table, idx)}
        for name, (lib, fn) in variants.items():
            fns[name] = lambda lib=lib, fn=fn: variant(lib, fn)
        before = embedding_bag_sum.launch_count
        for name, fn in fns.items():
            got = fn()
            torch.cuda.synchronize()
            torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5,
                                       msg=lambda m: f"{name}: {m}")
        if embedding_bag_sum.launch_count != before + 1:
            raise RuntimeError("embedding_bag did not launch its kernel")
        fns["F.embedding_bag"] = lambda table=table, idx=idx: F.embedding_bag(
            idx, table, mode="sum")
        names = list(fns)
        warm, cold = ({name: [] for name in fns} for _ in range(2))
        for r in range(args.rounds):
            for name in (names if r % 2 == 0 else names[::-1]):
                warm[name].append(cs.device_ms(torch, fns[name]))
                cold[name].append(cs.device_ms(torch, fns[name], flush))
        host_us = {name: cs.host_us(torch, fn) for name, fn in fns.items()}
        bound = (cs.nbytes(idx) + idx.numel() * d * 4 + b * d * 4) \
            / cs.HBM_BYTES_PER_S * 1e3
        print(json.dumps(dict(
            card=card, src=args.src, v=v, d=d, b=b, bag=bag,
            launch_floor_ms=floor, bound_ms=bound, warm_ms=warm,
            cold_ms=cold, host_us=host_us)), flush=True)
        del table, idx, want
    return 0


if __name__ == "__main__":
    sys.exit(main())
