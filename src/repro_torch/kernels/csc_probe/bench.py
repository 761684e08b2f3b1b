"""Time csc_probe at the CSC path's two calls, one per-query call (15
fingerprints: a term and its n-grams) and the one-call wave (66,994
fingerprints), on a sketch of the CSC path's size (m = 2^27 bits, k 4,
p 64, j 1, as ``chip_smoke.py`` phase 5 sizes it; random plane words and
fingerprints from the seed: the kernel's work does not depend on them),
with ``chip_smoke.device_ms``, for the ``repro_torch`` package under
``--src``: this checkout's by default, or another checkout's, so that two
designs can be timed in turns on one card (old, new, new, old).

    python src/repro_torch/kernels/csc_probe/bench.py [--src DIR]
        [--cu FILE ...] [--q N ...] [--rounds N]

``--cu`` adds other sources of the kernel with this checkout's C interface
(``csc_probe_launch`` with host and device seeds), built with the
package's nvcc flags, each held to the plain version bit for bit and then
timed in turns with the package's kernel (forward, then backward,
``--rounds`` times).  ``--q`` adds other call sizes.  There is no
PyTorch call for the same function.

Each contender is read twice: warm, the same call repeated (the plane's
16 MB stay in the L2), and cold, with the L2 flushed by a 100 MB write
before each run, outside the events (``chip_smoke.l2_flush``).

Needs one CUDA card.  Prints the compiler's register counts, the card's
name and power limit, the launch floor (one empty launch), then one JSON
line per call: each contender's warm and cold device ms in the order timed,
the bytes bound (the fingerprints, the words each anchor needs and the
mask, each moved once) and each contender's host time to launch one call
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
M_BITS, K, P, J = 1 << 27, 4, 64, 1
CALLS = (("one per-query call", 15), ("wave", 66_994))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the directory that holds the repro_torch package")
    ap.add_argument("--cu", action="append", default=[], type=Path,
                    help="another source of the kernel to time beside it")
    ap.add_argument("--q", action="append", default=[], type=int,
                    help="another call size (fingerprints) to time")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    sys.path[0] = str(Path(args.src).resolve())   # not this file's folder
    sys.path.insert(1, str(ROOT))
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.baselines.csc import CSCSketch
    from repro_torch.kernels import build
    from repro_torch.kernels.csc_probe.ops import csc_partition_mask
    if not torch.cuda.is_available():
        print("bench: needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda")
    logs = build.build(("csc_probe",), ptxas_verbose=True)
    cs.print_registers("csc_probe", logs.get("csc_probe", ""))
    variants = {}
    p, i = ctypes.c_void_p, ctypes.c_int
    for name, (lib, log) in (build.build_variants(args.cu) if args.cu
                             else {}).items():
        cs.print_registers(name, log)
        variants[name] = (lib, build.declare(
            lib, "csc_probe_launch", p, i, p, i, p, p, i, i, i, p, p))
    floor = cs.launch_floor_ms(torch)
    flush = cs.l2_flush(torch, dev)
    print(f"launch floor: {floor:.4f} ms", flush=True)

    rng = np.random.default_rng(cs.SEED)
    sk = CSCSketch.build(m_bits=M_BITS, k=K, p=P, j=J)
    sk.bits[:] = rng.integers(0, 2**32, sk.bits.shape, dtype=np.uint64)
    arrs = sk.device_arrays(dev)
    seeds = (ctypes.c_uint32 * (J * K))(
        *arrs["seeds"].cpu().numpy().view(np.uint32).tolist())
    for label, q in CALLS + tuple((f"Q={q}", q) for q in args.q):
        fps = cs.u32_tensor(torch, np, rng.integers(
            0, 2**32, q, dtype=np.uint64), dev)
        want = sk.partition_mask_torch(fps)

        def variant(lib, fn, fps=fps):
            out = torch.empty((fps.numel(), P), dtype=torch.bool, device=dev)
            err = fn(fps.data_ptr(), fps.numel(), arrs["bits"].data_ptr(),
                     sk.m >> 5, seeds, arrs["seeds"].data_ptr(), J, K, P,
                     out.data_ptr(), build.stream_of(fps))
            build.check(lib, err, "csc_probe variant")
            return out

        fns = {"kernel": lambda fps=fps: csc_partition_mask(sk, fps)}
        for name, (lib, fn) in variants.items():
            fns[name] = lambda lib=lib, fn=fn: variant(lib, fn)
        before = csc_partition_mask.launch_count
        for name, fn in fns.items():
            got = fn()
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise RuntimeError(f"{name} differs from the plain version "
                                   f"at Q={q}")
        if csc_partition_mask.launch_count != before + 1:
            raise RuntimeError("csc_probe did not launch its kernel")
        names = list(fns)
        warm, cold = ({name: [] for name in fns} for _ in range(2))
        for r in range(args.rounds):
            for name in (names if r % 2 == 0 else names[::-1]):
                warm[name].append(cs.device_ms(torch, fns[name]))
                cold[name].append(cs.device_ms(torch, fns[name], flush))
        host_us = {name: cs.host_us(torch, fn) for name, fn in fns.items()}
        words = J * K * ((P + 31) // 32 + 1)
        bound = q * (4 + 4 * words + P) / cs.HBM_BYTES_PER_S * 1e3
        print(json.dumps(dict(
            card=card, src=args.src, call=label, q=q, m=sk.m, k=K, p=P, j=J,
            launch_floor_ms=floor, bound_ms=bound, warm_ms=warm,
            cold_ms=cold, host_us=host_us)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
