"""Time sketch_probe's two entries at the shapes the port launches them
with, with ``chip_smoke.device_ms``, for the ``repro_torch`` package under
``--src``: this checkout's by default, or another checkout's, so that two
designs can be timed in turns on one card (old, new, new, old).  The calls:

- the probe entry, Q 8192 fingerprints (half of them keys) against a
  200k-key MPHF (``chip_smoke.py`` phase 3's main case);
- the fused segment probe at the term wave's size: 4096 fingerprints, half
  of them keys, against a segment of 200k tokens with W 62 planes (the
  size of the 1M-line segmented store's largest segment), OR-ed into a
  (4096, 62) accumulator (skipped for a package without the entry);
- the engine's per-wave step over that one segment,
  ``QueryEngine._device_token_planes`` (the accumulator's zero fill, then
  the segment's probe): the fused launch here, the probe kernel and its
  torch chain in a checkout without the fused entry.

    python src/repro_torch/kernels/sketch_probe/bench.py [--src DIR]
        [--cu FILE ...] [--rounds N]

``--cu`` adds other sources of the kernel with this checkout's C interface
(``sketch_probe_launch`` and ``sketch_match_launch``), built with the
package's nvcc flags, each held to the plain version bit for bit and then
timed in turns with the package's kernel (forward, then backward,
``--rounds`` times), warm (the same call repeated: the segment stays in the
L2) and cold (the L2 flushed by a 100 MB write before each run,
``chip_smoke.l2_flush``).  There is no PyTorch call for the same function.

Needs one CUDA card.  Prints the compiler's register counts, the card's
name and power limit, the launch floor (one empty launch), then one JSON
line per call: each contender's warm and cold device ms in the order
timed, the bytes bound (``chip_smoke.probe_bytes`` / ``fused_bytes``: what
these fingerprints need, each byte moved once) and each contender's host
time for one call (median of 100, microseconds).
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
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.core.mphf import build_mphf
    from repro_torch.core.query_engine import QueryEngine
    from repro_torch.kernels import build
    from repro_torch.kernels.sketch_probe import ops
    from repro_torch.kernels.sketch_probe.ref import sketch_probe_ref
    if not torch.cuda.is_available():
        print("bench: needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda")
    logs = build.build(("sketch_probe",), ptxas_verbose=True)
    cs.print_registers("sketch_probe", logs.get("sketch_probe", ""))
    p, i = ctypes.c_void_p, ctypes.c_int
    mphf_t = (p, p, p, p, p, i, p, p, i)
    variants = {}
    for name, (lib, log) in (build.build_variants(args.cu) if args.cu
                             else {}).items():
        cs.print_registers(name, log)
        variants[name] = (lib, build.declare(
            lib, "sketch_probe_launch", p, i, *mphf_t, p, p, p),
            build.declare(lib, "sketch_match_launch", p, i, *mphf_t,
                          p, i, i, i, p, i, p, i, p, p, i, i, p, i, p))
    floor = cs.launch_floor_ms(torch)
    flush = cs.l2_flush(torch, dev)
    print(f"launch floor: {floor:.4f} ms", flush=True)

    def timed(label, fns, bound, check):
        for name, fn in fns.items():
            got = fn()
            torch.cuda.synchronize()
            if not check(got):
                raise RuntimeError(f"{name} differs from the plain version "
                                   f"at {label}")
        names = list(fns)
        warm, cold = ({name: [] for name in fns} for _ in range(2))
        for r in range(args.rounds):
            for name in (names if r % 2 == 0 else names[::-1]):
                warm[name].append(cs.device_ms(torch, fns[name]))
                cold[name].append(cs.device_ms(torch, fns[name], flush))
        host_us = {name: cs.host_us(torch, fn) for name, fn in fns.items()}
        print(json.dumps(dict(
            card=card, src=args.src, call=label, launch_floor_ms=floor,
            bound_ms=bound / cs.HBM_BYTES_PER_S * 1e3, warm_ms=warm,
            cold_ms=cold, host_us=host_us)), flush=True)

    # ------------------------------------------------------ probe entry
    m, fps_np = cs.mphf_input(np, build_mphf, 1, 200_000, 12, 8192)
    arrs = m.device_arrays(dev)
    fps = cs.u32_tensor(torch, np, fps_np, dev)
    want = sketch_probe_ref(fps, arrs)

    def probe_variant(lib, fn):
        idx = torch.empty(fps.numel(), dtype=torch.int32, device=dev)
        absent = torch.empty(fps.numel(), dtype=torch.bool, device=dev)
        err = fn(fps.data_ptr(), fps.numel(), *ops._mphf_args(arrs),
                 idx.data_ptr(), absent.data_ptr(), build.stream_of(fps))
        build.check(lib, err, "sketch_probe variant")
        return idx, absent

    fns = {"kernel": lambda: ops.mphf_probe_arrs(fps, arrs)}
    for name, (lib, fn, _) in variants.items():
        fns[name] = lambda lib=lib, fn=fn: probe_variant(lib, fn)
    timed("probe entry, Q=8192, 200k keys", fns, cs.probe_bytes(np, m, fps_np),
          lambda got: all(torch.equal(a, b) for a, b in zip(got, want)))

    # ------------------------------------------- fused probe, engine step
    sk, keys = cs.segment_input(np, 5, 200_000, 1984)
    q = 4096
    fps_np = cs.wave_input(np, 5, keys, q)
    fps = cs.u32_tensor(torch, np, fps_np, dev)
    eng = QueryEngine([sk], device=dev)
    arrs = sk.device_cache(dev)
    # the plain version: the same step on the CPU
    want = QueryEngine([sk], device="cpu")._device_token_planes(
        torch.from_numpy(fps_np.view(np.int32)).view(q, 1)).view(q, -1).to(dev)
    w = want.shape[1]
    fused = hasattr(ops, "match_planes")
    if fused:
        acc = torch.zeros((q, w), dtype=torch.int32, device=dev)

        def match_variant(lib, fn):
            err = fn(fps.data_ptr(), q, *ops._mphf_args(arrs),
                     arrs["signatures"].data_ptr(), arrs["signatures"].numel(),
                     sk.sig_bits, int(arrs["n_tokens1"]),
                     arrs["csf_bitseq"].data_ptr(), arrs["csf_bitseq"].numel(),
                     arrs["csf_lengths"].data_ptr(),
                     arrs["csf_lengths"].numel(),
                     arrs["csf_samples"].data_ptr(), arrs["planes"].data_ptr(),
                     w, int(arrs["n_lists1"]), acc.data_ptr(), w,
                     build.stream_of(fps))
            build.check(lib, err, "sketch_probe variant (fused)")
            return acc

        fns = {"kernel": lambda: ops.match_planes(fps, arrs, acc,
                                                  sig_bits=sk.sig_bits)}
        for name, (lib, _, fn) in variants.items():
            fns[name] = lambda lib=lib, fn=fn: match_variant(lib, fn)
        # every contender ORs into one accumulator: the same rows each time
        timed(f"fused entry, Q={q}, {sk.n_tokens} tokens, W={w}", fns,
              cs.fused_bytes(np, sk, fps_np, w),
              lambda got: torch.equal(got, want))
    timed(f"engine step ({'fused' if fused else 'probe + torch chain'}), "
          f"Q={q}, {sk.n_tokens} tokens, W={w}",
          {"engine step": lambda: eng._device_token_planes(fps.view(q, 1))},
          cs.fused_bytes(np, sk, fps_np, w),
          lambda got: torch.equal(got.view(q, -1), want))
    return 0


if __name__ == "__main__":
    sys.exit(main())
