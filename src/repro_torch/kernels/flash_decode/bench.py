"""Time flash_decode beside SDPA at the main path's shape and at the LM
path's own call (``chip_smoke.DECODE_SHAPES[0]`` and ``[LM_CALL]``), with
``chip_smoke.device_ms``, for the ``repro_torch`` package under ``--src``:
this checkout's by default, or another checkout's, so that two designs can
be timed in turns on one card (old, new, new, old).

    python src/repro_torch/kernels/flash_decode/bench.py [--src DIR]

Needs one CUDA card.  Prints one JSON line: the card's name and power
limit and, for each shape, the kernel's and SDPA's device ms, the bytes
bound (K and V read once, q read and the output written once) and each
time's share of it.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[4]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the directory that holds the repro_torch package")
    args = ap.parse_args()
    sys.path[0] = str(Path(args.src).resolve())   # not this file's folder
    sys.path.insert(1, str(ROOT))
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from repro_torch.kernels.flash_decode.ops import flash_decode
    if not torch.cuda.is_available():
        print("bench: needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(cs.SEED)
    rows = []
    for shape in (cs.DECODE_SHAPES[0], cs.DECODE_SHAPES[cs.LM_CALL]):
        b, s, hq, hkv, d, clen, dtype = shape
        dt = getattr(torch, dtype)
        q, k, v = (torch.randn(size, generator=gen, device=dev).to(dt)
                   for size in ((b, hq, d), (b, s, hkv, d), (b, s, hkv, d)))
        kh, vh = (x[:, :clen].transpose(1, 2).contiguous() for x in (k, v))
        before = flash_decode.launch_count
        ms = cs.device_ms(torch, lambda: flash_decode(q, k, v, clen))
        if flash_decode.launch_count == before:
            raise RuntimeError("flash_decode did not launch its kernel")
        sdpa_ms = cs.device_ms(torch, lambda: F.scaled_dot_product_attention(
            q[:, :, None], kh, vh, enable_gqa=True))
        bound = (2 * q.nbytes + 2 * b * clen * hkv * d * k.element_size()) \
            / cs.HBM_BYTES_PER_S * 1e3
        rows.append(dict(shape=list(shape), ms=ms, sdpa_ms=sdpa_ms,
                         bound_ms=bound, share=bound / ms,
                         sdpa_share=bound / sdpa_ms))
        del q, k, v, kh, vh
    print(json.dumps(dict(card=card, src=args.src, flash_decode=rows)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
