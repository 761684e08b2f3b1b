"""Greedy decode step p50 of this checkout against another's, in turns.

Each turn is a fresh process on the card: a full-width LM at batch 8 and
a 1,024-token prompt, prefill, then 127 greedy decode steps through
``flash_decode`` (the serving path of ``chip_smoke.py`` phase 8), each
timed by the host clock to its synchronised end; the first three steps
are dropped.  The turns run other, this, this, other, other, this for
olmo-1b and llama3-8b, so that a drift of the host's load falls on both.
One JSON line a turn, after the card's name and power limit.

    python src/repro_torch/launch/decode_ab.py --other DIR
        [--arch olmo-1b --arch llama3-8b]

``DIR`` is the other checkout's ``src`` directory.
"""
import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

HERE_SRC = str(Path(__file__).resolve().parents[2])
BATCH, PROMPT, STEPS, WARM = 8, 1024, 127, 3


def one(src: str, arch: str) -> None:
    sys.path.insert(0, src)
    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.device import generator
    from repro_torch.models.transformer import (decode_step, init_cache,
                                                init_params, prefill)

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = get_arch(arch).config
    params = init_params(cfg, generator(0, dev))
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        1, cfg.vocab, (BATCH, PROMPT)).astype(np.int32)).to(dev)
    ms = []
    with torch.inference_mode():
        cache_pref, logits = prefill(cfg, params, prompts)
        cache = init_cache(cfg, BATCH, PROMPT + STEPS + 1, device=dev)
        for k in ("k", "v"):
            cache[k][:, :, :PROMPT] = cache_pref[k]
        del cache_pref
        tok = logits.argmax(-1).to(torch.int32)
        for i in range(STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cache, tok, _ = decode_step(cfg, params, cache, tok, PROMPT + i)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
    ms = sorted(ms[WARM:])
    print(json.dumps(dict(src=src, arch=arch, step_ms_p50=ms[len(ms) // 2],
                          step_ms_p99=ms[int(0.99 * (len(ms) - 1))],
                          steps=len(ms))), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", required=True,
                    help="the other checkout's src directory")
    ap.add_argument("--arch", action="append")
    args = ap.parse_args(argv)
    archs = args.arch or ["olmo-1b", "llama3-8b"]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    ok = True
    for src in (args.other, HERE_SRC, HERE_SRC, args.other, args.other,
                HERE_SRC):
        for arch in archs:
            r = subprocess.run([sys.executable, __file__, "--one", src, arch],
                               capture_output=True, text=True)
            ok &= r.returncode == 0
            print(r.stdout.strip() or r.stderr[-2000:], flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    if sys.argv[1:2] == ["--one"]:
        one(sys.argv[2], sys.argv[3])
    else:
        sys.exit(main())
