"""Read the control's numbers for a cell: the reference put in the
program's place with one stated guarantee broken, at the cell's own size.

    python3 chipbench/control.py --workload <cell> --seeds 1,2,3 [--acked N]

A serving cell's control answers every term of the window's streams at
batch granularity; the ingest cell's loses the last acknowledged chunk of
``--acked`` lines.  Each seed prints the numbers ``run.py`` compares; the
control has to fail at least one of them.  No card is needed, and the
benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import importlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chipbench.run import cell_parts, load_json  # noqa: E402


def readings(name: str, seed: int, acked: int, overrides=None) -> dict:
    bench = load_json(ROOT / "BENCHMARK.json")
    _, config, traffic, cellfile = cell_parts(bench, name)
    if overrides is not None:
        overrides(config, traffic, cellfile)
    driver = importlib.import_module(f"chipbench.traffic.{traffic['driver']}")
    ctx = driver.make_inputs(config, traffic, seed)
    ctx.update(config=config, traffic=traffic, cell=cellfile, seed=seed,
               acked=acked)
    out = driver.check(ctx, driver.control(ctx))
    return {k: out[k] for k in cellfile["limits"] if k in out} | {
        "answers": out["answers"]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--acked", type=int, default=800_000,
                    help="lines acknowledged, for the ingest cell")
    args = ap.parse_args()
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        r = readings(args.workload, seed, args.acked)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "seconds": round(time.perf_counter() - t, 1),
                          "control": r}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
