"""Run one cell of the benchmark once and print its result line.

    python3 chipbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of ``workloads`` in ``BENCHMARK.json``.  Its
configuration is ``configs/<config>.json``, its traffic
``traffic/<traffic>.json`` (which names its driver, ``traffic/<driver>.py``),
and its own settings (warm-up, the check's sample and limits)
``workloads/<cell>.json``.  ``--trace 0`` reports the cell's end-to-end
metrics; ``--trace 1`` runs the window under the profiler with spans on and
reports its per-layer metrics, each read by ``metrics/<name>.py``.

The run needs the cards the cell asks for and fails without them.  It
exits non-zero, printing no result, if the port's package is missing, or
if JAX or the JAX package was loaded once the window has closed.  The last
lines on standard error, and the result's last key, ``check``, hold each
number compared with its limit.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

#: Top-level module names that no run may load: JAX and the JAX package
#: (the port's name, ``repro_torch``, begins with the latter's, so names
#: are compared whole).
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def host_probe_ms() -> float:
    """Milliseconds of a fixed pure-Python loop on one thread: the host's
    speed at that moment, to tell a slower host from the run's own threads
    queueing for the interpreter lock."""
    t = time.perf_counter()
    x = 0
    for i in range(1_000_000):
        x += i & 7
    return 1e3 * (time.perf_counter() - t)


def forbidden_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def cell_parts(bench: dict, name: str):
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    return (cell, load_json(HERE / "configs" / f"{cell['config']}.json"),
            load_json(HERE / "traffic" / f"{cell['traffic']}.json"),
            load_json(HERE / "workloads" / f"{name}.json"))


def _applies(metric: dict, cell: dict, e2e_names: set) -> bool:
    """Whether the cell reports ``metric``: the cells its ``workloads``
    lists, or else, for a per-layer metric, every cell that reports the
    end-to-end metric it moves."""
    if "workloads" in metric:
        return cell["name"] in metric["workloads"]
    return "moves" not in metric or metric["moves"] in e2e_names


def _reader(name: str):
    """``metrics/<name>.py``'s ``read``; a quantity split by the
    end-to-end metric it moves (``device_idle.serve``) may share one
    reader, ``metrics/<name up to its last dot>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    if not path.exists():
        path = HERE / "metrics" / f"{name.rsplit('.', 1)[0]}.py"
    spec = importlib.util.spec_from_file_location(
        f"chipbench_metric_{path.stem.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def execute(bench: dict, name: str, seed: int, seconds: float, trace: bool,
            device, overrides=None, t0: float = T0) -> dict:
    """One run of cell ``name`` on ``device``; returns the result's dict.
    ``overrides(config, traffic, cellfile)`` may shrink a run for a test."""
    import torch

    from chipbench.trace import DeviceTrace, Spans

    cell, config, traffic, cellfile = cell_parts(bench, name)
    if overrides is not None:
        overrides(config, traffic, cellfile)
    driver = importlib.import_module(f"chipbench.traffic.{traffic['driver']}")
    on_card = device.type == "cuda"
    ctx = driver.prepare(config, traffic, cellfile, seed, device)
    if on_card:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t0
    host = {"probe_before_ms": host_probe_ms(),
            "cpus": len(os.sched_getaffinity(0)),
            "load1": os.getloadavg()[0]}
    spans = Spans() if trace else None
    traced = DeviceTrace(torch, device) if trace and on_card else None
    cpu, wall = time.process_time(), time.perf_counter()
    try:
        if traced is not None:
            with traced:
                obs = driver.window(ctx, seconds, spans)
        else:
            obs = driver.window(ctx, seconds, spans)
            if on_card:
                torch.cuda.synchronize(device)
    finally:
        if spans is not None:
            spans.restore()
    t = time.perf_counter()
    host.update(window_cpu_per_wall=(time.process_time() - cpu) / (t - wall),
                probe_after_ms=host_probe_ms())
    driver.finish(ctx)
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    t1 = time.perf_counter()
    found = driver.check(ctx)
    print(json.dumps({"setup_s": setup_s, **ctx["setup_parts"],
                      "after_window_s": t1 - t, **ctx.get("after_parts", {}),
                      **obs.get("notes", {}), "host": host,
                      "reference_s": time.perf_counter() - t1}),
          file=sys.stderr)
    found["failed"] = obs["failed"]
    found["empty_run"] = int(found["answers"] == 0)
    check = {k: [found[k], lim] for k, lim in cellfile["limits"].items()}

    obs["window_s"] = seconds
    device_info = {"platform": "gpu" if on_card else device.type,
                   "kind": (torch.cuda.get_device_name(device) if on_card
                            else "cpu"),
                   "count": 1, "memory_peak_bytes": int(peak)}
    e2e_names = {m["name"] for m in bench["end_to_end"]
                 if _applies(m, cell, set())}
    breakdown = None
    if trace:
        if traced is not None:
            t = traced.reduce(spans)
            obs["device"] = t
            device_info["busy_s"] = t.get("busy_s", 0.0)
            device_info["window_s"] = t["window_s"]
            if "device_ops" in t:
                breakdown = {"device_ops": t["device_ops"],
                             "idle_gaps": t["idle_gaps"]}
        obs["spans"] = spans
        metrics = {}
        for m in bench["per_layer"]:
            if not _applies(m, cell, e2e_names):
                continue
            value = _reader(m["name"])(obs)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(obs["e2e"], setup_s=setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in bench["end_to_end"] if m["name"] in e2e_names}
    result = {"correct": all(v <= lim for v, lim in check.values()),
              "attempted": obs["attempted"], "failed": obs["failed"],
              "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    if obs.get("first_error"):
        result["first_error"] = obs["first_error"]
    result["answers_compared"] = found["answers"]
    result["check"] = check
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = load_json(ROOT / "BENCHMARK.json")
    cell = cell_parts(bench, args.workload)[0]

    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"this cell needs {cell['chips']} CUDA card(s); "
              f"torch sees {torch.cuda.device_count()}: no result",
              file=sys.stderr)
        return 2
    result = execute(bench, args.workload, args.seed, args.seconds,
                     bool(args.trace), torch.device("cuda", 0))
    found = forbidden_modules()
    if found:
        print(f"the run loaded {', '.join(found)}: no result",
              file=sys.stderr)
        return 3
    for k, (v, lim) in result["check"].items():
        print(f"check {k} {v} limit {lim}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
