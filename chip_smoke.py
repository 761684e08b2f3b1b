#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the DynaWarp log store on one GPU.

    python3 chip_smoke.py

Phases (any failure raises, so the exit code is not 0):
  1. print the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (nvcc);
  3. hold each kernel against its plain PyTorch version on the card, at the
     main path's shapes and at the edges (ragged W, Q not a power of two,
     empty / full / over-max_hits rows, absent keys, fallback keys), bit
     for bit, and time both;
  4. the main path: a 1M-line synthetic log (1000 sources) ingested into
     ``DynaWarpStore(mode="segmented")`` at the paper's defaults on the GPU,
     then waves of term and multi-token contains queries; every candidate
     list must equal the engine's scalar host path and a sample of term
     answers must equal the scan store's;
  5. print the ``kernels`` JSON line (launch counts of the main path, the
     error against the plain versions, times and bounds), then the result.

It needs one CUDA card and the repository around it; without either it
exits with a non-zero code and prints no result.
"""
from __future__ import annotations

import gc
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
N_LINES, N_SOURCES, SEED, BATCH_LINES = 1_000_000, 1000, 3, 512
N_TERMS, N_NEEDLES = 4096, 1024      # term wave: half present, half absent
N_SCAN_SAMPLE = 8
HBM_BYTES_PER_S = 3.35e12            # H100 SXM device memory rate
SPIN_CYCLES = 20_000_000             # queued spin that hides launch cost
REPS = 25


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


# ------------------------------------------------------------------ timing
def device_ms(torch, fn) -> float:
    """Median device time of one ``fn()`` call over REPS runs.  Each run is
    queued behind a GPU spin, so the events bracket only the device work
    (the host's launch cost of ``fn`` is hidden behind the spin)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_busy(torch, fn) -> tuple[float, float | None]:
    """(wall ms, device busy ms) of one ``fn()`` call under torch.profiler:
    busy is the sum of the kernels' and copies' device time (None when the
    profiler saw no device activity)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA)
    return wall * 1e3, (busy / 1e3 if busy else None)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


# ------------------------------------------------------------------ inputs
def u32_tensor(torch, np, a, dev):
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32)
                            .view(np.int32)).to(dev)


def planes_input(np, seed, q, t, w):
    rng = np.random.default_rng(seed)
    p = (rng.integers(0, 2**32, (q, t, w), dtype=np.uint64)
         | rng.integers(0, 2**32, (q, t, w), dtype=np.uint64)) \
        .astype(np.uint32)
    p[0] = 0                                    # an empty row
    if q > 1:
        p[1] = 0xFFFFFFFF                       # a full row
    if q > 2:
        p[2] &= np.uint32(0x00010001)           # a sparse row
    return p


def bitmaps_input(np, seed, q, w):
    rng = np.random.default_rng(seed)
    density = rng.choice([0.0, 0.002, 0.02, 0.3, 1.0], size=(q, 1))
    bits = rng.random((q, w * 32)) < density
    bits[-1] = True
    if q > 1:
        bits[0] = False
    packed = np.packbits(bits.reshape(q, w, 32), axis=-1,
                         bitorder="little")
    return packed.view(np.uint32).reshape(q, w)


def mphf_input(np, build_mphf, seed, n_keys, max_levels, q):
    rng = np.random.default_rng(seed)
    keys = np.unique(rng.integers(0, 2**32, n_keys, dtype=np.uint64)
                     .astype(np.uint32))
    absent = rng.integers(0, 2**32, q, dtype=np.uint64).astype(np.uint32)
    fps = np.concatenate([rng.choice(keys, q // 2), absent[:q - q // 2 - 2],
                          [0, 0xFFFFFFFF]]).astype(np.uint32)
    return build_mphf(keys, max_levels=max_levels), fps


# ---------------------------------------------------------------- phase 3
def check_kernels(torch, np, dev) -> dict:
    """Every kernel function against its plain version on the card; returns
    per-kernel error, times and bounds at its main-path shape."""
    from repro_torch.core.mphf import build_mphf
    from repro_torch.kernels.bitmap_extract.ops import bitmap_extract
    from repro_torch.kernels.bitmap_extract.ref import bitmap_extract_ref
    from repro_torch.kernels.bitset_ops.ops import (bitset_reduce,
                                                    bitset_reduce_batch)
    from repro_torch.kernels.bitset_ops.ref import (bitset_reduce_batch_ref,
                                                    bitset_reduce_ref)
    from repro_torch.kernels.sketch_probe.ops import mphf_probe_arrs
    from repro_torch.kernels.sketch_probe.ref import sketch_probe_ref

    def max_err(outs, refs):
        return max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
                   if a.numel() else 0 for a, b in zip(outs, refs))

    def run(name, cases, kernel, plain, bytes_of, main):
        err, shapes = 0, []
        for case in cases:
            outs, refs = kernel(*case), plain(*case)
            torch.cuda.synchronize()
            e = max_err(outs, refs)
            require(e == 0 and all(torch.equal(a, b)
                                   for a, b in zip(outs, refs)),
                    f"{name} disagrees with its plain version on {case[-1]}")
            err = max(err, e)
            shapes.append(case[-1])
        case = cases[main]
        ms = device_ms(torch, lambda: kernel(*case))
        plain_ms = device_ms(torch, lambda: plain(*case))
        bound = bytes_of(*case) / HBM_BYTES_PER_S * 1e3
        print(f"kernel {name}: bit-exact on {len(cases)} cases {shapes}; "
              f"at {case[-1]}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"bound {bound:.6f} ms (bytes)", flush=True)
        return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    bound_ms=bound, shape=case[-1])

    results = {}
    # sketch_probe: a main-path-sized MPHF (~200k keys, the largest
    # segment's), one whose keys partly land in the fallback array, a tiny one
    probe_cases = []
    for seed, n_keys, levels, q in ((1, 200_000, 12, 8192),
                                    (2, 50_000, 2, 1000),
                                    (3, 40, 12, 7)):
        m, fps = mphf_input(np, build_mphf, seed, n_keys, levels, q)
        require(levels == 12 or m.fallback_fps.size > 0,
                "fallback case has no fallback keys")
        probe_cases.append((u32_tensor(torch, np, fps, dev),
                            m.device_arrays(dev),
                            f"Q={q} keys={n_keys} fallback={m.fallback_fps.size}"))
    results["sketch_probe"] = run(
        "sketch_probe", probe_cases,
        lambda f, a, _: mphf_probe_arrs(f, a),
        lambda f, a, _: sketch_probe_ref(f, a),
        lambda f, a, _: (nbytes(f) + nbytes(*(v for v in a.values()
                                               if isinstance(v, torch.Tensor)))
                         + 5 * f.numel()), 0)

    def planes_cases(shapes):
        out = []
        for i, (q, t, w, op) in enumerate(shapes):
            p = u32_tensor(torch, np, planes_input(np, 10 + i, q, t, w), dev)
            out.append((p, op, f"{(q, t, w)} {op}"))
        return out

    results["bitset_reduce_batch"] = run(
        "bitset_reduce_batch",
        planes_cases([(1024, 8, 62, "and"), (1024, 8, 62, "or"),
                      (4096, 1, 62, "and"), (1000, 3, 61, "or"),
                      (5, 8, 64, "and"), (3, 1, 1, "or")]),
        lambda p, op, _: bitset_reduce_batch(p, op=op),
        lambda p, op, _: bitset_reduce_batch_ref(p, op=op),
        lambda p, op, _: nbytes(p) + 4 * p.shape[0] * (p.shape[2] + 1), 0)

    single = [(p[0].contiguous(), op, s) for p, op, s in planes_cases(
        [(1, 8, 62, "and"), (1, 1, 62, "or"), (1, 3, 64, "and"),
         (1, 2, 7, "or")])]
    results["bitset_reduce"] = run(
        "bitset_reduce", single,
        lambda p, op, _: bitset_reduce(p, op=op),
        lambda p, op, _: bitset_reduce_ref(p, op=op),
        lambda p, op, _: nbytes(p) + 4 * (p.shape[1] + 1), 0)

    ext = []
    for i, (q, w, mh) in enumerate(((1024, 62, 2048), (4096, 62, 64),
                                    (1000, 61, 128), (5, 3, 8),
                                    (4, 40, 0))):
        bm = u32_tensor(torch, np, bitmaps_input(np, 20 + i, q, w), dev)
        ext.append((bm, mh, f"Q={q} W={w} max_hits={mh}"))
    results["bitmap_extract"] = run(
        "bitmap_extract", ext,
        lambda b, mh, _: bitmap_extract(b, max_hits=mh),
        lambda b, mh, _: bitmap_extract_ref(b, max_hits=mh),
        lambda b, mh, _: nbytes(b) + 4 * b.shape[0] * (mh + 1), 0)
    return results


# ---------------------------------------------------------------- phase 4
def main_path(torch, np, counters) -> dict:
    from repro_torch.core.query_engine import _as_fp
    from repro_torch.core.tokenizer import (contains_query_tokens,
                                            term_query_tokens)
    from repro_torch.logstore.datasets import (generate_dataset, id_queries,
                                               present_id_queries)
    from repro_torch.logstore.store import DynaWarpStore, ScanStore

    t0 = time.perf_counter()
    ds = generate_dataset("smoke", n_lines=N_LINES, n_sources=N_SOURCES,
                          seed=SEED)
    present = present_id_queries(ds, SEED + 1, N_TERMS // 2)
    terms = present + id_queries(SEED + 2, N_TERMS - len(present))
    rng = np.random.default_rng(SEED)
    needles = []
    for t in present_id_queries(ds, SEED + 3, N_NEEDLES):
        n = int(rng.integers(5, 11))          # 3..8 trigram tokens
        s = int(rng.integers(0, len(t) - n + 1))
        needles.append(t[s:s + n])
    needle_toks = [contains_query_tokens(n) for n in needles]
    print(f"dataset: {ds.n_lines} lines, {N_SOURCES} sources, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    for c in counters.values():
        c.launch_count = 0
    # ----------------------------------------------- the main path proper
    t0 = time.perf_counter()
    store = DynaWarpStore(batch_lines=BATCH_LINES, mode="segmented")
    store.ingest(ds.lines)
    store.finish()
    ingest_s = time.perf_counter() - t0
    # the million dataset lines are this script's, not the store's: move
    # them out of the cyclic collector's view so its full passes do not
    # land inside the timed waves
    gc.collect()
    gc.freeze()
    eng = store.engine
    waves = {}

    def wave(name, fn):
        before = {k: c.launch_count for k, c in counters.items()}
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        cold = time.perf_counter() - t
        t = time.perf_counter()
        again = fn()
        torch.cuda.synchronize()
        warm = time.perf_counter() - t
        require(all(np.array_equal(a, b) for a, b in zip(out, again)),
                f"{name}: a repeated wave answered differently")
        launches = {k: (c.launch_count - before[k]) // 2
                    for k, c in counters.items()}
        wall_ms, busy_ms = device_busy(torch, fn)
        waves[name] = dict(queries=len(out), cold_s=cold, warm_s=warm,
                           warm_qps=len(out) / warm, launches=launches,
                           profiled_wall_ms=wall_ms, device_busy_ms=busy_ms)
        busy = ("not measured" if busy_ms is None else
                f"{busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}% of "
                f"{wall_ms:.1f} ms profiled)")
        print(f"wave {name}: {len(out)} queries, cold {cold:.3f} s, warm "
              f"{warm:.4f} s = {len(out) / warm:.0f} q/s, launches per wave "
              f"{launches}, device busy {busy}", flush=True)
        return out

    term_cands = wave("term", lambda: store.candidates_term_batch(terms))
    contains = {op: wave(f"contains_{op}",
                         lambda op=op: eng.query_batch(needle_toks, op=op))
                for op in ("and", "or")}

    def stages(name, token_lists, op):
        """Host-clock split of one warm wave into the engine's stages."""
        t = [time.perf_counter()]
        fps_lists = [[_as_fp(x) for x in toks] for toks in token_lists]
        live = [i for i, f in enumerate(fps_lists) if f]
        t.append(time.perf_counter())
        fps, mask = eng._pack(fps_lists, live)
        t.append(time.perf_counter())
        bitmaps, counts = eng._evaluate(fps, mask, op)
        t.append(time.perf_counter())
        eng._extract(bitmaps, counts[:len(live)])
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        ms = [1e3 * (b - a) for a, b in zip(t, t[1:])]
        waves[name]["stages_ms"] = dict(zip(
            ("fingerprint", "pack", "probe_fold", "extract"), ms))
        print(f"wave {name} stages (host clock): fingerprint {ms[0]:.2f} ms, "
              f"pack {ms[1]:.2f} ms, probe+fold {ms[2]:.2f} ms, "
              f"extract {ms[3]:.2f} ms", flush=True)

    stages("term", [term_query_tokens(t) for t in terms], "and")
    stages("contains_and", needle_toks, "and")
    launches = {k: c.launch_count for k, c in counters.items()}
    # ------------------------------------------------------------ checks
    segs = store.segments
    print(f"store: {len(store.blobs)} batches, {len(segs)} segments "
          f"{[tuple(s.planes.shape) if s.planes is not None else None for s in segs]}"
          f", engine W={eng.words}, {eng.device_bytes()} bytes on the device, "
          f"uploads {eng.upload_count}, ingest+finish {ingest_s:.1f} s",
          flush=True)
    require(eng.upload_count == len(segs), "one upload per segment")
    require(all(s.planes is not None for s in segs),
            "every segment has bitmap planes at the default budget")
    t0 = time.perf_counter()
    for t, c in zip(terms, term_cands):
        require(np.array_equal(c, eng.host_query(term_query_tokens(t))),
                f"term wave differs from the host path on {t!r}")
    for op, got in contains.items():
        for toks, c in zip(needle_toks, got):
            require(np.array_equal(c, eng.host_query(toks, op=op)),
                    f"contains {op} wave differs from the host path")
    n_hit = sum(1 for c in term_cands[:len(present)] if len(c))
    require(n_hit == len(present), "a present id found no candidate")
    print(f"host-path check: {len(terms)} terms + 2 x {len(needles)} "
          f"needles identical, {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    scan = ScanStore(batch_lines=BATCH_LINES)
    scan.ingest(ds.lines)
    scan.finish()
    sample = present[:N_SCAN_SAMPLE - 2] + terms[-2:]
    for t, r in zip(sample, store.query_term_batch(sample)):
        truth = scan.query_term(t).matches
        require(r.matches == truth, f"scan oracle differs on {t!r}")
    print(f"scan-oracle check: {len(sample)} terms identical "
          f"({sum(len(scan.query_term(t).matches) for t in sample[:2])} "
          f"matches in the first two), {time.perf_counter() - t0:.1f} s",
          flush=True)
    return dict(launches=launches, waves=waves, ingest_s=ingest_s)


def main() -> int:
    try:
        import numpy as np
        import torch
    except ImportError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: the repro_torch package is not beside this "
              "script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels.bitmap_extract.ops import bitmap_extract
    from repro_torch.kernels.bitset_ops.ops import (bitset_reduce,
                                                    bitset_reduce_batch)
    from repro_torch.kernels.sketch_probe.ops import mphf_probe_arrs

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda")

    t0 = time.perf_counter()
    build.build()
    print(f"build: {len(build.SOURCES)} kernels in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    kernels = check_kernels(torch, np, dev)
    counters = {"sketch_probe": mphf_probe_arrs,
                "bitset_reduce_batch": bitset_reduce_batch,
                "bitset_reduce": bitset_reduce,
                "bitmap_extract": bitmap_extract}
    path = main_path(torch, np, counters)
    for name in ("sketch_probe", "bitset_reduce_batch", "bitmap_extract"):
        require(path["launches"][name] > 0,
                f"the main path never launched {name}")

    src = "src/repro_torch/kernels/csrc/"
    meta = {
        "sketch_probe": (src + "sketch_probe.cu",
                         "src/repro/kernels/sketch_probe/kernel.py:89"),
        "bitset_reduce_batch": (src + "bitset_ops.cu",
                                "src/repro/kernels/bitset_ops/kernel.py:52"),
        "bitset_reduce": (src + "bitset_ops.cu",
                          "src/repro/kernels/bitset_ops/kernel.py:81"),
        "bitmap_extract": (src + "bitmap_extract.cu",
                           "src/repro/kernels/bitmap_extract/kernel.py:54"),
    }
    rows = [dict(name=name, route="cuda", source=meta[name][0],
                 replaces=meta[name][1], launches=path["launches"][name],
                 max_abs_err=k["max_abs_err"], ms=k["ms"],
                 plain_ms=k["plain_ms"], bound_ms=k["bound_ms"],
                 bound_by="bytes", library_ms=None, shape=k["shape"])
            for name, k in kernels.items()]
    print(json.dumps(dict(card=card, ingest_s=path["ingest_s"],
                          waves=path["waves"])))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
