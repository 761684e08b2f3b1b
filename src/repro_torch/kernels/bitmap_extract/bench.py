"""Time the query wave's fold and extraction kernels (``bitset_ops`` and
``bitmap_extract``) at the 1M-line store's two wave shapes, with
``chip_smoke.device_ms``, for the ``repro_torch`` package under ``--src``:
this checkout's by default, or another checkout's, so that two designs can
be timed in turns on one card (old, new, new, old).

    python src/repro_torch/kernels/bitmap_extract/bench.py [--src DIR]
        [--cu FILE ...] [--rounds N] [--waves]

The waves, at W 62 (the 1,954 batches of ``chip_smoke.py``'s segmented
store), as ``chip_smoke.py`` phase 4 launches them: the term wave, 4096
queries of one token (Qb 4096, Tb 1), and a contains wave, 1024 queries
of 3..8 tokens (Qb 1024, Tb 8).  Plane words are random (the fold's work
does not depend on them).  The combined bitmaps hold each query's answer
at the sizes phase 4 measured (``WAVES``: the share of queries with an
answer, their mean and largest answer, in batches), set at random: bits
spread over every word, unlike the path's own answers, which ``--waves``
takes; a third wave of 1024 queries, half of them matching every batch,
half none, holds the extraction to full rows.

Contenders, where the package has them, each held to its package's plain
version first:
  * fold: the ragged entry (each live row over its own tokens), the (Q, T,
    W) entry alone on planes whose pad slots hold the neutral word, and the
    chain the engine ran before the ragged entry (``torch.where`` of the
    pad slots, then the (Q, T, W) entry);
  * extraction: the ragged entry (one array of the answer's size) and the
    padded entry at the (Qb, max_hits) the engine launched before it
    (max_hits the next power of two over the largest answer, at least 8).
    ``--cu`` adds other sources of the ragged extraction with this
    checkout's C interface (``bitmap_extract_ragged_launch``), built with
    the package's nvcc flags.

With ``--waves`` the bench first runs ``chip_smoke.py``'s main path (the
1M-line store; a few minutes) and, in place of the synthetic waves, times
the extraction contenders on the bitmaps and offsets that path's term,
contains AND and contains OR waves gave the extraction (``record``), and
three ways to bring a wave's ids and counts to the host, each followed by
the int64 copy the engine makes: ``.cpu()`` (pageable memory), a copy into
one pinned buffer kept across calls, and the engine's ``_to_host`` (a
pinned buffer per call from PyTorch's caching host allocator).  Those are
host-clock medians of ``--copies`` calls, one per round.

Each contender is read warm (the same call repeated) and cold (the L2
flushed by a 100 MB write before each run, outside the events), in turns
(forward, then backward, ``--rounds`` times).  There is no PyTorch call
for either function.

Needs one CUDA card.  Prints the compiler's register counts, the card's
name and power limit, the launch floor (one empty launch), then one JSON
line per wave: each contender's warm and cold device ms in the order timed,
the bytes bound of each function (the fold: the planes each row folds, the
counts, the combined rows and popcounts; the ragged extraction: the
bitmaps, the offsets and the ids; the padded one: the bitmaps and the
(Qb, max_hits) matrix and counts), each moved once.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[4]
W = 62
# (name, Qb, Tb, fewest tokens, share of queries with an answer, their
# mean and largest answer in batches), as chip_smoke.py phase 4 reads them
# on the 1M-line store: the term wave answers 581,017 batches, at most 663
# a query, its absent half none; the contains wave 276,993, at most 666
WAVES = (("term", 4096, 1, 1, 0.5, 284.0, 663),
         ("contains", 1024, 8, 3, 1.0, 270.0, 666),
         ("full rows", 1024, 1, 1, 0.5, 32.0 * W, 32 * W))


def _contenders(torch, np, cs, mods, variants, dev, rng, wave):
    """Each contender's call and its plain version's, and the bounds."""
    fold_ops, fold_ref, ext_ops, ext_ref = mods
    name, qb, tb, lo, share, mean, largest = wave
    lens = rng.integers(lo, tb + 1, qb).astype(np.int32)
    lens[0] = tb
    acc = cs.u32_tensor(torch, np, rng.integers(0, 2**32, (qb, tb, W),
                                                dtype=np.uint64), dev)
    lens_dev = torch.from_numpy(lens).to(dev)
    mask = (torch.arange(tb, device=dev) < lens_dev[:, None])[:, :, None]
    padded = torch.where(mask, acc, -1)
    answers = np.minimum(rng.poisson(mean, qb), 32 * W)
    answers[rng.random(qb) >= share] = 0
    answers[0] = largest
    bits = rng.random((qb, 32 * W)) < (answers / (32 * W))[:, None]
    bm_np = np.packbits(bits.reshape(qb, W, 32), axis=-1,
                        bitorder="little").view(np.uint32).reshape(qb, W)
    bm = cs.u32_tensor(torch, np, bm_np, dev)
    counts = bits.sum(axis=1)
    ends = np.cumsum(counts)
    total = int(ends[-1])
    offsets = torch.from_numpy((ends - counts).astype(np.int32)).to(dev)
    max_hits = 1 << (max(int(counts.max()), 8) - 1).bit_length()
    fns = {}
    if hasattr(fold_ops, "bitset_reduce_ragged"):
        fns["fold, ragged entry"] = (
            lambda: fold_ops.bitset_reduce_ragged(acc, lens_dev, op="and"),
            lambda: fold_ref.bitset_reduce_ragged_ref(acc, lens_dev,
                                                      op="and"))
    fns["fold, (Q, T, W) entry"] = (
        lambda: fold_ops.bitset_reduce_batch(padded, op="and"),
        lambda: fold_ref.bitset_reduce_batch_ref(padded, op="and"))
    fns["fold, where + (Q, T, W) entry"] = (
        lambda: fold_ops.bitset_reduce_batch(torch.where(mask, acc, -1),
                                             op="and"),
        lambda: fold_ref.bitset_reduce_batch_ref(padded, op="and"))
    if hasattr(ext_ops, "bitmap_extract_ragged"):
        fns["extract, ragged entry"] = (
            lambda: (ext_ops.bitmap_extract_ragged(bm, offsets, total),),
            lambda: (ext_ref.bitmap_extract_ragged_ref(bm, offsets, total),))
    for file, (lib, fn) in variants.items():
        fns[f"extract, {file}"] = (
            lambda lib=lib, fn=fn: (_variant(torch, lib, fn, bm, offsets,
                                             total),),
            lambda: (ext_ref.bitmap_extract_ragged_ref(bm, offsets, total),))
    fns[f"extract, padded entry (max_hits {max_hits})"] = (
        lambda: ext_ops.bitmap_extract(bm, max_hits=max_hits),
        lambda: ext_ref.bitmap_extract_ref(bm, max_hits=max_hits))
    rate = cs.HBM_BYTES_PER_S / 1e3
    bounds = dict(
        fold=4 * (W * int(lens.sum()) + qb * (W + 2)) / rate,
        extract_ragged=(4 * qb * (W + 1) + 4 * total) / rate,
        extract_padded=4 * qb * (W + max_hits + 1) / rate)
    shape = dict(wave=name, qb=qb, tb=tb, w=W, tokens=int(lens.sum()),
                 answer_ids=total, largest_answer=int(counts.max()),
                 max_hits=max_hits)
    return fns, bounds, shape


def _recorded(torch, np, cs, mods, variants, query_engine, waves, flush,
              rounds, copies):
    """The extraction contenders and the host copies on the main path's
    recorded waves: one JSON line a wave."""
    fold_ops, _, ext_ops, ext_ref = mods
    for name, (bm, offsets, total) in waves["extracts"].items():
        acc, lens, op = waves["folds"][name]
        fns = {"extract, ragged entry": lambda: ext_ops.bitmap_extract_ragged(
            bm, offsets, total)}
        for file, (lib, fn) in variants.items():
            fns[f"extract, {file}"] = (
                lambda lib=lib, fn=fn: _variant(torch, lib, fn, bm, offsets,
                                                total))
        want = ext_ref.bitmap_extract_ragged_ref(bm, offsets, total)
        for label, fn in fns.items():
            if not torch.equal(fn(), want):
                raise RuntimeError(f"{label} differs from the plain version "
                                   f"on the {name} wave")
        warm, cold = ({label: [] for label in fns} for _ in range(2))
        labels = list(fns)
        for r in range(rounds):
            for label in (labels if r % 2 == 0 else labels[::-1]):
                warm[label].append(cs.device_ms(torch, fns[label]))
                cold[label].append(cs.device_ms(torch, fns[label], flush))
        ids = ext_ops.bitmap_extract_ragged(bm, offsets, total)
        counts = fold_ops.bitset_reduce_ragged(acc, lens, op=op)[1]
        kept = torch.empty(max(total, counts.numel()), dtype=torch.int32,
                           pin_memory=True)

        def one_buffer(t):
            out = kept[:t.numel()]
            out.copy_(t)
            return out.numpy()

        ways = {"pageable (.cpu())": lambda t: t.cpu().numpy(),
                "pinned, one buffer": one_buffer,
                "pinned, a buffer a call (engine)": query_engine._to_host}
        copy_ms = {f"{what} {way}": [] for what in ("ids", "counts")
                   for way in ways}
        for what, t in (("ids", ids), ("counts", counts)):
            for way, fn in ways.items():
                if not np.array_equal(fn(t), t.cpu().numpy()):
                    raise RuntimeError(f"{way} copied {what} wrongly")
            for r in range(rounds):
                order = list(ways) if r % 2 == 0 else list(ways)[::-1]
                for way in order:
                    copy_ms[f"{what} {way}"].append(1e-3 * cs.host_us(
                        torch, lambda fn=ways[way]: fn(t).astype(np.int64),
                        copies))
        print(json.dumps(dict(wave=name, q=bm.shape[0], w=bm.shape[1],
                              answer_ids=total, live=int(lens.numel()),
                              bound_ms=(4 * bm.numel() + 4 * offsets.numel()
                                        + 4 * total)
                              / (cs.HBM_BYTES_PER_S / 1e3),
                              warm_ms=warm, cold_ms=cold,
                              host_copy_ms=copy_ms)), flush=True)


def _variant(torch, lib, fn, bm, offsets, total):
    from repro_torch.kernels import build
    ids = torch.empty(total, dtype=torch.int32, device=bm.device)
    err = fn(bm.data_ptr(), bm.shape[0], bm.shape[1], offsets.data_ptr(),
             total, ids.data_ptr(), build.stream_of(bm))
    build.check(lib, err, "bitmap_extract variant")
    return ids


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the directory that holds the repro_torch package")
    ap.add_argument("--cu", action="append", default=[], type=Path,
                    help="another source of the ragged extraction")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--waves", action="store_true",
                    help="time on the main path's recorded waves")
    ap.add_argument("--copies", type=int, default=200,
                    help="host copies a reading (with --waves)")
    args = ap.parse_args()
    sys.path[0] = str(Path(args.src).resolve())   # not this file's folder
    sys.path.insert(1, str(ROOT))
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.bitmap_extract import ops as ext_ops
    from repro_torch.kernels.bitmap_extract import ref as ext_ref
    from repro_torch.kernels.bitset_ops import ops as fold_ops
    from repro_torch.kernels.bitset_ops import ref as fold_ref
    if not torch.cuda.is_available():
        print("bench: needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda")
    logs = build.build(build.SOURCES if args.waves
                       else ("bitset_ops", "bitmap_extract"),
                       ptxas_verbose=True)
    for name, log in logs.items():
        cs.print_registers(name, log)
    variants = {}
    p, i = ctypes.c_void_p, ctypes.c_int
    for name, (lib, log) in (build.build_variants(args.cu) if args.cu
                             else {}).items():
        cs.print_registers(name, log)
        variants[name] = (lib, build.declare(
            lib, "bitmap_extract_ragged_launch", p, i, i, p, i, p, p))
    floor = cs.launch_floor_ms(torch)
    flush = cs.l2_flush(torch, dev)
    print(f"launch floor: {floor:.4f} ms", flush=True)

    mods = (fold_ops, fold_ref, ext_ops, ext_ref)
    if args.waves:
        from repro_torch.core import query_engine
        seg = cs.main_path(torch, np, dev, cs.launch_counters())
        _recorded(torch, np, cs, mods, variants, query_engine,
                  dict(extracts=seg["wave_extracts"],
                       folds=seg["wave_folds"]), flush, args.rounds,
                  args.copies)
        return 0
    rng = np.random.default_rng(cs.SEED)
    for wave in WAVES:
        fns, bounds, shape = _contenders(torch, np, cs, mods, variants, dev,
                                         rng, wave)
        for name, (fn, plain) in fns.items():
            got, want = fn(), plain()
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise RuntimeError(f"{name} differs from its plain version "
                                   f"on the {wave[0]} wave")
        names = list(fns)
        warm, cold = ({name: [] for name in fns} for _ in range(2))
        for r in range(args.rounds):
            for name in (names if r % 2 == 0 else names[::-1]):
                warm[name].append(cs.device_ms(torch, fns[name][0]))
                cold[name].append(cs.device_ms(torch, fns[name][0], flush))
        print(json.dumps(dict(card=card, src=args.src, **shape,
                              launch_floor_ms=floor, bound_ms=bounds,
                              warm_ms=warm, cold_ms=cold)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
