"""Single flat-file serialization of the immutable sketch (§4.2).

Layout: magic | header_len u32 | header JSON | 64-byte-aligned raw buffers.
The header holds every array's (dtype, shape, offset); opening a reader
parses only the header — the paper's "single disk page to open" property.
``load(mmap=True)`` maps buffers lazily via np.memmap.

Format 2 (durable segment store) extends the file into the full segment
record the manifest-based store needs:
  * plane presence is EXPLICIT: ``meta.has_planes`` plus the exact
    ``(rows, words)`` geometry live in the header, and load() errors when
    the header and the array entries disagree (or when the caller's
    ``expect_planes`` contradicts the file) — no silently plane-less
    reopened engines.
  * ``stats`` round-trips exactly (numpy scalars are coerced to the JSON
    scalar they mean, so ``loaded.stats == saved.stats``).
  * the retained ``sealed_source`` posting columns (fps / list_ids /
    flattened lists + offsets / refcounts) ride along under ``src.*`` so
    cold-segment merges work straight from the memmapped file.
  * ``fsync=True`` makes the tmp+``os.replace`` publish durable (file and
    directory fsync) — the store's fault-tolerance primitive.
"""
from __future__ import annotations

import json
import os

import numpy as np

from .csf import CompressedStaticFunction
from .faults import fault_point
from .immutable_sketch import ImmutableSketch
from .mphf import MPHF

MAGIC = b"DWRP0001"
ALIGN = 64
FORMAT = 2

_MPHF_FIELDS = ["words", "level_word_offset", "level_bits", "block_rank",
                "fallback_fps", "fallback_idx"]
_CSF_FIELDS = ["bitseq", "lengths", "samples"]
_TOP_FIELDS = ["signatures", "bic_bits", "bic_offsets", "bic_counts"]
_SRC_FIELDS = ["fps", "list_ids", "lists_flat", "list_offsets", "refcounts"]


def _jsonable(obj):
    """Coerce numpy scalars (and containers of them) to plain JSON types so
    ``stats`` round-trips exactly through the header."""
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if isinstance(obj, np.bool_):
        return bool(obj)
    return obj


def fsync_dir(path: str) -> None:
    """fsync a directory so a just-published rename survives power loss."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def save(sketch: ImmutableSketch, path: str, *,
         include_planes: bool | None = None,
         include_source: bool | None = None,
         fsync: bool = False) -> int:
    """Write ``sketch`` as one flat segment file, published atomically.

    ``include_planes``/``include_source``: ``None`` means "whatever the
    sketch has"; ``True`` errors if the sketch lacks the component (plane
    presence must be explicit, never silently dropped)."""
    if include_planes is None:
        include_planes = sketch.planes is not None
    elif include_planes and sketch.planes is None:
        raise ValueError("include_planes=True but sketch has no bitmap "
                         "planes")
    if include_source is None:
        include_source = sketch.sealed_source is not None
    elif include_source and sketch.sealed_source is None:
        raise ValueError("include_source=True but sketch has no retained "
                         "sealed_source")

    arrays: dict[str, np.ndarray] = {}
    for f in _MPHF_FIELDS:
        arrays[f"mphf.{f}"] = np.ascontiguousarray(getattr(sketch.mphf, f))
    for f in _CSF_FIELDS:
        arrays[f"csf.{f}"] = np.ascontiguousarray(getattr(sketch.csf, f))
    for f in _TOP_FIELDS:
        arrays[f] = np.ascontiguousarray(getattr(sketch, f))
    if include_planes:
        arrays["planes"] = np.ascontiguousarray(sketch.planes)

    meta = dict(format=FORMAT, sig_bits=sketch.sig_bits,
                n_postings=sketch.n_postings, n_tokens=sketch.n_tokens,
                mphf_n_keys=sketch.mphf.n_keys,
                mphf_n_rank_bits=sketch.mphf.n_rank_bits,
                csf_n=sketch.csf.n, stats=_jsonable(sketch.stats),
                has_planes=bool(include_planes), has_source=False)
    if include_planes:
        meta["plane_rows"] = int(sketch.planes.shape[0])
        meta["plane_words"] = int(sketch.planes.shape[1])

    if include_source:
        from .segment import sealed_arrays
        src = sketch.sealed_source
        for name, arr in sealed_arrays(src).items():
            arrays[f"src.{name}"] = np.ascontiguousarray(arr)
        meta["has_source"] = True
        meta["src_n_postings"] = int(src.n_postings)
        meta["src_stats"] = _jsonable(src.stats)

    entries = {}
    offset = 0
    blobs = []
    for name, arr in arrays.items():
        offset = (offset + ALIGN - 1) // ALIGN * ALIGN
        entries[name] = dict(dtype=str(arr.dtype), shape=list(arr.shape),
                             offset=offset, nbytes=arr.nbytes)
        blobs.append((offset, arr))
        offset += arr.nbytes
    header = json.dumps(dict(meta=meta, arrays=entries)).encode()

    fault_point("segment.write")
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(MAGIC)
        f.write(np.uint32(len(header)).tobytes())
        f.write(header)
        base = f.tell()
        base_aligned = (base + ALIGN - 1) // ALIGN * ALIGN
        f.write(b"\0" * (base_aligned - base))
        pos = 0
        for off, arr in blobs:
            f.write(b"\0" * (off - pos))
            f.write(arr.tobytes())
            pos = off + arr.nbytes
        if fsync:
            f.flush()
            os.fsync(f.fileno())
    fault_point("segment.publish")
    os.replace(tmp, path)  # atomic publish (fault-tolerance contract)
    if fsync:
        fsync_dir(os.path.dirname(os.path.abspath(path)))
    return os.path.getsize(path)


def load(path: str, *, mmap: bool = True,
         expect_planes: bool | None = None,
         load_source: bool = True) -> ImmutableSketch:
    """Open a segment file by reading its header page; buffers are
    ``np.memmap``-backed when ``mmap=True`` (no full-file read).

    ``expect_planes``: ``True``/``False`` errors when the header's explicit
    plane presence disagrees with the caller's expectation; ``None`` accepts
    whatever the file declares.  Header-vs-payload mismatches (declared
    planes missing, undeclared planes present, or geometry drift) always
    error — corrupt files must not open as silently degraded sketches."""
    with open(path, "rb") as f:
        if f.read(8) != MAGIC:
            raise ValueError(f"{path}: bad magic")
        hlen = int(np.frombuffer(f.read(4), np.uint32)[0])
        header = json.loads(f.read(hlen))
        base = f.tell()
    base_aligned = (base + ALIGN - 1) // ALIGN * ALIGN
    meta, entries = header["meta"], header["arrays"]

    # ------------------------------------------------- header consistency
    fmt = int(meta.get("format", 1))
    has_planes = (bool(meta["has_planes"]) if fmt >= 2
                  else "planes" in entries)
    if has_planes != ("planes" in entries):
        raise ValueError(
            f"{path}: header declares has_planes={has_planes} but the "
            f"plane array is {'missing' if has_planes else 'present'}")
    if expect_planes is not None and bool(expect_planes) != has_planes:
        raise ValueError(
            f"{path}: caller expects planes={bool(expect_planes)} but the "
            f"file was written with has_planes={has_planes}")
    if has_planes and fmt >= 2:
        got = tuple(entries["planes"]["shape"])
        want = (int(meta["plane_rows"]), int(meta["plane_words"]))
        if got != want:
            raise ValueError(f"{path}: plane geometry mismatch — header "
                             f"says {want}, array entry is {got}")

    def read_arr(name):
        if name not in entries:
            return None
        e = entries[name]
        dtype = np.dtype(e["dtype"])
        count = e["nbytes"] // dtype.itemsize
        if mmap:
            arr = np.memmap(path, dtype=dtype, mode="r",
                            offset=base_aligned + e["offset"], shape=(count,))
        else:
            with open(path, "rb") as f:
                f.seek(base_aligned + e["offset"])
                arr = np.frombuffer(f.read(e["nbytes"]), dtype=dtype).copy()
        return arr.reshape(e["shape"])

    mphf = MPHF(words=read_arr("mphf.words"),
                level_word_offset=read_arr("mphf.level_word_offset"),
                level_bits=read_arr("mphf.level_bits"),
                block_rank=read_arr("mphf.block_rank"),
                fallback_fps=read_arr("mphf.fallback_fps"),
                fallback_idx=read_arr("mphf.fallback_idx"),
                n_keys=meta["mphf_n_keys"],
                n_rank_bits=meta["mphf_n_rank_bits"])
    csf = CompressedStaticFunction(bitseq=read_arr("csf.bitseq"),
                                   lengths=read_arr("csf.lengths"),
                                   samples=read_arr("csf.samples"),
                                   n=meta["csf_n"])
    sketch = ImmutableSketch(
        mphf=mphf, csf=csf, signatures=read_arr("signatures"),
        sig_bits=meta["sig_bits"], bic_bits=read_arr("bic_bits"),
        bic_offsets=read_arr("bic_offsets"), bic_counts=read_arr("bic_counts"),
        n_postings=meta["n_postings"], n_tokens=meta["n_tokens"],
        planes=read_arr("planes"), stats=meta.get("stats", {}))

    if load_source and meta.get("has_source"):
        from .segment import sealed_from_arrays
        arrs = {name: read_arr(f"src.{name}") for name in _SRC_FIELDS}
        sketch.sealed_source = sealed_from_arrays(
            arrs, n_postings=meta["src_n_postings"],
            stats=meta.get("src_stats", {}))
    return sketch
