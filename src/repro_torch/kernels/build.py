"""Build and load the CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` compiles with nvcc into its own shared library with
a plain C interface, loaded with ctypes: no PyTorch headers, so a build
takes seconds.  The build happens at first use, into ``build/kernels/``
at the repository root, one nvcc process per source, all started together.
A library is named by a digest of its source and flags, so an edited
source builds anew and an unchanged one is reused.  One lock serializes
building and loading, so threads whose first launches come together
build each library once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("sketch_probe", "bitset_ops", "bitmap_extract", "token_hash",
           "csc_probe", "retrieval_score", "embedding_bag", "flash_decode")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_LIBS: dict[str, ctypes.CDLL] = {}
# held by build() and library(), which calls build(): hence reentrant
_BUILD_LOCK = threading.RLock()
_COUNT_LOCK = threading.Lock()


def _nvcc() -> str:
    return shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")


def _target(name: str) -> tuple[Path, Path]:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return src, BUILD_DIR / f"lib{name}-{digest}.so"


def build(names=SOURCES, *, ptxas_verbose: bool = False) -> dict[str, str]:
    """Compile every library of ``names`` that is not built yet (with
    ``ptxas_verbose``, every one: a library from an earlier build has no
    report), all nvcc processes at once.  Returns each compiled source's
    compiler output; raises with that output if any compile fails."""
    with _BUILD_LOCK:
        return _build(names, ptxas_verbose)


def _build(names, ptxas_verbose: bool) -> dict[str, str]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in names:
        src, out = _target(name)
        if out.exists() and not ptxas_verbose:
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        if ptxas_verbose:
            cmd[1:1] = ["-Xptxas", "-v"]
        jobs.append((name, tmp, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = {}, []
    for name, tmp, out, proc in jobs:
        logs[name] = proc.communicate()[0]
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            failed.append(name)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def build_variants(srcs) -> dict[str, tuple[ctypes.CDLL, str]]:
    """Compile other sources of a kernel (the bench scripts' ``--cu``)
    with the package's flags and ``-Xptxas -v``, all nvcc processes at
    once, into ``BUILD_DIR``; returns each source's loaded library and the
    compiler's output, by file name."""
    flags = (*NVCC_FLAGS, "-Xptxas", "-v")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for src in map(Path, srcs):
        digest = hashlib.sha256(
            src.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
        out = BUILD_DIR / f"variant-{src.stem}-{digest}.so"
        jobs.append((src, out, subprocess.Popen(
            [_nvcc(), *flags, "-o", str(out), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    built = {}
    for src, out, proc in jobs:
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {src}:\n{log}")
        lib = ctypes.CDLL(str(out))
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        built[src.name] = (lib, log)
    return built


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building every missing
    library first."""
    with _BUILD_LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build()
            lib = ctypes.CDLL(str(_target(name)[1]))
            lib.kernel_error_string.argtypes = [ctypes.c_int]
            lib.kernel_error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
        return lib


def count_launch(fn) -> None:
    """Add one to the wrapper ``fn``'s ``launch_count``.  The increment is
    a read-modify-write, so a lock keeps the count exact when threads
    launch at once."""
    with _COUNT_LOCK:
        fn.launch_count += 1


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err:
        raise RuntimeError(f"{what}: CUDA error {err} "
                           f"({lib.kernel_error_string(err).decode()})")


def stream_of(t) -> int:
    """The handle of PyTorch's current stream on ``t``'s device."""
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream


def declare(lib: ctypes.CDLL, fn: str, *argtypes):
    """``lib.fn`` with its argument types set and an int result."""
    f = getattr(lib, fn)
    f.argtypes = list(argtypes)
    f.restype = ctypes.c_int
    return f
