"""Carry sketch state across packages as plain numpy arrays and ints.

:func:`sketch_arrays` flattens any object shaped like an
:class:`ImmutableSketch` (``.mphf``, ``.csf``, ``.signatures``, ``.bic_*``,
``.planes``; the JAX package's sketches have the same fields) into a dict
of numpy arrays and ints; :func:`sketch_from_arrays` rebuilds the port's
:class:`ImmutableSketch` from such a dict.  A sketch built by another
package thus answers queries here without this package importing it.
"""
from __future__ import annotations

import numpy as np

from .csf import CompressedStaticFunction
from .immutable_sketch import ImmutableSketch
from .mphf import MPHF
from .segment import sealed_arrays, sealed_from_arrays

_MPHF_ARRAYS = {"words": np.uint32, "level_word_offset": np.int32,
                "level_bits": np.int32, "block_rank": np.uint32,
                "fallback_fps": np.uint32, "fallback_idx": np.int64}
_CSF_ARRAYS = {"bitseq": np.uint32, "lengths": np.uint32,
               "samples": np.int64}


def sketch_arrays(sk) -> dict:
    """Every field of sketch ``sk`` as numpy arrays / ints under flat keys
    (``mphf.words``, ``csf.bitseq``, ``signatures``, ``sealed.fps``, ...)."""
    d = {f"mphf.{k}": np.asarray(getattr(sk.mphf, k), t)
         for k, t in _MPHF_ARRAYS.items()}
    d["mphf.n_keys"] = int(sk.mphf.n_keys)
    d["mphf.n_rank_bits"] = int(sk.mphf.n_rank_bits)
    d.update({f"csf.{k}": np.asarray(getattr(sk.csf, k), t)
              for k, t in _CSF_ARRAYS.items()})
    d["csf.n"] = int(sk.csf.n)
    d["signatures"] = np.asarray(sk.signatures, np.uint32)
    d["sig_bits"] = int(sk.sig_bits)
    d["bic_bits"] = np.asarray(sk.bic_bits, np.uint32)
    d["bic_offsets"] = np.asarray(sk.bic_offsets, np.int64)
    d["bic_counts"] = np.asarray(sk.bic_counts, np.int64)
    d["n_postings"] = int(sk.n_postings)
    d["n_tokens"] = int(sk.n_tokens)
    if sk.planes is not None:
        d["planes"] = np.asarray(sk.planes, np.uint32)
    if getattr(sk, "sealed_source", None) is not None:
        d.update({f"sealed.{k}": v
                  for k, v in sealed_arrays(sk.sealed_source).items()})
        d["sealed.n_postings"] = int(sk.sealed_source.n_postings)
    return d


def sketch_from_arrays(d: dict) -> ImmutableSketch:
    """The port's :class:`ImmutableSketch` from a :func:`sketch_arrays`
    dict (arrays are copied with the dtypes the port's probes expect)."""
    mphf = MPHF(**{k: np.array(d[f"mphf.{k}"], t)
                   for k, t in _MPHF_ARRAYS.items()},
                n_keys=int(d["mphf.n_keys"]),
                n_rank_bits=int(d["mphf.n_rank_bits"]))
    csf = CompressedStaticFunction(
        **{k: np.array(d[f"csf.{k}"], t) for k, t in _CSF_ARRAYS.items()},
        n=int(d["csf.n"]))
    sealed = None
    if "sealed.fps" in d:
        sealed = sealed_from_arrays(
            {k[len("sealed."):]: np.array(v) for k, v in d.items()
             if k.startswith("sealed.") and k != "sealed.n_postings"},
            n_postings=int(d["sealed.n_postings"]))
    planes = d.get("planes")
    return ImmutableSketch(
        mphf=mphf, csf=csf,
        signatures=np.array(d["signatures"], np.uint32),
        sig_bits=int(d["sig_bits"]),
        bic_bits=np.array(d["bic_bits"], np.uint32),
        bic_offsets=np.array(d["bic_offsets"], np.int64),
        bic_counts=np.array(d["bic_counts"], np.int64),
        n_postings=int(d["n_postings"]), n_tokens=int(d["n_tokens"]),
        planes=None if planes is None else np.array(planes, np.uint32),
        sealed_source=sealed)
