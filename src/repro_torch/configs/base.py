"""Config substrate: ArchSpec / ShapeSpec and the shape tables.

Every ported architecture registers an ArchSpec carrying its published
config, its shape set, a reduced smoke config and a ``smoke_batch`` that
makes a real small batch.  The JAX package's ``inputs`` functions (abstract
inputs for the dry run) are not ported.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str                    # train|prefill|decode|serve|retrieval
    dims: dict = field(default_factory=dict)
    n_microbatches: int = 1      # LM train grad-accumulation
    decode_policy: str = "batch"  # 'batch' | 'seq': cache sharding axis
    skip: str | None = None      # reason string if the cell is skipped


@dataclass(frozen=True)
class ArchSpec:
    id: str
    family: str                  # lm|gnn|recsys
    source: str                  # citation tag
    config: Any                  # family config dataclass (full size)
    shapes: dict                 # name -> ShapeSpec
    smoke_config: Any            # reduced config, CPU-runnable
    optimizer: str = "adamw"
    grad_accum_dtype: str = "float32"
    fsdp: bool = False
    notes: str = ""
    smoke_batch: Callable = None  # (config, numpy rng, device) -> batch

    def shape(self, name: str) -> ShapeSpec:
        return self.shapes[name]


LM_SHAPES = dict(
    train_4k=dict(seq=4096, batch=256),
    prefill_32k=dict(seq=32768, batch=32),
    decode_32k=dict(seq=32768, batch=128),
    long_500k=dict(seq=524288, batch=1),
)


def lm_shapes(*, n_micro: dict | None = None, skip_long: str | None = None):
    n_micro = n_micro or {}
    return {
        "train_4k": ShapeSpec("train_4k", "train", LM_SHAPES["train_4k"],
                              n_microbatches=n_micro.get("train_4k", 4)),
        "prefill_32k": ShapeSpec("prefill_32k", "prefill",
                                 LM_SHAPES["prefill_32k"]),
        "decode_32k": ShapeSpec("decode_32k", "decode",
                                LM_SHAPES["decode_32k"],
                                decode_policy="batch"),
        "long_500k": ShapeSpec("long_500k", "decode",
                               LM_SHAPES["long_500k"],
                               decode_policy="seq", skip=skip_long),
    }


RECSYS_SHAPES = dict(
    train_batch=dict(batch=65536),
    serve_p99=dict(batch=512),
    serve_bulk=dict(batch=262144),
    retrieval_cand=dict(batch=1, n_candidates=1_048_576),  # 1M padded /512
)


def recsys_shapes():
    return {name: ShapeSpec(name, kind, RECSYS_SHAPES[name])
            for name, kind in (("train_batch", "train"),
                               ("serve_p99", "serve"),
                               ("serve_bulk", "serve"),
                               ("retrieval_cand", "retrieval"))}
