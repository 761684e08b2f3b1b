"""Config substrate: ArchSpec / ShapeSpec, the shape tables and the
``inputs`` contract.

Every architecture registers an ArchSpec carrying its published config,
its shape set (each cell of the dry-run matrix), a reduced smoke config, a
``smoke_batch`` that makes a real small batch and ``inputs(config, shape)``:
a tree of ``TensorSpec`` stand-ins (shape and dtype, nothing allocated)
for every input of the cell's step, which the dry run (``launch/dryrun.py``)
traces.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable

import torch

from ..models.layers import torch_dtype


@dataclass(frozen=True)
class TensorSpec:
    """A tensor's shape and dtype, with nothing allocated (the JAX
    package's ``ShapeDtypeStruct``)."""
    shape: tuple
    dtype: torch.dtype


def sds(shape, dtype) -> TensorSpec:
    """A ``TensorSpec``; ``dtype`` a torch dtype or its name
    ("int32", "float32", "bfloat16")."""
    if isinstance(dtype, str):
        dtype = torch.int32 if dtype == "int32" else torch_dtype(dtype)
    return TensorSpec(tuple(int(x) for x in shape), dtype)


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
    inputs: Callable = None      # (config, ShapeSpec) -> TensorSpec tree
    smoke_batch: Callable = None  # (config, numpy rng, device) -> batch

    def shape(self, name: str) -> ShapeSpec:
        return self.shapes[name]

    def cells(self):
        """All (arch, shape) dry-run cells, skipped ones included."""
        return [(self.id, s) for s in self.shapes]


def pad_to(n: int, mult: int) -> int:
    return -(-n // mult) * mult


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


def lm_input_specs(cfg, shape: ShapeSpec):
    b, s = shape.dims["batch"], shape.dims["seq"]
    if shape.kind == "train":
        return {"tokens": sds((b, s), "int32"),
                "labels": sds((b, s), "int32"),
                "mask": sds((b, s), "float32")}
    if shape.kind == "prefill":
        return {"tokens": sds((b, s), "int32")}
    if shape.kind == "decode":
        cache_shape = (cfg.n_layers, b, s, cfg.n_kv_heads, cfg.head_dim)
        return {"cache": {"k": sds(cache_shape, cfg.dtype),
                          "v": sds(cache_shape, cfg.dtype)},
                "tokens": sds((b,), "int32")}
    raise ValueError(shape.kind)


def gnn_input_specs(cfg, shape: ShapeSpec):
    d = shape.dims
    n, e = d["n_nodes"], d["n_edges"]
    return {"nodes": sds((n, d["d_feat"]), cfg.dtype),
            "edges": sds((e, cfg.d_edge_in), cfg.dtype),
            "senders": sds((e,), "int32"),
            "receivers": sds((e,), "int32"),
            "edge_mask": sds((e,), cfg.dtype),
            "node_mask": sds((n,), cfg.dtype),
            "targets": sds((n, cfg.d_out), cfg.dtype)}


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
