"""RecSys model family, the serving paths of xDeepFM and two-tower retrieval.

Tables are one concatenated (sum_vocab, D) matrix with per-field row
offsets, as in the JAX package.  Two hand-written kernels carry the device
work of these paths: xDeepFM's wide term is an ``embedding_bag_sum`` with
D = 1, and two-tower retrieval scores the 1M-row corpus with
``retrieval_scores``; on CPU tensors both take their plain versions.  The
CIN, the towers' MLPs and the field lookups stay plain torch.  SASRec, MIND
and the training losses are not yet ported.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..kernels.embedding_bag.ops import embedding_bag_sum
from ..kernels.retrieval_score.ops import retrieval_scores
from .layers import mlp_apply, mlp_init, normal, torch_dtype


# ------------------------------------------------------------ embedding ops
def embedding_bag(table: torch.Tensor, idx: torch.Tensor, *, mask=None,
                  mode: str = "sum") -> torch.Tensor:
    """table (V, D); idx (..., bag); mask (..., bag) or None.  Fixed-size
    bag gather + masked reduce (the plain version)."""
    e = table[idx]                                       # (..., bag, D)
    if mask is not None:
        e = e * mask[..., None].to(e.dtype)
    if mode == "sum":
        return e.sum(-2)
    if mode == "mean":
        den = (mask.sum(-1, keepdim=True).to(e.dtype) if mask is not None
               else torch.tensor(float(idx.shape[-1]), device=e.device))
        return e.sum(-2) / den.clamp_min(1.0)
    raise ValueError(mode)


def _field_offsets(vocab_sizes, device=None) -> torch.Tensor:
    """(n_fields,) int32 first row of each field in the concatenated table."""
    off = [0]
    for v in vocab_sizes[:-1]:
        off.append(off[-1] + v)
    return torch.tensor(off, dtype=torch.int32, device=device)


# ----------------------------------------------------------------- xDeepFM
@dataclass(frozen=True)
class XDeepFMConfig:
    name: str = "xdeepfm"
    n_sparse: int = 39
    vocab_per_field: int = 1_000_000
    embed_dim: int = 10
    cin_layers: tuple = (200, 200, 200)
    mlp_sizes: tuple = (400, 400)
    dtype: str = "float32"

    @property
    def total_vocab(self) -> int:
        return self.n_sparse * self.vocab_per_field

    def param_count(self) -> int:
        n = self.total_vocab * (self.embed_dim + 1)   # embed + wide
        m = self.n_sparse
        h_prev = m
        for h in self.cin_layers:
            n += h_prev * m * h
            h_prev = h
        sizes = [m * self.embed_dim] + list(self.mlp_sizes) + [1]
        n += sum(sizes[i] * sizes[i + 1] + sizes[i + 1]
                 for i in range(len(sizes) - 1))
        return n + sum(self.cin_layers) + 1


def xdeepfm_init(cfg: XDeepFMConfig, gen: torch.Generator) -> dict:
    dt, dev = torch_dtype(cfg.dtype), gen.device
    m, d = cfg.n_sparse, cfg.embed_dim
    cin, h_prev = [], m
    for h in cfg.cin_layers:
        cin.append(normal(gen, (h_prev * m, h), (h_prev * m) ** -0.5, dt))
        h_prev = h
    return {
        "table": normal(gen, (cfg.total_vocab, d), 0.01, dt),
        "wide": torch.zeros(cfg.total_vocab, dtype=dt, device=dev),
        "cin": cin,
        "cin_out": torch.zeros(sum(cfg.cin_layers), dtype=dt, device=dev),
        "dnn": mlp_init(gen, [m * d] + list(cfg.mlp_sizes) + [1]),
        "bias": torch.zeros((), dtype=dt, device=dev),
    }


def xdeepfm_logits(cfg: XDeepFMConfig, params: dict, idx: torch.Tensor
                   ) -> torch.Tensor:
    """idx (B, n_sparse) int32 field-local ids -> (B,) logits.  The wide term
    is the D = 1 bag sum of the 39 fields' weights (``embedding_bag_sum``)."""
    abs_idx = (idx.to(torch.int32) + _field_offsets(
        [cfg.vocab_per_field] * cfg.n_sparse, idx.device)[None, :]).contiguous()
    e = params["table"][abs_idx]                              # (B, m, D)
    wide = embedding_bag_sum(params["wide"][:, None], abs_idx)[:, 0]
    # CIN (compressed interaction network)
    x0, xk, pooled = e, e, []
    for w in params["cin"]:
        z = torch.einsum("bhd,bmd->bhmd", xk, x0)
        b, h, m, d = z.shape
        xk = torch.einsum("bpd,ph->bhd", z.reshape(b, h * m, d), w)
        pooled.append(xk.sum(-1))                             # (B, H_k)
    cin_out = torch.cat(pooled, -1) @ params["cin_out"]
    dnn_out = mlp_apply(params["dnn"], e.reshape(e.shape[0], -1))[..., 0]
    return wide + cin_out + dnn_out + params["bias"]


def xdeepfm_retrieval(cfg: XDeepFMConfig, params: dict, batch: dict
                      ) -> torch.Tensor:
    """Score n_candidates items for ONE user context: the candidate id
    replaces field 0, the other fields broadcast."""
    cand = batch["cand"]
    idx = batch["idx"].expand(cand.shape[0], cfg.n_sparse).clone()
    idx[:, 0] = cand
    return xdeepfm_logits(cfg, params, idx)


# ---------------------------------------------------------------- twotower
@dataclass(frozen=True)
class TwoTowerConfig:
    name: str = "two-tower-retrieval"
    embed_dim: int = 256
    tower_mlp: tuple = (1024, 512, 256)
    n_user_fields: int = 8
    n_item_fields: int = 4
    field_vocab: int = 1_000_000
    field_dim: int = 64
    n_corpus: int = 1_000_000
    temperature: float = 0.05
    dtype: str = "float32"

    def param_count(self) -> int:
        n = (self.n_user_fields + self.n_item_fields) * self.field_vocab \
            * self.field_dim
        for nf in (self.n_user_fields, self.n_item_fields):
            sizes = [nf * self.field_dim] + list(self.tower_mlp)
            n += sum(sizes[i] * sizes[i + 1] + sizes[i + 1]
                     for i in range(len(sizes) - 1))
        return n + self.n_corpus * self.tower_mlp[-1]


def twotower_init(cfg: TwoTowerConfig, gen: torch.Generator) -> dict:
    dt = torch_dtype(cfg.dtype)

    def table(fields):
        return normal(gen, (fields * cfg.field_vocab, cfg.field_dim), 0.02, dt)

    return {
        "user_table": table(cfg.n_user_fields),
        "item_table": table(cfg.n_item_fields),
        "user_mlp": mlp_init(gen, [cfg.n_user_fields * cfg.field_dim]
                             + list(cfg.tower_mlp)),
        "item_mlp": mlp_init(gen, [cfg.n_item_fields * cfg.field_dim]
                             + list(cfg.tower_mlp)),
        # serving-side precomputed corpus (item embeddings)
        "corpus": normal(gen, (cfg.n_corpus, cfg.tower_mlp[-1]), 0.05, dt),
    }


def _tower(mlp: dict, table: torch.Tensor, offsets: torch.Tensor,
           idx: torch.Tensor) -> torch.Tensor:
    e = table[idx + offsets[None, :]]
    z = mlp_apply(mlp, e.reshape(e.shape[0], -1))
    return z / torch.linalg.vector_norm(z.to(torch.float32), dim=-1,
                                        keepdim=True).clamp_min(1e-6).to(z.dtype)


def _user(cfg: TwoTowerConfig, params: dict, user_idx: torch.Tensor):
    return _tower(params["user_mlp"], params["user_table"],
                  _field_offsets([cfg.field_vocab] * cfg.n_user_fields,
                                 user_idx.device), user_idx)


def twotower_embed(cfg: TwoTowerConfig, params: dict, batch: dict):
    i = _tower(params["item_mlp"], params["item_table"],
               _field_offsets([cfg.field_vocab] * cfg.n_item_fields,
                              batch["item_idx"].device), batch["item_idx"])
    return _user(cfg, params, batch["user_idx"]), i


def twotower_serve(cfg: TwoTowerConfig, params: dict, batch: dict):
    u, i = twotower_embed(cfg, params, batch)
    return (u * i).sum(-1)


def twotower_retrieval(cfg: TwoTowerConfig, params: dict, batch: dict):
    """One user query against the precomputed corpus: (C,) scores from the
    ``retrieval_scores`` GEMV."""
    u = _user(cfg, params, batch["user_idx"])                 # (1, D)
    return retrieval_scores(params["corpus"], u[0].contiguous())
