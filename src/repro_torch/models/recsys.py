"""RecSys model family, the serving paths of xDeepFM, SASRec, MIND and
two-tower retrieval.

Tables are one concatenated (sum_vocab, D) matrix with per-field row
offsets, as in the JAX package.  Two hand-written kernels carry the device
work of these paths: xDeepFM's wide term is an ``embedding_bag_sum`` with
D = 1, and two-tower retrieval scores the 1M-row corpus with
``retrieval_scores``; on CPU tensors both take their plain versions.  The
CIN, the towers' MLPs, the field lookups, SASRec and MIND stay plain torch,
as in the JAX package, where they reach no Pallas kernel (SASRec and MIND
retrieval score with a plain product).  Item id 0 is padding.  Each arch
has its training loss (``xdeepfm_loss``, ``sasrec_loss``, ``mind_loss``,
``twotower_loss``), which returns (loss, logits) as the JAX package's do;
``embedding_bag_sum`` is differentiable, its backward a kernel of its own
on the card.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..kernels.embedding_bag.ops import embedding_bag_sum
from ..kernels.retrieval_score.ops import retrieval_scores
from .layers import (at_least_f32, is_dtensor, mlp_apply, mlp_init, normal,
                     replicated_like, rms_norm, rows, torch_dtype)


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


def embedding_bag_ragged(table: torch.Tensor, indices: torch.Tensor,
                         segment_ids: torch.Tensor, n_bags: int
                         ) -> torch.Tensor:
    """Ragged bag sums: indices (nnz,), segment_ids (nnz,) sorted bag ids
    -> (n_bags, D); an empty bag is zero."""
    return torch.zeros(n_bags, table.shape[1], dtype=table.dtype,
                       device=table.device).index_add_(
        0, segment_ids.long(), table[indices.long()])


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
    abs_idx = (idx.to(torch.int32) + replicated_like(_field_offsets(
        [cfg.vocab_per_field] * cfg.n_sparse, idx.device), idx)[None, :]
    ).contiguous()
    e = rows(params["table"], abs_idx)                        # (B, m, D)
    if is_dtensor(abs_idx):    # the kernel's plain version, on DTensors
        wide = rows(params["wide"][:, None], abs_idx).sum(-2)[:, 0]
    else:
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


def xdeepfm_loss(cfg: XDeepFMConfig, params: dict, batch: dict):
    """batch: idx (B, n_sparse), label (B,) in {0, 1} -> (mean binary
    cross-entropy in the stable form max(x, 0) - x y + log1p(exp(-|x|)),
    f32 logits)."""
    logits = xdeepfm_logits(cfg, params, batch["idx"]).to(torch.float32)
    y = batch["label"].to(torch.float32)
    loss = (torch.clamp_min(logits, 0) - logits * y
            + torch.log1p(torch.exp(-logits.abs()))).mean()
    return loss, logits


def xdeepfm_retrieval(cfg: XDeepFMConfig, params: dict, batch: dict
                      ) -> torch.Tensor:
    """Score n_candidates items for ONE user context: the candidate id
    replaces field 0, the other fields broadcast.  The rows are built
    around ``cand`` (a concatenation), so that a DTensor ``cand`` split
    over the mesh keeps its split through the model."""
    cand = batch["cand"]
    ctx = batch["idx"][:, 1:].expand(cand.shape[0], cfg.n_sparse - 1)
    if is_dtensor(cand):
        ctx = ctx.redistribute(cand.device_mesh, cand.placements)
    return xdeepfm_logits(cfg, params,
                          torch.cat([cand[:, None].to(ctx.dtype), ctx], 1))


# ------------------------------------------------------------------ SASRec
@dataclass(frozen=True)
class SASRecConfig:
    name: str = "sasrec"
    n_items: int = 1_000_000
    embed_dim: int = 50
    n_blocks: int = 2
    n_heads: int = 1
    seq_len: int = 50
    dtype: str = "float32"

    def param_count(self) -> int:
        d = self.embed_dim
        per_block = 4 * d * d + 2 * (d * d + d) + 2 * d
        return (self.n_items + self.seq_len) * d \
            + self.n_blocks * per_block + d


def sasrec_init(cfg: SASRecConfig, gen: torch.Generator) -> dict:
    dt, dev = torch_dtype(cfg.dtype), gen.device
    d = cfg.embed_dim

    def zeros():
        return torch.zeros(d, dtype=dt, device=dev)

    def w():
        return normal(gen, (d, d), d ** -0.5, dt)

    blocks = [{"wq": w(), "wk": w(), "wv": w(), "wo": w(),
               "ffn_w1": w(), "ffn_b1": zeros(), "ffn_w2": w(),
               "ffn_b2": zeros(), "ln1": zeros(), "ln2": zeros()}
              for _ in range(cfg.n_blocks)]
    return {"item_emb": normal(gen, (cfg.n_items, d), 20 ** -0.5, dt),
            "pos_emb": normal(gen, (cfg.seq_len, d), 20 ** -0.5, dt),
            "ln_f": zeros(), "blocks": blocks}


def _valid(seq: torch.Tensor) -> torch.Tensor:
    """(B, L) True where a position holds an item (id 0 is padding)."""
    return seq != 0


def _causal(l: int, device) -> torch.Tensor:
    """(L, L) True where a query position may see a key position."""
    return torch.ones(l, l, dtype=torch.bool, device=device).tril()


def sasrec_encode(cfg: SASRecConfig, params: dict, seq: torch.Tensor
                  ) -> torch.Tensor:
    """seq (B, L) item ids -> (B, L, D) causal states, zero at padding.
    Masked scores are -1e30, not -inf: a query position whose keys are all
    padding gets a uniform softmax over all L keys, as in the JAX
    package."""
    b, l = seq.shape
    d = cfg.embed_dim
    x = rows(params["item_emb"], seq) * (d ** 0.5) \
        + params["pos_emb"][None, :l]
    valid = _valid(seq)
    mask = replicated_like(_causal(l, seq.device), seq)[None] \
        & valid[:, None, :]
    for blk in params["blocks"]:
        h = rms_norm(x, blk["ln1"])
        q, k, v = ((h @ blk[w]).reshape(b, l, cfg.n_heads, -1)
                   for w in ("wq", "wk", "wv"))
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) / (q.shape[-1] ** 0.5)
        s = s.masked_fill(~mask[:, None], -1e30)
        o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)
        x = x + o.reshape(b, l, d) @ blk["wo"]
        h2 = rms_norm(x, blk["ln2"])
        x = x + torch.relu(h2 @ blk["ffn_w1"] + blk["ffn_b1"]) \
            @ blk["ffn_w2"] + blk["ffn_b2"]
    return rms_norm(x, params["ln_f"]) * valid[..., None].to(x.dtype)


def sasrec_loss(cfg: SASRecConfig, params: dict, batch: dict):
    """BCE over (positive next item, sampled negative) at each position whose
    positive is an item: seq, pos, neg (B, L).  Returns (loss, the
    positives' f32 scores)."""
    h = sasrec_encode(cfg, params, batch["seq"])
    sp = (h * rows(params["item_emb"], batch["pos"])).sum(-1).to(
        torch.float32)
    sn = (h * rows(params["item_emb"], batch["neg"])).sum(-1).to(
        torch.float32)
    m = _valid(batch["pos"]).to(torch.float32)
    loss = -(torch.log(torch.sigmoid(sp) + 1e-24)
             + torch.log(1 - torch.sigmoid(sn) + 1e-24)) * m
    return loss.sum() / m.sum().clamp_min(1.0), sp


def sasrec_serve(cfg: SASRecConfig, params: dict, batch: dict
                 ) -> torch.Tensor:
    """Score each request's candidates: seq (B, L), cand (B, C) -> (B, C)."""
    h = sasrec_encode(cfg, params, batch["seq"])[:, -1]
    ce = rows(params["item_emb"], batch["cand"])
    return torch.einsum("bd,bcd->bc", h, ce)


def sasrec_retrieval(cfg: SASRecConfig, params: dict, batch: dict
                     ) -> torch.Tensor:
    """One user, seq (1, L), against cand (C,) -> (C,) scores."""
    h = sasrec_encode(cfg, params, batch["seq"])[:, -1]       # (1, D)
    ce = rows(params["item_emb"], batch["cand"])               # (C, D)
    return (h @ ce.T)[0]


# -------------------------------------------------------------------- MIND
@dataclass(frozen=True)
class MINDConfig:
    name: str = "mind"
    n_items: int = 1_000_000
    embed_dim: int = 64
    n_interests: int = 4
    capsule_iters: int = 3
    seq_len: int = 50
    dtype: str = "float32"

    def param_count(self) -> int:
        d = self.embed_dim
        return self.n_items * d + d * d + 2 * (d * d + d)


def mind_init(cfg: MINDConfig, gen: torch.Generator) -> dict:
    dt = torch_dtype(cfg.dtype)
    d = cfg.embed_dim
    return {
        "item_emb": normal(gen, (cfg.n_items, d), 0.02, dt),
        "S": normal(gen, (d, d), d ** -0.5, dt),      # shared bilinear map
        "dnn": mlp_init(gen, [d, d, d]),               # f32 whatever dt is
        # fixed (untrained) routing logits per (interest, position)
        "b_init": normal(gen, (cfg.n_interests, cfg.seq_len), 1.0, dt),
    }


def _squash(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    x32 = x.to(at_least_f32(x.dtype))
    n2 = x32.square().sum(dim, keepdim=True)
    return (n2 / (1 + n2) * x32 / torch.sqrt(n2 + 1e-9)).to(x.dtype)


def mind_interests(cfg: MINDConfig, params: dict, seq: torch.Tensor
                   ) -> torch.Tensor:
    """Behavior-to-interest dynamic routing: seq (B, L) with L = seq_len ->
    (B, K, D).  The routing softmax is over interests; padded positions are
    masked after it.  The interests are the last iteration's."""
    e = rows(params["item_emb"], seq)                        # (B, L, D)
    eh = e @ params["S"]
    valid = _valid(seq)
    b_logit = params["b_init"][None].expand(seq.shape[0], cfg.n_interests,
                                            cfg.seq_len)
    for _ in range(cfg.capsule_iters):
        w = torch.softmax(b_logit, 1) * valid[:, None, :].to(b_logit.dtype)
        u = _squash(torch.einsum("bkl,bld->bkd", w, eh))
        b_logit = b_logit + torch.einsum("bkd,bld->bkl", u, eh)
    dnn = params["dnn"]
    return mlp_apply(dnn, u.to(torch.promote_types(u.dtype, dnn["w0"].dtype))
                     ) + u                                     # H-layer + skip


def mind_loss(cfg: MINDConfig, params: dict, batch: dict):
    """Sampled softmax with label-aware attention (power 2): seq (B, L), pos
    (B,), neg (B, N).  The attention over interests is softmax(score ** 2)
    in f32.  Returns (loss, (B, 1 + N) f32 logits, the positive first)."""
    u = mind_interests(cfg, params, batch["seq"])              # (B, K, D)
    pe = rows(params["item_emb"], batch["pos"])              # (B, D)
    att = torch.softmax(
        torch.einsum("bkd,bd->bk", u, pe).to(torch.float32) ** 2, -1)
    v_u = torch.einsum("bk,bkd->bd", att.to(u.dtype), u)       # (B, D)
    ne = rows(params["item_emb"], batch["neg"])              # (B, N, D)
    sp = (v_u * pe).sum(-1, keepdim=True)
    sn = torch.einsum("bd,bnd->bn", v_u, ne)
    logits = torch.cat([sp, sn], -1).to(torch.float32)
    return -torch.log_softmax(logits, -1)[:, 0].mean(), logits


def mind_serve(cfg: MINDConfig, params: dict, batch: dict) -> torch.Tensor:
    """Max-over-interests scores of each request's candidates (B, C)."""
    u = mind_interests(cfg, params, batch["seq"])
    ce = rows(params["item_emb"], batch["cand"])             # (B, C, D)
    return torch.einsum("bkd,bcd->bkc", u, ce).amax(1)


def mind_retrieval(cfg: MINDConfig, params: dict, batch: dict
                   ) -> torch.Tensor:
    u = mind_interests(cfg, params, batch["seq"])              # (1, K, D)
    ce = rows(params["item_emb"], batch["cand"])             # (C, D)
    return (u[0] @ ce.T).amax(0)                               # (C,)


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
    e = rows(table, idx + replicated_like(offsets, idx)[None, :])
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


def twotower_loss(cfg: TwoTowerConfig, params: dict, batch: dict):
    """In-batch sampled softmax with the logQ correction (Yi et al.,
    RecSys'19): user_idx (B, Fu), item_idx (B, Fi), logq (B,), each column's
    logQ subtracted from it.  Returns (loss, (B, B) f32 logits)."""
    u, i = twotower_embed(cfg, params, batch)
    logits = (u @ i.T).to(torch.float32) / cfg.temperature
    logits = logits - batch["logq"][None, :]
    return -_diagonal(torch.log_softmax(logits, -1)).mean(), logits


def _diagonal(m: torch.Tensor) -> torch.Tensor:
    """``m.diagonal()``; a DTensor ``m`` with its rows split takes each
    rank's own diagonal entries (DTensor's rule would gather the whole
    (B, B) matrix)."""
    if not is_dtensor(m):
        return m.diagonal()
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = m.device_mesh
    split = tuple(p if p == Shard(0) else Replicate() for p in m.placements)
    dims = [d for d, p in enumerate(split) if p == Shard(0)]

    def local(ml):
        r = 0
        for d in dims:
            r = r * mesh.size(d) + mesh.get_local_rank(d)
        n = ml.shape[0]
        return (ml[:, r * n:(r + 1) * n].diagonal(),)

    return local_map(local, out_placements=(split,), in_placements=(split,),
                     device_mesh=mesh, redistribute_inputs=True)(m)[0]


def twotower_serve(cfg: TwoTowerConfig, params: dict, batch: dict):
    u, i = twotower_embed(cfg, params, batch)
    return (u * i).sum(-1)


def twotower_retrieval(cfg: TwoTowerConfig, params: dict, batch: dict):
    """One user query against the precomputed corpus: (C,) scores from the
    ``retrieval_scores`` GEMV."""
    u = _user(cfg, params, batch["user_idx"])                 # (1, D)
    return retrieval_scores(params["corpus"], u[0].contiguous())
