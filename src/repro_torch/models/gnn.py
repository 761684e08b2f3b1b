"""MeshGraphNet (Pfaff et al., arXiv:2010.03409): the forward pass and the
neighbor sampler.

Encode-process-decode with ``n_layers`` message-passing steps:
  edge update : e' = e + MLP([e, h_src, h_dst])
  node update : h' = h + MLP([h, aggregate(e', dst)])
The aggregation is a scatter over the receivers (``index_add_`` for sum
and mean, ``scatter_reduce_`` for max), as the JAX package's
``segment_sum`` / ``segment_max``; it reaches no hand-written kernel there
or here.  On CUDA ``index_add_`` adds floats atomically, so its order of
summation varies from run to run.

Graphs arrive as padded tensors: ``senders`` / ``receivers`` int (E,),
node features (N, d_feat), ``edge_mask`` zeroing padded edges,
``node_mask`` zeroing padded nodes.  Padded edges still gather their
endpoints' states; only the masks keep them out of the sums.  Batched
small graphs are one disjoint graph with offset node ids.  The processor
MLPs are stacked with a leading ``n_layers`` axis, as in the JAX tree.
Training is ``gnn_loss``, the masked node-regression L2; with ``remat``
each message-passing layer is recomputed in the backward pass
(``torch.utils.checkpoint``, the JAX package's ``jax.checkpoint``).
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from .layers import layer_norm_nonparam, mlp_apply, mlp_init, torch_dtype


@dataclass(frozen=True)
class GNNConfig:
    name: str
    n_layers: int = 15
    d_hidden: int = 128
    mlp_layers: int = 2          # hidden layers inside each MLP
    d_node_in: int = 1433        # raw node feature dim (per shape)
    d_edge_in: int = 4
    d_out: int = 16              # decoder output dim
    aggregator: str = "sum"
    dtype: str = "float32"
    scan_layers: bool = True     # the JAX package's lax.scan; no effect here

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)

    def param_count(self) -> int:
        h, m = self.d_hidden, self.mlp_layers

        def mlp(din, dout):
            sizes = [din] + [h] * m + [dout]
            return sum(sizes[i] * sizes[i + 1] + sizes[i + 1]
                       for i in range(len(sizes) - 1))
        enc = mlp(self.d_node_in, h) + mlp(self.d_edge_in, h)
        proc = self.n_layers * (mlp(3 * h, h) + mlp(2 * h, h))
        return enc + proc + mlp(h, self.d_out)


def _mlp_sizes(cfg: GNNConfig, d_in: int, d_out: int) -> list:
    return [d_in] + [cfg.d_hidden] * cfg.mlp_layers + [d_out]


def init_params(cfg: GNNConfig, gen: torch.Generator) -> dict:
    dt, h = cfg.compute_dtype, cfg.d_hidden

    def stacked(sizes):
        ps = [mlp_init(gen, sizes, dt) for _ in range(cfg.n_layers)]
        return {k: torch.stack([p[k] for p in ps]) for k in ps[0]}

    return {
        "node_enc": mlp_init(gen, _mlp_sizes(cfg, cfg.d_node_in, h), dt),
        "edge_enc": mlp_init(gen, _mlp_sizes(cfg, cfg.d_edge_in, h), dt),
        "edge_mlp": stacked(_mlp_sizes(cfg, 3 * h, h)),
        "node_mlp": stacked(_mlp_sizes(cfg, 2 * h, h)),
        "decoder": mlp_init(gen, _mlp_sizes(cfg, h, cfg.d_out), dt),
    }


def _aggregate(cfg: GNNConfig, messages: torch.Tensor,
               receivers: torch.Tensor, n_nodes: int) -> torch.Tensor:
    """(E, D) messages -> (n_nodes, D).  A node with no message sums to 0
    and maxes to -inf, as ``jax.ops.segment_max`` leaves it; mean divides
    by the count of messages (padded edges included), at least 1."""
    def zeros(d):
        return torch.zeros(n_nodes, d, dtype=messages.dtype,
                           device=messages.device)

    if cfg.aggregator == "sum":
        return zeros(messages.shape[1]).index_add_(0, receivers, messages)
    if cfg.aggregator == "max":
        return torch.full((n_nodes, messages.shape[1]), -torch.inf,
                          dtype=messages.dtype, device=messages.device
                          ).scatter_reduce_(
            0, receivers[:, None].expand_as(messages), messages, "amax",
            include_self=False)
    if cfg.aggregator == "mean":
        s = zeros(messages.shape[1]).index_add_(0, receivers, messages)
        c = zeros(1).index_add_(0, receivers, torch.ones_like(messages[:, :1]))
        return s / c.clamp_min(1.0)
    raise ValueError(cfg.aggregator)


def _process(cfg: GNNConfig, h: torch.Tensor, e: torch.Tensor,
             edge_w: dict, node_w: dict, snd: torch.Tensor, rcv: torch.Tensor,
             emask: torch.Tensor):
    """One message-passing layer: (h, e) -> (h', e')."""
    msg_in = torch.cat([e, h[snd], h[rcv]], -1)
    e_new = mlp_apply(edge_w, msg_in) * emask
    e = e + layer_norm_nonparam(e_new) * emask
    agg = _aggregate(cfg, e, rcv, h.shape[0])
    return h + layer_norm_nonparam(mlp_apply(node_w, torch.cat([h, agg], -1))), e


def forward(cfg: GNNConfig, params: dict, graph: dict, *,
            remat: bool = True) -> torch.Tensor:
    """graph: dict(nodes (N, d_node_in), edges (E, d_edge_in), senders (E,),
    receivers (E,), edge_mask (E,), node_mask (N,)) -> (N, d_out) decoded
    per-node output.  With ``remat`` and gradients on, each layer keeps only
    its inputs for the backward pass and is run again there;
    ``cfg.scan_layers`` changes nothing here."""
    emask = graph["edge_mask"][:, None].to(cfg.compute_dtype)
    h = layer_norm_nonparam(mlp_apply(params["node_enc"], graph["nodes"]))
    e = layer_norm_nonparam(mlp_apply(params["edge_enc"], graph["edges"])) \
        * emask
    snd, rcv = graph["senders"].long(), graph["receivers"].long()
    layer = partial(_process, cfg)
    for i in range(cfg.n_layers):
        edge_w = {k: w[i] for k, w in params["edge_mlp"].items()}
        node_w = {k: w[i] for k, w in params["node_mlp"].items()}
        args = (h, e, edge_w, node_w, snd, rcv, emask)
        if remat and torch.is_grad_enabled():
            h, e = checkpoint(layer, *args, use_reentrant=False,
                              preserve_rng_state=False)
        else:
            h, e = layer(*args)
    out = mlp_apply(params["decoder"], h)
    return out * graph["node_mask"][:, None].to(out.dtype)


def gnn_loss(cfg: GNNConfig, params: dict, batch: dict, *,
             remat: bool = True):
    """Node-regression L2 against ``batch["targets"]`` (N, d_out) over the
    unmasked nodes: (se / max(sum(node_mask) * d_out, 1), se)."""
    pred = forward(cfg, params, batch, remat=remat)
    m = batch["node_mask"][:, None].to(torch.float32)
    se = ((pred - batch["targets"]).to(torch.float32).square() * m).sum()
    return se / (m.sum() * cfg.d_out).clamp_min(1.0), se


# ------------------------------------------------------------- sampler
def neighbor_sample(csr_indptr, csr_indices, seed_nodes, fanouts,
                    rng: np.random.Generator):
    """GraphSAGE-style neighbor sampler on the host (numpy), the JAX
    package's algorithm with the same ``rng`` draws in the same order.

    csr_indptr (N+1,), csr_indices (nnz,): the adjacency in CSR.
    Returns (nodes int64, senders int32, receivers int32) of the sampled
    subgraph, node ids relabeled to [0, len(nodes)), seed nodes first.
    """
    nodes = list(seed_nodes)
    id_of = {int(n): i for i, n in enumerate(seed_nodes)}
    senders, receivers = [], []
    frontier = list(seed_nodes)
    for fan in fanouts:
        nxt = []
        for u in frontier:
            lo, hi = int(csr_indptr[u]), int(csr_indptr[u + 1])
            deg = hi - lo
            if deg == 0:
                continue
            sel = rng.choice(deg, size=min(fan, deg), replace=False)
            for off in sel:
                v = int(csr_indices[lo + off])
                if v not in id_of:
                    id_of[v] = len(nodes)
                    nodes.append(v)
                    nxt.append(v)
                senders.append(id_of[v])
                receivers.append(id_of[u])
        frontier = nxt
    return (np.asarray(nodes, np.int64), np.asarray(senders, np.int32),
            np.asarray(receivers, np.int32))
