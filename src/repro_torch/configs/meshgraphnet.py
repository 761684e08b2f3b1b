"""meshgraphnet [arXiv:2010.03409; unverified]: n_layers=15 d_hidden=128
aggregator=sum mlp_layers=2.

Four graph regimes (each its own d_feat, padded so the edge axis shards
over pod x data x model = 512 in the JAX package's dry run):
  full_graph_sm : n_nodes=2708  n_edges=10556->10752   d_feat=1433
  minibatch_lg  : sampled subgraph of a 232965-node/114.6M-edge graph,
                  batch_nodes=1024 fanout 15-10 -> 169984 nodes,
                  168960 edges, d_feat=602 (``models/gnn.neighbor_sample``)
  ogb_products  : n_nodes=2449029->2449408  n_edges=61859140->61859328
                  d_feat=100
  molecule      : 128 graphs x 30 nodes / 64 edges -> 3840 nodes,
                  8192 edges, d_feat=16
"""
import numpy as np
import torch

from ..models.gnn import GNNConfig
from .base import ArchSpec, ShapeSpec, pad_to

CONFIG = GNNConfig(name="meshgraphnet", n_layers=15, d_hidden=128,
                   mlp_layers=2, aggregator="sum", d_node_in=1433,
                   d_edge_in=4, d_out=16)

SMOKE = GNNConfig(name="mgn-smoke", n_layers=3, d_hidden=16, mlp_layers=2,
                  aggregator="sum", d_node_in=8, d_edge_in=4, d_out=4)

SHAPES = {
    "full_graph_sm": ShapeSpec(
        "full_graph_sm", "train",
        dict(n_nodes=2708, n_edges=pad_to(10556, 512), d_feat=1433)),
    "minibatch_lg": ShapeSpec(
        "minibatch_lg", "train",
        dict(n_nodes=169984, n_edges=168960, d_feat=602)),
    "ogb_products": ShapeSpec(
        "ogb_products", "train",
        dict(n_nodes=pad_to(2449029, 512), n_edges=pad_to(61859140, 512),
             d_feat=100)),
    "molecule": ShapeSpec(
        "molecule", "train",
        dict(n_nodes=3840, n_edges=8192, d_feat=16)),
}


def smoke_batch(cfg, rng: np.random.Generator, device="cpu"):
    n, e = 24, 64

    def t(a, dtype):
        return torch.from_numpy(np.asarray(a, dtype)).to(device)

    return {
        "nodes": t(rng.normal(size=(n, cfg.d_node_in)), np.float32),
        "edges": t(rng.normal(size=(e, cfg.d_edge_in)), np.float32),
        "senders": t(rng.integers(0, n, e), np.int32),
        "receivers": t(rng.integers(0, n, e), np.int32),
        "edge_mask": torch.ones(e, dtype=torch.float32, device=device),
        "node_mask": torch.ones(n, dtype=torch.float32, device=device),
        "targets": t(rng.normal(size=(n, cfg.d_out)), np.float32),
    }


SPEC = ArchSpec(
    id="meshgraphnet", family="gnn", source="arXiv:2010.03409; unverified",
    config=CONFIG, smoke_config=SMOKE, shapes=SHAPES,
    optimizer="adamw", smoke_batch=smoke_batch,
    notes="segment_sum message passing; edges shard over all mesh axes; "
          "graph shapes padded to multiples of 512 for the pod mesh")
