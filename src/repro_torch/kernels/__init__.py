"""Hand-written CUDA kernels of the port, one package per kernel.

  sketch_probe    — immutable-sketch MPHF probe, and the fused segment probe
                    of the query waves (probe + signature + CSF rank +
                    plane-row OR)
  bitset_ops      — posting-plane AND/OR fold over the token axis + popcount
                    (every row over all planes, or the query engine's live
                    rows each over its own token count)
  bitmap_extract  — hit bitmaps -> ascending posting ids (a padded matrix,
                    or one compacted array at given row offsets)
  token_hash      — batched token fingerprinting (ingest and query waves)
  csc_probe       — CSC baseline probe (the sketch-vs-sketch comparison)
  retrieval_score — two-tower retrieval: one query against a 1M-row corpus
  embedding_bag   — fixed-size bag sums (xDeepFM's wide term)
  flash_decode    — one-token GQA attention against a KV cache (LM decode)

Each package has ``ops.py`` (the wrapper: checks, launch on CUDA tensors,
plain version on CPU tensors, ``launch_count``) and ``ref.py`` (the plain
PyTorch version).  Sources live in ``csrc/``; ``build.py`` compiles them
with nvcc at first use.
"""
from .bitmap_extract.ops import bitmap_extract, bitmap_extract_ragged
from .bitset_ops.ops import (bitset_reduce, bitset_reduce_batch,
                             bitset_reduce_ragged)
from .csc_probe.ops import csc_partition_mask
from .embedding_bag.ops import embedding_bag_sum
from .flash_decode.ops import flash_decode
from .retrieval_score.ops import retrieval_scores, retrieval_topk
from .sketch_probe.ops import match_planes, mphf_probe, mphf_probe_arrs
from .token_hash.ops import token_fingerprints

__all__ = ["bitmap_extract", "bitmap_extract_ragged", "bitset_reduce",
           "bitset_reduce_batch", "bitset_reduce_ragged",
           "csc_partition_mask", "embedding_bag_sum", "flash_decode",
           "match_planes", "mphf_probe", "mphf_probe_arrs",
           "retrieval_scores", "retrieval_topk", "token_fingerprints"]
