"""Wrappers of the retrieval_score kernel: the scores of one query against a
(C, D) corpus, and their top k (two-tower ``retrieval_cand``)."""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import build
from .ref import retrieval_score_ref

MAX_D = 12_288          # the query is staged in 48 KB of shared memory


@functools.cache
def _kernel():
    lib = build.library("retrieval_score")
    p, i = ctypes.c_void_p, ctypes.c_int
    return lib, build.declare(lib, "retrieval_score_launch",
                              p, p, i, i, i, p, p)


def retrieval_scores(corpus: torch.Tensor, query: torch.Tensor
                     ) -> torch.Tensor:
    """(C, D) f32 corpus, (D,) f32 query -> (C,) f32 scores.  A CUDA tensor
    launches the kernel; a CPU tensor takes the plain version."""
    if (corpus.dim() != 2 or corpus.dtype != torch.float32
            or not corpus.is_contiguous()):
        raise ValueError("corpus must be a contiguous (C, D) float32 tensor")
    c, d = corpus.shape
    if (query.shape != (d,) or query.dtype != torch.float32
            or query.device != corpus.device):
        raise ValueError(f"query must be a ({d},) float32 tensor on "
                         f"{corpus.device}")
    if corpus.device.type == "cpu":
        return retrieval_score_ref(corpus, query)
    if corpus.device.type != "cuda":
        raise ValueError(f"retrieval_score runs on cuda or cpu, not "
                         f"{corpus.device}")
    if not 0 < d <= MAX_D:
        raise ValueError(f"retrieval_score takes 1 <= D <= {MAX_D}, not {d}")
    out = torch.empty(c, dtype=torch.float32, device=corpus.device)
    if c:
        query = query.contiguous()
        vec = int(d % 4 == 0 and corpus.data_ptr() % 16 == 0
                  and query.data_ptr() % 16 == 0)
        lib, fn = _kernel()
        with torch.cuda.device(corpus.device):
            err = fn(corpus.data_ptr(), query.data_ptr(), c, d, vec,
                     out.data_ptr(), build.stream_of(corpus))
        build.check(lib, err, "retrieval_score")
        build.count_launch(retrieval_scores)
    return out


def retrieval_topk(corpus: torch.Tensor, query: torch.Tensor, k: int = 100
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """(values, ids) of the k best-scoring corpus rows, best first: the
    kernel's scores, then ``torch.topk`` outside it."""
    return torch.topk(retrieval_scores(corpus, query), k)


retrieval_scores.launch_count = 0
