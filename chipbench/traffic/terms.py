"""Query terms drawn from a corpus by kind, for a mix given as data.

A mix is a list of ``{"kind": ..., "share": ...}``; a stream of ``n`` terms
holds each kind ``round(share * n)`` times (the last kind takes the rest),
in an order drawn from the seed, so that every seed gets the same set of
kinds in another order.
"""
from __future__ import annotations

import numpy as np

from ..corpus import Corpus, random_ids


def absent_id(corpus: Corpus, rng, n: int, n_lines=None) -> np.ndarray:
    """Random 16-letter ids that the corpus never emitted (the paper's
    term(ID) needle scenario, §5.2)."""
    ids = random_ids(rng, n)
    while True:
        bad = np.isin(ids, corpus.id_value)
        if not bad.any():
            return ids
        ids[bad] = random_ids(rng, int(bad.sum()))


def once_id(corpus: Corpus, rng, n: int, n_lines=None) -> np.ndarray:
    """Ids emitted exactly once (among the first ``n_lines`` lines)."""
    once = corpus.once_ids(n_lines)
    return once[rng.integers(0, once.size, size=n)] if once.size else once


def present_id(corpus: Corpus, rng, n: int, n_lines=None) -> np.ndarray:
    """The id of a random id-bearing line: pool values that recur over
    tens to hundreds of batches, drawn as often as lines hold them."""
    k = corpus.id_value.size if n_lines is None else \
        int(np.searchsorted(corpus.id_line, n_lines))
    return corpus.id_value[rng.integers(0, k, size=n) if k else []]


KINDS = {"absent_id": absent_id, "once_id": once_id, "present_id": present_id}


def draw(corpus: Corpus, mix: list, rng, n: int, n_lines=None) -> list[str]:
    counts = [int(round(m["share"] * n)) for m in mix]
    counts[-1] = n - sum(counts[:-1])
    terms = np.concatenate([KINDS[m["kind"]](corpus, rng, c, n_lines)
                            for m, c in zip(mix, counts)])
    return terms[rng.permutation(n)].astype(str).tolist()
