"""The comparison that decides ``correct``, and the controls that fail it.

Every configuration states exact answers: each line that holds the term is
returned, none is missing, and no other line is returned.  ``compare``
counts the ways a run's answers depart from the reference's; each count has
the limit 0 (``workloads/<cell>.json``).

The controls are the reference put in the program's place with one stated
guarantee broken, the steps that would tempt a later change:
``batch_granular`` answers with every line of each batch that holds a match
(the post-filter's exactness given up), ``lose_tail`` forgets the newest
acknowledged lines (durability given up for a cheaper publish).
"""
from __future__ import annotations

import numpy as np


def compare(got, want) -> dict:
    """Counts of departures of ``got`` from ``want`` (lists of line-id
    arrays, one pair a query): answers that differ, reference lines not
    returned, and returned lines that are not in the reference (a line
    returned twice counts once more)."""
    wrong = missing = extra = 0
    for g, w in zip(got, want):
        g = np.asarray(g, np.int64)
        if not g.size and not w.size:
            continue
        gu = np.unique(g)
        both = np.intersect1d(gu, w, assume_unique=True).size
        miss, more = w.size - both, g.size - both
        missing += miss
        extra += more
        wrong += bool(miss or more)
    return {"answers": len(want), "wrong_answers": wrong,
            "missing_lines": missing, "extra_lines": extra}


def batch_granular(want, batch_lines: int, n_lines: int) -> list:
    """Every line of each ``batch_lines``-line batch that holds a line of
    the answer."""
    out = []
    for w in want:
        starts = np.unique(w // batch_lines) * batch_lines
        out.append(np.concatenate(
            [np.arange(s, min(s + batch_lines, n_lines)) for s in starts])
            if starts.size else w)
    return out


def lose_tail(want, n_kept: int) -> list:
    """The answers as a store that kept only its first ``n_kept`` lines
    gives them."""
    return [w[w < n_kept] for w in want]
