"""Which lines hold a term: the plain reference for term queries.

A frozen copy of the one term rule the benchmark's queries need, from the
paper's tokenization (§5.1.1, rule 1): a line holds an alphanumeric term
when one of the maximal runs of ASCII letters and digits of the lowercased
line equals the lowercased term.  Rules 2-5 never make a token of letters
and digits alone (a punctuation run, a non-ASCII run, or runs joined by a
separator), so for such a term rule 1 decides alone.  Other terms, and
terms longer than the 64 bytes a token keeps, are refused rather than
answered by a rule this file does not hold.

Works from the lines alone: one numpy pass finds every run of the lengths
asked for, so every answer of a run can be looked up.
"""
from __future__ import annotations

import numpy as np

MAX_TERM_BYTES = 64
_ALNUM = np.zeros(256, dtype=bool)
for _lo, _hi in ((ord("0"), ord("9")), (ord("a"), ord("z"))):
    _ALNUM[_lo:_hi + 1] = True


def _term_bytes(term: str) -> bytes:
    t = term.lower().encode("ascii")
    if not t or len(t) > MAX_TERM_BYTES or not _ALNUM[
            np.frombuffer(t, np.uint8)].all():
        raise ValueError(f"the reference answers alphanumeric terms of 1 to "
                         f"{MAX_TERM_BYTES} bytes only, not {term!r}")
    return t


class TermIndex:
    """Every run of letters and digits, of the lengths in ``lengths``, of
    ``lines`` (ASCII), with the line it lies in."""

    def __init__(self, lines: list[str], lengths):
        blob = np.frombuffer("\n".join(lines).encode("ascii").lower(),
                             np.uint8)
        sizes = np.fromiter(map(len, lines), dtype=np.int64, count=len(lines))
        line_start = np.concatenate([[0], np.cumsum(sizes + 1)[:-1]])
        pad = np.zeros(1, np.int8)
        edge = np.diff(np.concatenate([pad, _ALNUM[blob].view(np.int8), pad]))
        run_start = np.flatnonzero(edge == 1)
        run_len = np.flatnonzero(edge == -1) - run_start
        self._keys: dict[int, tuple[np.ndarray, np.ndarray]] = {}
        for n in sorted({int(x) for x in lengths}):
            at = run_start[run_len == n]
            keys = blob[at[:, None] + np.arange(n)].view(f"S{n}").ravel()
            line = np.searchsorted(line_start, at, side="right") - 1
            order = np.argsort(keys, kind="stable")
            self._keys[n] = (keys[order], line[order])

    def lines_with(self, term: str) -> np.ndarray:
        """Sorted ids of the lines that hold ``term``."""
        t = _term_bytes(term)
        if len(t) not in self._keys:
            raise ValueError(f"terms of {len(t)} bytes were not indexed")
        keys, line = self._keys[len(t)]
        lo, hi = np.searchsorted(keys, t), np.searchsorted(keys, t, "right")
        return np.unique(line[lo:hi])
