"""Query execution (Algorithm 3) with posting-consumer early exit.

Works identically on mutable and immutable sketches via a tiny adapter
(``is_present`` / ``acquire_list`` / ``decode``).  Unique posting lists are
decoded once even when several query tokens share a list (§4.4).
"""
from __future__ import annotations

import numpy as np

from .hashing import token_fingerprint
from .immutable_sketch import ImmutableSketch
from .mutable_sketch import MutableSketch


class PostingsConsumer:
    """Combines per-token posting lists; can stop the query early."""

    def accept(self, postings: np.ndarray) -> None:
        raise NotImplementedError

    def should_stop(self) -> bool:
        return False

    def result(self) -> np.ndarray:
        raise NotImplementedError


class AndConsumer(PostingsConsumer):
    """Batches containing ALL query tokens (the needle-in-haystack mode)."""

    def __init__(self):
        self._acc: np.ndarray | None = None
        self._empty = False

    def accept(self, postings: np.ndarray) -> None:
        if self._empty:
            return
        if postings.size == 0:
            self._acc = np.empty(0, dtype=np.int64)
            self._empty = True
            return
        if self._acc is None:
            self._acc = np.asarray(postings, dtype=np.int64)
        else:
            self._acc = np.intersect1d(self._acc, postings, assume_unique=True)
            if self._acc.size == 0:
                self._empty = True

    def should_stop(self) -> bool:
        return self._empty

    def result(self) -> np.ndarray:
        return self._acc if self._acc is not None else np.empty(0, np.int64)


class OrConsumer(PostingsConsumer):
    """Batches containing ANY query token."""

    def __init__(self):
        self._parts: list[np.ndarray] = []

    def accept(self, postings: np.ndarray) -> None:
        if postings.size:
            self._parts.append(np.asarray(postings, dtype=np.int64))

    def result(self) -> np.ndarray:
        if not self._parts:
            return np.empty(0, np.int64)
        return np.unique(np.concatenate(self._parts))


class _MutableAdapter:
    def __init__(self, sk: MutableSketch):
        self.sk = sk

    def probe(self, fp: int):
        postings = self.sk.acquire_postings(fp)
        if postings is None:
            return None
        # the mutable sketch's unique-list identity is the list object id;
        # direct-encoded entries are keyed by their single posting value.
        entry = self.sk.token_map[fp]
        key = ("d", entry[1]) if entry[0] == 0 else ("l", id(entry[1]))
        return key, postings


class _ImmutableAdapter:
    def __init__(self, sk: ImmutableSketch):
        self.sk = sk

    def probe(self, fp: int):
        present, rank = self.sk.probe_fp_scalar(fp)
        if not present:
            return None
        return int(rank), None  # decode lazily


def execute_query(sketch, tokens, consumer: PostingsConsumer
                  ) -> PostingsConsumer:
    """Algorithm 3: probe each token, then decode each unique list once."""
    adapter = (_ImmutableAdapter(sketch) if isinstance(sketch, ImmutableSketch)
               else _MutableAdapter(sketch))
    unique: dict = {}
    for t in tokens:
        fp = token_fingerprint(t) if isinstance(t, (bytes, bytearray)) else int(t)
        hit = adapter.probe(fp)
        if hit is None:
            consumer.accept(np.empty(0, np.int64))  # notify empty (§4.4)
            if consumer.should_stop():
                return consumer
        else:
            key, postings = hit
            unique.setdefault(key, postings)
    for key, postings in unique.items():
        if postings is None:  # immutable: decode unique list once
            postings = sketch.postings_for_rank(key)
        consumer.accept(postings)
        if consumer.should_stop():
            return consumer
    return consumer


def query_and(sketch, tokens) -> np.ndarray:
    return execute_query(sketch, tokens, AndConsumer()).result()


def query_or(sketch, tokens) -> np.ndarray:
    return execute_query(sketch, tokens, OrConsumer()).result()
