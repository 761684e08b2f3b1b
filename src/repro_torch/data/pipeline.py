"""Training-data pipeline: deterministic, checkpointable, sketch-filtered.

Two layers:
  * ``SketchFilteredCorpus``: the paper's technique as a data-selection
    feature.  A DynaWarp-indexed corpus yields only the compressed batches
    whose sketch matches the requested terms (train on the batches that
    mention "error" without decompressing the rest).  Filtering costs a
    probe, not a scan: the terms go to the store as one wave
    (``candidates_term_batch``), which on a finished store on the card
    launches ``sketch_probe``, ``bitset_reduce`` and ``bitmap_extract``.
    The JAX package asks ``candidates_term`` a term at a time, where a
    lone query takes the engine's host path; a wave's answers equal that
    path's bit for bit, so the batches are the same.
  * ``LMTokenPipeline``: a seeded batch stream, batch t a pure function of
    (seed, t), so that a restart resumes exactly (the cursor is one
    integer) and any worker can make any step.  Batches are numpy arrays,
    bit-identical to the JAX package's; the caller moves them to its
    device.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..logstore.compress import decompress_batch


@dataclass
class SketchFilteredCorpus:
    """A finished DynaWarp log store as a filtered training corpus."""
    store: object                      # logstore.store.DynaWarpStore
    include_terms: tuple = ()          # AND of terms that must appear
    exclude_terms: tuple = ()          # batches containing these are dropped

    def selected_batches(self) -> np.ndarray:
        """Ids of the batches whose sketch holds every include term and no
        exclude term, ascending."""
        n = self.store.n_batches
        terms = list(self.include_terms) + list(self.exclude_terms)
        answers = self.store.candidates_term_batch(terms) if terms else []
        keep = np.ones(n, bool)
        for i, got in enumerate(answers):
            cand = np.zeros(n, bool)
            cand[got] = True
            keep &= cand if i < len(self.include_terms) else ~cand
        return np.nonzero(keep)[0]

    def lines(self):
        for b in self.selected_batches():
            yield from decompress_batch(self.store.blobs[int(b)])


class LMTokenPipeline:
    """Deterministic (seed, step) -> batch token stream.

    ``text_source`` is any iterable of strings (e.g. a
    ``SketchFilteredCorpus``'s ``lines()``); tokens are the text's bytes
    hashed into the vocab, a stand-in tokenizer for the training loops.
    """

    def __init__(self, text_source, *, vocab: int, batch: int, seq: int,
                 seed: int = 0, max_lines: int = 100_000):
        lines = []
        for i, line in enumerate(text_source):
            if i >= max_lines:
                break
            lines.append(line)
        corpus = "\n".join(lines).encode() or b"\0"
        self.tokens = (np.frombuffer(corpus, np.uint8).astype(np.int64)
                       * 2654435761 % max(vocab, 2)).astype(np.int32)
        self.vocab, self.batch, self.seq, self.seed = vocab, batch, seq, seed

    def batch_at(self, step: int) -> dict:
        """Pure function of (seed, step): tokens, labels (the next tokens)
        and mask, (batch, seq) numpy arrays."""
        rng = np.random.default_rng((self.seed << 32) ^ step)
        n = len(self.tokens)
        starts = rng.integers(0, max(n - self.seq - 1, 1), self.batch)
        tok = np.stack([self.tokens[s:s + self.seq] if s + self.seq <= n
                        else np.resize(self.tokens, self.seq)
                        for s in starts])
        lab = np.stack([self.tokens[s + 1:s + self.seq + 1]
                        if s + self.seq + 1 <= n
                        else np.resize(self.tokens, self.seq)
                        for s in starts])
        return {"tokens": tok.astype(np.int32),
                "labels": lab.astype(np.int32),
                "mask": np.ones((self.batch, self.seq), np.float32)}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
