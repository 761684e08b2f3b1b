"""Tokenization rules 1-8 from the paper (§5.1.1 "Ingest configuration").

  (1) runs of alphanumeric ASCII characters
  (2) runs of non-alphanumeric, non-whitespace ASCII characters
  (3) runs of non-ASCII characters
  (4) two alphanumeric tokens joined by a single separator [.:-_/@]
  (5) three alphanumeric tokens joined by single '.' characters
  (6) every 3-gram of each alphanumeric token
  (7) every 1-/2-/3-gram of each non-alphanumeric ASCII token
  (8) every 2-gram of each non-ASCII token

Tokens are lower-cased and hashed as UTF-8 bytes.  Rules 1-5 yield the
*term* vocabulary; rules 6-8 yield the n-gram vocabulary enabling
``contains`` queries on arbitrary substrings (DynaWarp/CSC mode).  The
Lucene-analogue inverted index only uses rules 1-5 and answers contains
queries by scanning its lexicon, exactly as in the paper.
"""
from __future__ import annotations

import re
from typing import Iterable

import numpy as np

_ALNUM = re.compile(r"[0-9A-Za-z]+")
_PUNCT = re.compile(r"[!-/:-@\[-`{-~]+")
_NONASCII = re.compile(r"[^\x00-\x7F]+")
_SEPARATORS = set(".:-_/@")

MAX_TOKEN_BYTES = 64  # packed-matrix row width for batched hashing


def _ngrams(s: str, n: int) -> Iterable[str]:
    if len(s) < n:
        return ()
    return (s[i:i + n] for i in range(len(s) - n + 1))


def scan_line(lower: str):
    """Rule 1-5 scan of one LOWERED line, shared by every tokenization
    path: ``(alnum_runs, punct_runs, nonascii_runs, joined)`` where
    ``joined`` holds the rule-4 separator pairs and rule-5 dot triples."""
    spans = [(m.start(), m.end(), m.group()) for m in _ALNUM.finditer(lower)]
    alnum = [t for _, _, t in spans]
    punct = [m.group() for m in _PUNCT.finditer(lower)]
    nonascii = [m.group() for m in _NONASCII.finditer(lower)]
    joined: list[str] = []
    # rule 4: pairs across a single separator char
    for (s0, e0, _), (s1, e1, _) in zip(spans, spans[1:]):
        if s1 - e0 == 1 and lower[e0] in _SEPARATORS:
            joined.append(lower[s0:e1])
    # rule 5: triples across single '.' chars
    for i in range(len(spans) - 2):
        s0, e0, _ = spans[i]
        s1, e1, _ = spans[i + 1]
        s2, e2, _ = spans[i + 2]
        if s1 - e0 == 1 and lower[e0] == "." \
                and s2 - e1 == 1 and lower[e1] == ".":
            joined.append(lower[s0:e2])
    return alnum, punct, nonascii, joined


def tokenize_line(line: str, *, ngrams: bool = True) -> set[bytes]:
    """All indexed tokens for one log line.

    ``ngrams=False`` disables rules 6-8 (the Lucene-store configuration,
    and the paper's noted 43-60% ingest-time saving when contains queries
    are not required).
    """
    out: set[str] = set()
    alnum, punct, nonascii, joined = scan_line(line.lower())
    # rule 1 (+ rule 6)
    for tok in alnum:
        out.add(tok)
        if ngrams:
            out.update(_ngrams(tok, 3))
    # rule 2 (+ rule 7)
    for tok in punct:
        out.add(tok)
        if ngrams:
            out.update(_ngrams(tok, 1))
            out.update(_ngrams(tok, 2))
            out.update(_ngrams(tok, 3))
    # rule 3 (+ rule 8)
    for tok in nonascii:
        out.add(tok)
        if ngrams:
            out.update(_ngrams(tok, 2))
    out.update(joined)
    return {t.encode("utf-8")[:MAX_TOKEN_BYTES] for t in out}


def tokenize_lines_columnar(lines, *, ngrams: bool = True):
    """Columnar tokenization of a batch of lines for the vectorized ingest
    pipeline.  Python only extracts the regex *runs* and the rule-4/5
    joins; the n-gram explosion of rules 6/7 is deferred to the vectorized
    byte-window hasher (``hashing.np_window_fingerprints``) over the
    packed run matrices — no per-n-gram substring objects on the hot path.

    Returns ``(tokens, tok_line, alnum_runs, alnum_line, punct_runs,
    punct_line)``: rules 1-5 terms (plus the rare rule-8 char-level
    n-grams of non-ASCII runs, expanded here because UTF-8 byte windows
    differ from char windows) with their line ids, and the rule-6/7 run
    byte strings with theirs.  Run lists are empty when ``ngrams=False``.
    """
    tokens: list[bytes] = []
    tok_line: list[int] = []
    alnum_runs: list[bytes] = []
    alnum_line: list[int] = []
    punct_runs: list[bytes] = []
    punct_line: list[int] = []
    for li, line in enumerate(lines):
        n0 = len(tokens)
        alnum, punct, nonascii, joined = scan_line(line.lower())
        tokens.extend(t.encode() for t in alnum)
        if ngrams and alnum:
            alnum_runs.extend(t.encode() for t in alnum)
            alnum_line.extend([li] * len(alnum))
        for t in punct:
            enc = t.encode()
            tokens.append(enc)
            if ngrams:
                punct_runs.append(enc)
                punct_line.append(li)
        for t in nonascii:
            tokens.append(t.encode("utf-8"))
            if ngrams:
                tokens.extend(g.encode("utf-8") for g in _ngrams(t, 2))
        tokens.extend(t.encode() for t in joined)
        tok_line.extend([li] * (len(tokens) - n0))
    return (tokens, tok_line, alnum_runs, alnum_line, punct_runs,
            punct_line)


def term_query_tokens(term: str) -> list[bytes]:
    """Tokens to look up for a ``term`` query (the exact token)."""
    return [term.lower().encode("utf-8")[:MAX_TOKEN_BYTES]]


def contains_query_tokens(term: str) -> list[bytes]:
    """Guaranteed-present tokens for a ``contains`` (substring) query.

    Any log line containing ``term`` as a substring must have indexed every
    interior n-gram of the query under rules 6-8; full runs in the query may
    be partial runs in the data, so only n-grams (never the runs themselves)
    are guaranteed.  An empty result means the sketch cannot prune for this
    query and the caller must fall back to a full scan.
    """
    lower = term.lower()
    out: set[str] = set()
    for m in _ALNUM.finditer(lower):
        out.update(_ngrams(m.group(), 3))
    for m in _PUNCT.finditer(lower):
        tok = m.group()
        out.update(_ngrams(tok, 1))
        out.update(_ngrams(tok, 2))
        out.update(_ngrams(tok, 3))
    for m in _NONASCII.finditer(lower):
        out.update(_ngrams(m.group(), 2))
    return [t.encode("utf-8")[:MAX_TOKEN_BYTES] for t in sorted(out)]


def pack_tokens(tokens: list[bytes], max_len: int = MAX_TOKEN_BYTES
                ) -> tuple[np.ndarray, np.ndarray]:
    """Pack variable-length byte tokens into a zero-padded (N, L) u8 matrix
    + length vector, the input format of the batched fingerprint hashers."""
    n = len(tokens)
    mat = np.zeros((n, max_len), dtype=np.uint8)
    lengths = np.zeros((n,), dtype=np.int32)
    for i, t in enumerate(tokens):
        t = t[:max_len]
        mat[i, :len(t)] = np.frombuffer(t, dtype=np.uint8)
        lengths[i] = len(t)
    return mat, lengths


def pack_slices(bu8: np.ndarray, starts: np.ndarray, lens: np.ndarray,
                max_len: int | None = None
                ) -> tuple[np.ndarray, np.ndarray]:
    """Scatter (start, len) slices of a flat u8 buffer into a zero-padded
    (N, L) matrix + length vector — the vectorized core of token packing
    (no per-token byte objects)."""
    n = len(starts)
    L = max(int(lens.max()) if n else 1, 1)
    if max_len is not None:
        L = min(L, max_len)
    cl = np.minimum(lens, L)
    total = int(cl.sum())
    rows = np.repeat(np.arange(n), cl)
    ends = np.cumsum(cl)
    local = np.arange(total, dtype=np.int64) - np.repeat(ends - cl, cl)
    mat = np.zeros((n, L), dtype=np.uint8)
    mat[rows, local] = bu8[np.repeat(starts, cl) + local]
    return mat, cl.astype(np.int32)


def pack_tokens_batch(tokens: list[bytes], max_len: int = MAX_TOKEN_BYTES
                      ) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized :func:`pack_tokens`: each token cut to ``max_len`` and
    zero-padded to it by one ``ljust``, then one ``b"".join`` into the
    matrix: no per-token numpy call and no scatter.  The ingest's flush
    batches and the query waves both pack through it."""
    n = len(tokens)
    mat = np.frombuffer(bytearray(b"".join(
        [t[:max_len].ljust(max_len, b"\0") for t in tokens])),
        dtype=np.uint8).reshape(n, max_len)
    lengths = np.minimum(np.fromiter(map(len, tokens), dtype=np.int32,
                                     count=n), max_len)
    return mat, lengths
