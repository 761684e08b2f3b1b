"""Vectorized batch construction of the deduplicated sketch content.

The paper's mutable sketch performs *online* dedup with pointer-chasing hash
tables.  The same deduplicated result is produced here by sort-based
grouping over numpy arrays:

  1. unique (fingerprint, posting) pairs            -> sort / unique
  2. group postings by fingerprint                  -> segment boundaries
  3. per-group commutative XOR postings hash        -> segmented XOR reduce
  4. dedup groups by (hash, length, content)        -> lexsort + vectorized
     content verification against each run head (64-bit hash collisions
     within a (hash, count) run fall back to an exact per-run host pass)

All four steps are vector ops.  Tests assert the output is *identical* (same
lists, same ref-counts, same token mapping) to the faithful online
`MutableSketch`.

The module also hosts the columnar ingest front-end
(:class:`LineFingerprinter`): whole flush batches of log lines are
tokenized once per *unique* line, all new tokens are packed into one
(N, 64) u8 matrix and fingerprinted with a single vectorized rolling-hash
pass — no per-token python hashing on the hot path.  On a CUDA device that
pass is the ``token_hash`` kernel; on the CPU it is numpy.
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from .. import trace
from ..kernels.token_hash.ops import token_fingerprints
from .hashing import (np_posting_element_hash, np_token_fingerprints,
                      np_window_fingerprints)
from .mutable_sketch import SealedContent
from .tokenizer import (_ALNUM, _PUNCT, _SEPARATORS, MAX_TOKEN_BYTES,
                        pack_slices, pack_tokens_batch,
                        tokenize_lines_columnar)


def token_matrix_fingerprints(mat: np.ndarray, lengths: np.ndarray,
                              device: torch.device) -> np.ndarray:
    """u32 fingerprints of a packed (N, L) u8 token matrix: numpy on the
    CPU; on a CUDA device the ``token_hash`` kernel, fed by one
    host-to-device copy (matrix and lengths share one buffer), one launch
    and one copy back."""
    sp = trace.ON and trace.begin("ingest.token_hash")
    if device.type == "cpu":
        out = np_token_fingerprints(mat, lengths)
    else:
        n, l = mat.shape
        head = -(-mat.size // 4) * 4      # the lengths start 4-byte aligned
        buf = np.zeros(head + 4 * n, np.uint8)
        buf[:mat.size] = mat.reshape(-1)
        buf[head:] = np.ascontiguousarray(lengths, np.int32).view(np.uint8)
        dev = torch.from_numpy(buf).to(device)
        fps = token_fingerprints(dev[:mat.size].view(n, l),
                                 dev[head:].view(torch.int32))
        out = fps.cpu().numpy().view(np.uint32)
    if sp:
        trace.end(sp)
    return out


def fingerprint_tokens(tokens: list[bytes], *, device: torch.device
                       ) -> np.ndarray:
    """Vectorized 4-byte fingerprints of a token batch (one pack + one
    rolling-hash sweep; bit-identical to scalar ``token_fingerprint``)."""
    max_len = min(MAX_TOKEN_BYTES,
                  max((len(t) for t in tokens), default=1))
    mat, lengths = pack_tokens_batch(tokens, max(max_len, 1))
    return token_matrix_fingerprints(mat, lengths, device)


def wave_fingerprints(token_lists, *, device: torch.device
                      ) -> tuple[np.ndarray, np.ndarray]:
    """A query wave's tokens -> (flat u32 fingerprints, query after query,
    and (Q,) int64 token counts).  The ``bytes`` tokens are hashed whole
    (no cut: each fingerprint equals scalar ``token_fingerprint``) by
    ``_hash_whole_tokens``, one ``token_hash`` launch on a CUDA device for
    a wave of tokens of at most MAX_TOKEN_BYTES (numpy on the CPU); any
    other token is an integer fingerprint and passes through."""
    lens = np.fromiter(map(len, token_lists), dtype=np.int64,
                       count=len(token_lists))
    flat = [tok for toks in token_lists for tok in toks]
    if set(map(type, flat)) <= {bytes, bytearray}:     # the common wave
        return _hash_whole_tokens(flat, device), lens
    is_bytes = np.fromiter((isinstance(tok, (bytes, bytearray))
                            for tok in flat), dtype=bool, count=len(flat))
    fps = np.zeros(len(flat), np.uint32)
    fps[is_bytes] = _hash_whole_tokens(
        [tok for tok, b in zip(flat, is_bytes) if b], device)
    ints = [int(tok) for tok, b in zip(flat, is_bytes) if not b]
    fps[~is_bytes] = np.fromiter(ints, dtype=np.uint64,
                                 count=len(ints)).astype(np.uint32)
    return fps, lens


def _hash_whole_tokens(tokens, device: torch.device) -> np.ndarray:
    """u32 fingerprints of whole byte tokens.  Tokens of at most
    MAX_TOKEN_BYTES share one matrix at the longest one's width (one
    launch); each longer size class packs into its own power-of-two width
    bucket, so one long raw token pads only its own bucket, never the
    wave."""
    if not tokens:
        return np.zeros(0, np.uint32)
    lens = np.fromiter(map(len, tokens), dtype=np.int64, count=len(tokens))
    # frexp exponent == bit_length for positive ints (exact below 2^53)
    tier = np.where(lens <= MAX_TOKEN_BYTES, 0,
                    np.frexp(lens.astype(np.float64))[1])
    fps = np.empty(len(tokens), np.uint32)
    for t in np.unique(tier):
        sel = np.flatnonzero(tier == t)
        part = tokens if sel.size == len(tokens) else [tokens[i] for i in sel]
        mat, lengths = pack_tokens_batch(part, max(int(lens[sel].max()), 1))
        fps[sel] = token_matrix_fingerprints(mat, lengths, device)
    return fps


_SEP_U8 = np.frombuffer("".join(sorted(_SEPARATORS)).encode(),
                        dtype=np.uint8)
# n-gram run matrices are packed in power-of-two length buckets above this
# cap, so one pathological long run (minified JSON, base64 blobs) inflates
# only its own bucket; runs at or below the cap (the overwhelming common
# case) share one bucket whose padding is bounded by the cap itself
_NGRAM_PACK_CAP = 32


def _window_fps_bucketed(bu8: np.ndarray, starts: np.ndarray,
                         lens: np.ndarray, run_line: np.ndarray,
                         widths: tuple[int, ...], fp_parts: list,
                         ln_parts: list) -> None:
    """Byte-window n-gram fingerprints of (start, len) runs, appended to
    (fp_parts, ln_parts) per width.  Runs are grouped into one bucket for
    everything <= _NGRAM_PACK_CAP plus a power-of-two width bucket per
    longer size class, each packed at its own width."""
    sp = trace.ON and trace.begin("ingest.ngram")
    # frexp exponent == bit_length for positive ints (exact below 2^53)
    tier = np.where(lens <= _NGRAM_PACK_CAP, 0,
                    np.frexp(lens.astype(np.float64))[1])
    for t in np.unique(tier):
        sel = tier == t
        s2, l2, rl = starts[sel], lens[sel], run_line[sel]
        mat, cl = pack_slices(bu8, s2, l2)
        for n in widths:
            rows, fps = np_window_fingerprints(mat, cl, n)
            fp_parts.append(fps)
            ln_parts.append(rl[rows])
    if sp:
        trace.end(sp)


def _fingerprint_lines_ascii(lowers: list[str], *, ngrams: bool,
                             device: torch.device) -> list[np.ndarray]:
    """Flat-blob columnar path for all-ASCII lowered lines: ONE regex pass
    per token class over the newline-joined blob (newline belongs to no
    token class and is not a rule-4/5 separator, so line boundaries cannot
    leak), then pure array ops — slice packing, vectorized rolling-hash
    fingerprints, byte-window n-grams, and a lexsort per-line dedup."""
    blob = "\n".join(lowers)
    bu8 = np.frombuffer(blob.encode(), dtype=np.uint8)
    line_lens = np.fromiter((len(l) for l in lowers), dtype=np.int64,
                            count=len(lowers))
    line_starts = np.concatenate([[0], np.cumsum(line_lens + 1)[:-1]])

    sa = np.asarray([m.span() for m in _ALNUM.finditer(blob)],
                    dtype=np.int64).reshape(-1, 2)
    sp = np.asarray([m.span() for m in _PUNCT.finditer(blob)],
                    dtype=np.int64).reshape(-1, 2)
    a_line = np.searchsorted(line_starts, sa[:, 0], side="right") - 1
    p_line = np.searchsorted(line_starts, sp[:, 0], side="right") - 1
    a_len = sa[:, 1] - sa[:, 0]
    p_len = sp[:, 1] - sp[:, 0]

    # rules 4/5: consecutive alnum runs joined by one separator / '.' —
    # runs from different lines are separated by at least the newline,
    # which is not a separator, so no per-line grouping is needed
    gap1 = (sa[1:, 0] - sa[:-1, 1]) == 1 if len(sa) > 1 else \
        np.empty(0, bool)
    sep = bu8[sa[:-1, 1]] if len(sa) > 1 else np.empty(0, np.uint8)
    r4 = gap1 & np.isin(sep, _SEP_U8)
    dot = gap1 & (sep == ord("."))
    r5 = dot[:-1] & dot[1:] if len(dot) > 1 else np.empty(0, bool)

    term_starts = [sa[:, 0], sp[:, 0], sa[:-1, 0][r4], sa[:-2, 0][r5]]
    term_lens = [a_len, p_len,
                 sa[1:, 1][r4] - sa[:-1, 0][r4],
                 sa[2:, 1][r5] - sa[:-2, 0][r5]]
    term_lines = [a_line, p_line, a_line[:-1][r4], a_line[:-2][r5]]
    starts = np.concatenate(term_starts)
    lens = np.concatenate(term_lens)
    mat, cl = pack_slices(bu8, starts, lens, MAX_TOKEN_BYTES)
    fp_parts = [token_matrix_fingerprints(mat, cl, device)]
    ln_parts = [np.concatenate(term_lines)]

    if ngrams:
        _window_fps_bucketed(bu8, sa[:, 0], a_len, a_line, (3,),
                             fp_parts, ln_parts)
        _window_fps_bucketed(bu8, sp[:, 0], p_len, p_line, (1, 2, 3),
                             fp_parts, ln_parts)

    return _split_unique_per_line(np.concatenate(fp_parts),
                                  np.concatenate(ln_parts), len(lowers))


def _split_unique_per_line(fps: np.ndarray, lns: np.ndarray,
                           n_lines: int) -> list[np.ndarray]:
    """One lexsort dedup over (line, fp) pairs -> per-line fp arrays.
    Chunks are copies, not views, so the LRU does not pin each batch's
    whole concatenated array via a single surviving cached line."""
    sp = trace.ON and trace.begin("ingest.dedup")
    order = np.lexsort((fps, lns))
    fps, lns = fps[order], lns[order]
    keep = np.ones(fps.shape, dtype=bool)
    keep[1:] = (fps[1:] != fps[:-1]) | (lns[1:] != lns[:-1])
    fps, lns = fps[keep], lns[keep]
    counts = np.bincount(lns, minlength=n_lines)
    out = [c.copy() for c in np.split(fps, np.cumsum(counts)[:-1])]
    if sp:
        trace.end(sp)
    return out


def fingerprint_lines_columnar(lines, *, ngrams: bool = True,
                               device: torch.device) -> list[np.ndarray]:
    """Per-line unique token fingerprints for a batch of lines, fully
    columnar: one regex pass per line for runs/terms, one vectorized
    rolling-hash over the packed term matrix, and vectorized byte-window
    hashing for the rule-6/7 n-grams — then one lexsort dedup per batch
    instead of per-token set churn."""
    (tokens, tok_line, alnum_runs, alnum_line,
     punct_runs, punct_line) = tokenize_lines_columnar(lines, ngrams=ngrams)
    fp_parts = [fingerprint_tokens(tokens, device=device)]
    ln_parts = [np.asarray(tok_line, dtype=np.int64)]
    if ngrams:
        for runs, run_line, widths in ((alnum_runs, alnum_line, (3,)),
                                       (punct_runs, punct_line, (1, 2, 3))):
            if not runs:
                continue
            flat = np.frombuffer(b"".join(runs), dtype=np.uint8)
            rlens = np.fromiter((len(r) for r in runs), dtype=np.int64,
                                count=len(runs))
            rstarts = np.concatenate([[0], np.cumsum(rlens[:-1])])
            _window_fps_bucketed(flat, rstarts, rlens,
                                 np.asarray(run_line, dtype=np.int64),
                                 widths, fp_parts, ln_parts)
    return _split_unique_per_line(np.concatenate(fp_parts),
                                  np.concatenate(ln_parts), len(lines))


class LineFingerprinter:
    """Columnar tokenize -> fingerprint over batches of log lines.

    Lines repeat heavily in real traffic, so unique lines are fingerprinted
    once and memoized in a bounded LRU; cache misses within a batch share a
    single vectorized fingerprint dispatch over their concatenated tokens,
    on ``device`` (the ``token_hash`` kernel on CUDA, numpy on the CPU).
    The n-gram windows are hashed on the host either way.
    """

    def __init__(self, *, device, ngrams: bool = True,
                 cache_size: int = 65536):
        self.device = torch.device(device)
        self.ngrams = ngrams
        self._cache: OrderedDict[str, np.ndarray] = OrderedDict()
        self._cache_cap = cache_size

    def fingerprint_lines(self, lines) -> tuple[np.ndarray, np.ndarray]:
        """(flat fps concatenated line-by-line, per-line token counts)."""
        sp = trace.ON and trace.begin("ingest.tokenize")
        per_line: list[np.ndarray | None] = []
        miss_lines: list[str] = []
        miss_slots: dict[str, list[int]] = {}
        for i, line in enumerate(lines):
            hit = self._cache.get(line)
            if hit is not None:
                self._cache.move_to_end(line)
                per_line.append(hit)
                continue
            per_line.append(None)
            slots = miss_slots.get(line)
            if slots is None:
                miss_slots[line] = [i]
                miss_lines.append(line)
            else:
                slots.append(i)
        if miss_lines:
            # ASCII lines (the overwhelming majority of log traffic) take
            # the flat-blob path; the rare non-ASCII lines fall back to the
            # per-line columnar pass (UTF-8 byte offsets != char offsets)
            lowers = [line.lower() for line in miss_lines]
            ascii_idx = [i for i, lo in enumerate(lowers) if lo.isascii()]
            chunks: list[np.ndarray | None] = [None] * len(miss_lines)
            if ascii_idx:
                got = _fingerprint_lines_ascii(
                    [lowers[i] for i in ascii_idx], ngrams=self.ngrams,
                    device=self.device)
                for i, chunk in zip(ascii_idx, got):
                    chunks[i] = chunk
            other_idx = [i for i in range(len(miss_lines))
                         if chunks[i] is None]
            if other_idx:
                got = fingerprint_lines_columnar(
                    [miss_lines[i] for i in other_idx], ngrams=self.ngrams,
                    device=self.device)
                for i, chunk in zip(other_idx, got):
                    chunks[i] = chunk
            for line, chunk in zip(miss_lines, chunks):
                for slot in miss_slots[line]:
                    per_line[slot] = chunk
                self._cache[line] = chunk
            while len(self._cache) > self._cache_cap:
                self._cache.popitem(last=False)
        lens = np.fromiter((len(a) for a in per_line), dtype=np.int64,
                           count=len(per_line))
        flat = (np.concatenate(per_line) if per_line
                else np.empty(0, np.uint32))
        if sp:
            trace.end(sp)
        return flat, lens


def build_sealed(fps: np.ndarray, postings: np.ndarray,
                 stats: dict | None = None) -> SealedContent:
    """Build deduplicated sealed content from parallel (fp, posting) arrays."""
    fps = np.asarray(fps, dtype=np.uint32)
    postings = np.asarray(postings, dtype=np.int64)
    if fps.shape != postings.shape:
        raise ValueError("fps and postings must be parallel 1-D arrays")
    if fps.size == 0:
        return SealedContent(
            fps=np.empty(0, np.uint32), list_ids=np.empty(0, np.int64),
            lists=[], refcounts=np.empty(0, np.int64), n_postings=0,
            stats=stats or {})

    # 1. unique (fp, posting) pairs, sorted by (fp, posting)
    pairs = (fps.astype(np.uint64) << np.uint64(32)) | postings.astype(np.uint64)
    pairs = np.unique(pairs)
    u_fps = (pairs >> np.uint64(32)).astype(np.uint32)
    u_posts = (pairs & np.uint64(0xFFFFFFFF)).astype(np.int64)

    # 2. group boundaries per fingerprint
    starts = np.flatnonzero(np.r_[True, u_fps[1:] != u_fps[:-1]])
    group_fps = u_fps[starts]
    counts = np.diff(np.r_[starts, len(u_fps)])

    # 3. commutative postings hash per group (vectorized XOR reduce)
    elem_hashes = np_posting_element_hash(u_posts)
    group_hash = np.bitwise_xor.reduceat(elem_hashes, starts)

    # 4. dedup posting lists by (hash, count): lexsort groups so equal-key
    # candidates are adjacent, verify content against each run head with
    # one flat gather + segmented reduce.  Only runs holding a true 64-bit
    # hash collision (same hash AND count, different postings) fall back
    # to the exact per-run host pass.
    ends = starts + counts
    G = len(group_fps)
    order = np.lexsort((counts, group_hash))
    oh, oc = group_hash[order], counts[order]
    same = np.zeros(G, dtype=bool)
    same[1:] = (oh[1:] == oh[:-1]) & (oc[1:] == oc[:-1])
    run_id = np.cumsum(~same) - 1
    head_pos = np.flatnonzero(~same)
    head_of = head_pos[run_id]          # sorted-position of each run head
    rep = np.arange(G, dtype=np.int64)  # canonical group per group
    cand = np.flatnonzero(same)
    if cand.size:
        gi = order[cand]
        hi = order[head_of[cand]]
        lens = counts[gi]
        total = int(lens.sum())
        seg_starts = np.cumsum(lens) - lens
        local = np.arange(total, dtype=np.int64) - np.repeat(seg_starts,
                                                             lens)
        a = u_posts[np.repeat(starts[gi], lens) + local]
        b = u_posts[np.repeat(starts[hi], lens) + local]
        mismatch = np.add.reduceat(a != b, seg_starts) > 0
        rep[gi[~mismatch]] = hi[~mismatch]
        for r in np.unique(run_id[cand[mismatch]]):
            # exact fallback: distinct contents collided on (hash, count)
            members = order[np.flatnonzero(run_id == r)]
            kept: list[int] = []
            for g in members:
                content = u_posts[starts[g]:ends[g]]
                for h in kept:
                    if np.array_equal(u_posts[starts[h]:ends[h]], content):
                        rep[g] = h
                        break
                else:
                    kept.append(g)
                    rep[g] = g
    # assign list ids in first-occurrence (fingerprint-sorted group) order,
    # matching the online sketch's seal()
    uniq_reps, inv = np.unique(rep, return_inverse=True)
    first_gi = np.full(len(uniq_reps), G, dtype=np.int64)
    np.minimum.at(first_gi, inv, np.arange(G, dtype=np.int64))
    by_first = np.argsort(first_gi, kind="stable")
    class_rank = np.empty(len(uniq_reps), dtype=np.int64)
    class_rank[by_first] = np.arange(len(uniq_reps))
    list_ids = class_rank[inv]
    refcounts = np.bincount(list_ids, minlength=len(uniq_reps))
    lists = [u_posts[starts[r]:ends[r]] for r in uniq_reps[by_first]]

    return SealedContent(
        fps=group_fps, list_ids=list_ids, lists=lists,
        refcounts=refcounts.astype(np.int64),
        n_postings=int(u_posts.max()) + 1 if len(u_posts) else 0,
        stats=stats or {})


def build_sealed_from_lines(token_sets, *, stats: dict | None = None
                            ) -> SealedContent:
    """Convenience: ``token_sets[i]`` is the token-fingerprint set of posting
    ``i``; flattens into parallel arrays and batch-builds."""
    fp_chunks, post_chunks = [], []
    for pid, fp_set in enumerate(token_sets):
        arr = np.fromiter(fp_set, dtype=np.uint32, count=len(fp_set))
        fp_chunks.append(arr)
        post_chunks.append(np.full(arr.shape, pid, dtype=np.int64))
    if not fp_chunks:
        return build_sealed(np.empty(0, np.uint32), np.empty(0, np.int64),
                            stats)
    return build_sealed(np.concatenate(fp_chunks),
                        np.concatenate(post_chunks), stats)
