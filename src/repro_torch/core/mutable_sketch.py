"""The mutable (ingest-time) DynaWarp sketch — faithful to §3.2/§4.1.

Components:
  * token map   : fingerprint -> directly-encoded first posting | list ptr
  * posting lists: deduplicated `PostingList`s with token ref-counts
  * lookup map  : open-addressing table keyed by the commutative postings
                  hash, with the linear-probing insert (Algorithm 1) and
                  back-shifting removal (Algorithm 2) from the paper.

This implementation keeps the paper's *online* structure and algorithms
exactly (including collision probing).  The vectorized batch builder in
``batch_builder.py`` produces the identical deduplicated result via
sort-based grouping; tests assert equivalence.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .hashing import U64, posting_element_hash, token_fingerprint
from .postings import PostingList

_DIRECT = 0  # token-map value tag: directly encoded single posting
_LIST = 1    # token-map value tag: pointer to a posting list


class LookupMap:
    """Open-addressing postings-hash -> posting-list table (Algorithms 1/2).

    Slots are sparse (a dict keyed by the 64-bit probe position), which
    preserves the paper's probing semantics without preallocating 2^64
    slots.  Hash arithmetic wraps at 2^64 as noted in §4.1.
    """

    def __init__(self):
        self._slots: dict[int, PostingList] = {}

    def __len__(self) -> int:
        return len(self._slots)

    def insert(self, plist: PostingList) -> PostingList:
        """Algorithm 1.  Returns the canonical list (an existing equal list,
        with its token count bumped, or ``plist`` newly stored)."""
        h = plist.postings_hash & U64
        while h in self._slots:               # skip colliding entries
            cand = self._slots[h]
            if cand is plist or cand.equals_postings(plist):
                cand.token_count += 1
                return cand
            h = (h + 1) & U64                 # hash collision found
        plist.token_count += 1
        self._slots[h] = plist
        return plist

    def remove(self, plist: PostingList) -> None:
        """Algorithm 2: locate, delete, then back-shift colliding entries."""
        h = plist.postings_hash & U64
        while h in self._slots:               # find correct entry
            if self._slots[h] is plist:
                del self._slots[h]
                break
            h = (h + 1) & U64
        else:                                  # not stored (single-owner ext.)
            return
        h_f = h                                # freed entry
        h = (h + 1) & U64
        while h in self._slots:               # move colliders closer
            cand = self._slots[h]
            h_c = cand.postings_hash & U64
            # wraparound-aware "intended slot is at or before the free slot"
            if _probe_dist(h_c, h_f) <= _probe_dist(h_c, h):
                del self._slots[h]
                self._slots[h_f] = cand
                h_f = h
            h = (h + 1) & U64

    def find(self, postings_hash: int, count: int, probe) -> PostingList | None:
        """Probe for a list with the given hash whose postings satisfy
        ``probe(candidate) -> bool`` (exact equality check by the caller)."""
        h = postings_hash & U64
        while h in self._slots:
            cand = self._slots[h]
            if cand.postings_hash == postings_hash and len(cand) == count \
                    and probe(cand):
                return cand
            h = (h + 1) & U64
        return None

    def lists(self):
        return self._slots.values()


def _probe_dist(intended: int, slot: int) -> int:
    """Forward probing distance from ``intended`` to ``slot`` (mod 2^64)."""
    return (slot - intended) & U64


@dataclass
class SketchStats:
    tokens: int = 0
    token_posting_inserts: int = 0
    duplicate_inserts: int = 0
    lists_created: int = 0
    lists_deallocated: int = 0

    def as_dict(self):
        return self.__dict__.copy()


class MutableSketch:
    """Ingest-time sketch: add (token, posting) pairs, then ``seal()``."""

    def __init__(self, *, short_list_threshold: int = 16):
        self.token_map: dict[int, tuple[int, object]] = {}
        self.lookup = LookupMap()
        self.threshold = short_list_threshold
        self.stats = SketchStats()
        self.max_posting = -1

    # -- ingest ---------------------------------------------------------------
    def add_token(self, token: bytes, posting: int) -> None:
        self.add_fingerprint(token_fingerprint(token), posting)

    def add_line(self, tokens, posting: int) -> None:
        for t in tokens:
            self.add_token(t, posting)

    def add_fingerprint(self, fp: int, posting: int) -> None:
        self.stats.token_posting_inserts += 1
        self.max_posting = max(self.max_posting, posting)
        entry = self.token_map.get(fp)
        if entry is None:
            # first posting is directly encoded inside the token-map value
            self.token_map[fp] = (_DIRECT, posting)
            self.stats.tokens += 1
            return
        tag, val = entry
        if tag == _DIRECT:
            if val == posting:
                self.stats.duplicate_inserts += 1
                return
            plist = self._find_or_create({val, posting})
            self.token_map[fp] = (_LIST, plist)
            return
        plist: PostingList = val
        if posting in plist:
            self.stats.duplicate_inserts += 1
            return
        self._extend(fp, plist, posting)

    def _find_or_create(self, postings: set[int]) -> PostingList:
        """Find an existing deduplicated list with exactly ``postings`` or
        create + register one.  Token count is incremented by the lookup map."""
        h = 0
        for p in postings:
            h ^= posting_element_hash(p)
        existing = self.lookup.find(
            h, len(postings), lambda c: set(int(x) for x in c.postings()) == postings)
        if existing is not None:
            existing.token_count += 1
            return existing
        plist = PostingList(self.threshold)
        for p in sorted(postings):
            plist.add(p)
        self.stats.lists_created += 1
        return self.lookup.insert(plist)

    def _extend(self, fp: int, plist: PostingList, posting: int) -> None:
        """Extend the posting set of ``fp`` by ``posting`` with online dedup
        (§3.2): constant-time target hash via the commutative XOR update."""
        target_hash = (plist.postings_hash ^ posting_element_hash(posting)) & U64
        target_count = len(plist) + 1
        existing = self.lookup.find(
            target_hash, target_count,
            lambda c: posting in c and _is_superset(c, plist))
        if existing is not None and existing is not plist:
            existing.token_count += 1
            self._release(plist)
            self.token_map[fp] = (_LIST, existing)
            return
        if plist.token_count == 1:
            # sole owner: extend in place; its hash changes -> re-slot
            self.lookup.remove(plist)
            plist.token_count -= 1
            plist.add(posting)
            canonical = self.lookup.insert(plist)
            self.token_map[fp] = (_LIST, canonical)
            return
        # shared list: copy-on-write for this token only
        plist.token_count -= 1
        new_list = plist.copy_with(posting)
        self.stats.lists_created += 1
        canonical = self.lookup.insert(new_list)
        self.token_map[fp] = (_LIST, canonical)

    def _release(self, plist: PostingList) -> None:
        plist.token_count -= 1
        if plist.token_count <= 0:
            self.lookup.remove(plist)
            self.stats.lists_deallocated += 1

    # -- queries (Algorithm 3 support) -----------------------------------------
    def is_present(self, fp: int) -> bool:
        return fp in self.token_map

    def acquire_postings(self, fp: int) -> np.ndarray | None:
        entry = self.token_map.get(fp)
        if entry is None:
            return None
        tag, val = entry
        if tag == _DIRECT:
            return np.asarray([val], dtype=np.int64)
        return val.postings()

    # -- seal -------------------------------------------------------------------
    def seal(self) -> "SealedContent":
        """Materialize the deduplicated token->list mapping (all direct
        entries promoted to real single-posting lists, §3.3) for the
        immutable-sketch builder."""
        singles: dict[int, int] = {}   # posting -> list index
        lists: list[np.ndarray] = []
        refcounts: list[int] = []
        id_by_obj: dict[int, int] = {}
        fps = np.empty(len(self.token_map), dtype=np.uint32)
        list_ids = np.empty(len(self.token_map), dtype=np.int64)
        for i, (fp, (tag, val)) in enumerate(sorted(self.token_map.items())):
            fps[i] = fp
            if tag == _DIRECT:
                li = singles.get(val)
                if li is None:
                    li = len(lists)
                    singles[val] = li
                    lists.append(np.asarray([val], dtype=np.int64))
                    refcounts.append(0)
                list_ids[i] = li
                refcounts[li] += 1
            else:
                key = id(val)
                li = id_by_obj.get(key)
                if li is None:
                    li = len(lists)
                    id_by_obj[key] = li
                    lists.append(val.postings())
                    refcounts.append(0)
                list_ids[i] = li
                refcounts[li] += 1
        return SealedContent(
            fps=fps, list_ids=list_ids, lists=lists,
            refcounts=np.asarray(refcounts, dtype=np.int64),
            n_postings=self.max_posting + 1,
            stats=self.stats.as_dict())

    def memory_bytes(self) -> int:
        token_map = len(self.token_map) * 8  # 4B key + 4B value (§4.1)
        lookup = len(self.lookup) * 16
        lists = sum(pl.memory_bytes() for pl in self.lookup.lists())
        return token_map + lookup + lists


def _is_superset(candidate: PostingList, base: PostingList) -> bool:
    return all(int(p) in candidate for p in base.postings())


@dataclass
class SealedContent:
    """Deduplicated content of a sealed sketch, input to the immutable build."""
    fps: np.ndarray          # (T,) uint32 token fingerprints, sorted unique
    list_ids: np.ndarray     # (T,) int64 posting-list id per token
    lists: list              # list of int64 arrays (sorted postings)
    refcounts: np.ndarray    # (L,) tokens referencing each list
    n_postings: int
    stats: dict = field(default_factory=dict)

    def canonical_lists(self) -> list[tuple]:
        return [tuple(int(x) for x in l) for l in self.lists]
