"""Baselines the paper compares against: inverted index (Lucene analogue),
CSC sketch (Li et al. SIGMOD'21), per-batch Bloom filters, linear scan
(the scan store lives in logstore.store)."""
from .bloom import BloomPerBatch
from .csc import CSCSketch
from .inverted import InvertedIndex

__all__ = ["BloomPerBatch", "CSCSketch", "InvertedIndex"]
