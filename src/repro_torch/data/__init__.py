"""Deterministic training-data pipeline (checkpointable, sketch-filtered)."""
from .pipeline import LMTokenPipeline, SketchFilteredCorpus

__all__ = ["LMTokenPipeline", "SketchFilteredCorpus"]
