"""Batched log storage: compression, the stores, the dataset generator."""
