"""retrieval_score kernel: ops.py (wrapper) + ref.py (plain version)."""
