"""embedding_bag kernel: ops.py (wrapper) + ref.py (plain version)."""
