"""bitset_ops kernel: ops.py (wrapper) + ref.py (plain version)."""
