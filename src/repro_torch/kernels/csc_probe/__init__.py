"""csc_probe kernel: ops.py (wrapper) + ref.py (plain version)."""
