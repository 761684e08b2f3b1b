"""bitmap_extract kernel: ops.py (wrapper) + ref.py (plain version)."""
