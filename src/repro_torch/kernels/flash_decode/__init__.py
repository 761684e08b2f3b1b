"""flash_decode kernel: ops.py (wrapper) + ref.py (plain version)."""
