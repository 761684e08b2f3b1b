"""token_hash kernel: ops.py (wrapper) + ref.py (plain version)."""
