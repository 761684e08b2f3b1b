"""Runnable examples of the port: ``python -m repro_torch.examples.<name>``
(the GPU by default, ``--device cpu`` for the CPU)."""
