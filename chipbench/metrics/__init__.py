"""Per-layer metric readers, one file a metric, named as the metric.

Each holds ``read(obs) -> float | None``: ``obs`` is what the run observed
(its driver's counters, the benchmark's spans under ``"spans"``, the
device trace's reduction under ``"device"``); a reader that finds nothing to
read returns None and the metric is left out of the result."""
