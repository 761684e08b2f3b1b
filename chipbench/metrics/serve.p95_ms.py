"""95th percentile of the client-side latency of every query answered in
the traced window, in ms (the benchmark's clock)."""
import numpy as np


def read(obs):
    lat = obs.get("latencies_s")
    if lat is None or not len(lat):
        return None
    return float(np.percentile(lat, 95) * 1e3)
