"""Share of the window inside ``ingest()`` calls that spilled, %: the
writer stalled while the 32 MB sketch buffer was sealed into a segment and
published (the benchmark's clock, cut at the window's end)."""


def read(obs):
    if "spill_call_s" not in obs or not obs.get("window_s"):
        return None
    return 100.0 * obs["spill_call_s"] / obs["window_s"]
