"""Compressed batch bytes a line of the finished store
(``IngestStats.data_bytes`` over lines): what the post-filter reads."""


def read(obs):
    if not obs.get("n_lines") or "data_bytes" not in obs:
        return None
    return obs["data_bytes"] / obs["n_lines"]
