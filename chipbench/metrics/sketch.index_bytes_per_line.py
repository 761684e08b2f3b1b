"""Sketch bytes a line of the finished store (``index_bytes()`` over
lines)."""


def read(obs):
    if not obs.get("n_lines") or "index_bytes" not in obs:
        return None
    return obs["index_bytes"] / obs["n_lines"]
