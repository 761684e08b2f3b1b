"""Tokens indexed a line ingested in the window
(``IngestStats.n_tokens_indexed``)."""


def read(obs):
    if not obs.get("lines") or "tokens" not in obs:
        return None
    return obs["tokens"] / obs["lines"]
