"""Share of the window the writer spent in ``ingest.compress_append`` spans, %, from the
benchmark's spans around the store's ``_write_batch`` (compress, blob append)."""


def read(obs):
    spans = obs.get("spans")
    if spans is None or not obs.get("window_s"):
        return None
    return 100.0 * spans.seconds("ingest.compress_append") / obs["window_s"]
