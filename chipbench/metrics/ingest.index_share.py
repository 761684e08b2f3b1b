"""Share of the window the writer spent in ``ingest.index`` spans, %, from the
benchmark's spans around the store's ``_index_batch`` (tokenize, fingerprint, sketch buffer)."""


def read(obs):
    spans = obs.get("spans")
    if spans is None or not obs.get("window_s"):
        return None
    return 100.0 * spans.seconds("ingest.index") / obs["window_s"]
