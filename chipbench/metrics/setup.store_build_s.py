"""Seconds set-up spent building the served store: ``ingest()`` of the
corpus and ``finish()`` (the benchmark's clock)."""


def read(obs):
    return obs.get("store_build_s")
