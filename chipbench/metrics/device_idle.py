"""Share of the traced window in which no kernel or copy ran on the card,
%.  One reader for every ``device_idle.<split>`` metric: the quantity is
split by the end-to-end metric it moves (``.serve``, ``.ingest``)."""


def read(obs):
    dev = obs.get("device", {})
    if "busy_s" not in dev:
        return None
    return 100.0 * (1.0 - dev["busy_s"] / dev["window_s"])
