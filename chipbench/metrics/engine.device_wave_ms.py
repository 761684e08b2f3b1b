"""Mean time of one device wave (``QueryEngine.query_fps_batch``: pack,
probe every segment, fold, extract, copy back), in ms, from the benchmark's
spans."""


def read(obs):
    spans = obs.get("spans")
    n = spans and sum(1 for r in spans.records if r[0] == "wave.device")
    if not n:
        return None
    return 1e3 * spans.seconds("wave.device") / n
