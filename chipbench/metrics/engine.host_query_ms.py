"""Mean time of one query on the engine's host path
(``QueryEngine.host_query``), in ms, from the benchmark's spans."""


def read(obs):
    spans = obs.get("spans")
    n = spans and sum(1 for r in spans.records if r[0] == "wave.host")
    if not n:
        return None
    return 1e3 * spans.seconds("wave.host") / n
