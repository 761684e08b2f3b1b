"""Mean time of one post-filter call (``_post_filter``: decompress, lower
and scan a query's candidate batches), in ms, from the benchmark's spans;
calls overlap across client threads and share the interpreter lock."""


def read(obs):
    spans = obs.get("spans")
    n = spans and sum(1 for r in spans.records if r[0] == "postfilter")
    if not n:
        return None
    return 1e3 * spans.seconds("postfilter") / n
