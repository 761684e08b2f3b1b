"""A cell shrunk so that a run on the CPU takes seconds: what the tests
drive ``run.execute`` at (the corpus, the sketch's memory limit, the
clients and the supply scaled down; every shape and path kept)."""


def small(config: dict, traffic: dict, cell: dict) -> None:
    if "n_lines" in config:
        config["n_lines"] = 6000
    config["store"]["memory_limit_bytes"] = 96 << 10   # a spill a ~1,500 lines
    traffic.update({k: v for k, v in dict(
        clients=8, queries_per_client=2048, warm_queries_per_client=256,
        supply_lines=60_000, chunk_lines=512).items() if k in traffic})
    if "warmup_s" in cell:
        cell["warmup_s"] = 0.2
    if "warmup" in cell:
        cell["warmup"] = {"lines": 3000, "memory_limit_bytes": 32 << 10}
