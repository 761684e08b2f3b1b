"""Closed-loop clients of a finished store, through its serving front end.

Set-up builds the configuration's store from the corpus (ingest and
``finish()``), starts ``store.serving()`` at the configuration's knobs and
warms it.  In the window each of ``clients`` threads sends its next term
query (``StoreServer.query_term``; ``batch`` terms in one
``query_term_batch`` call where the mix gives ``batch`` over 1) when the
answer to its last one has returned, until the window closes; each query's
client-side latency (its call's) and answer are kept.  A client's stream
holds ``queries_per_client`` distinct draws and is never sent twice: a
client that reaches its end fails the run.  Every answer is compared with
the reference once the window has closed.
"""
from __future__ import annotations

import gc
import threading
import time

import numpy as np

from ..corpus import make_corpus
from ..reference.check import batch_granular, compare
from ..reference.terms import TermIndex
from . import terms as term_kinds


def make_inputs(config: dict, traffic: dict, seed: int) -> dict:
    """The corpus and every client's term stream, from the seed."""
    corpus = make_corpus(seed, n_lines=config["n_lines"], **config["corpus"])
    k = traffic["clients"]
    window = term_kinds.draw(corpus, traffic["mix"],
                             np.random.default_rng([seed, 1]),
                             k * traffic["queries_per_client"])
    warm = term_kinds.draw(corpus, traffic["mix"],
                           np.random.default_rng([seed, 2]),
                           k * traffic["warm_queries_per_client"])
    return {"corpus": corpus, "streams": [window[i::k] for i in range(k)],
            "warm_streams": [warm[i::k] for i in range(k)]}


def prepare(config, traffic, cell, seed, device) -> dict:
    from repro_torch.core.serving import CostModel
    from repro_torch.core.tokenizer import term_query_tokens
    from repro_torch.logstore.store import DynaWarpStore

    t0 = time.perf_counter()
    ctx = make_inputs(config, traffic, seed)
    ctx.update(config=config, traffic=traffic, device=device,
               setup_parts={"inputs_s": time.perf_counter() - t0})
    t0 = time.perf_counter()
    store = DynaWarpStore(**config["store"], device=device)
    store.ingest(ctx["corpus"].lines)
    store.finish()
    ctx["setup_parts"]["store_build_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    serve = dict(config["serve"])
    path = serve.pop("cost_model_path")
    server = store.serving(
        **serve, cost_model=None if path is None else CostModel.load(path))
    # every wave size the front end can form, twice (both replicas), then
    # the traffic itself
    for b in serve["bucket_sizes"]:
        toks = [term_query_tokens(t) for t in ctx["warm_streams"][0][:b]]
        for _ in range(2):
            server.scheduler.query_batch(toks, timeout=traffic["timeout_s"])
    _loop(_call(server, traffic["batch"]), ctx["warm_streams"],
          cell["warmup_s"], traffic["timeout_s"], traffic["batch"])
    ctx.update(store=store, server=server)
    ctx["setup_parts"]["warmup_s"] = time.perf_counter() - t0
    # the corpus is the benchmark's, not the store's: keep the cyclic
    # collector's full passes over its million strings out of the window
    gc.collect()
    gc.freeze()
    return ctx


def _call(server, batch: int):
    """The client's call: ``batch`` terms in, their results out."""
    if batch > 1:
        return server.query_term_batch
    return lambda terms, timeout: [server.query_term(terms[0],
                                                     timeout=timeout)]


def _loop(query, streams, seconds: float, timeout: float, batch: int):
    """Run one client thread a stream for ``seconds``, ``batch`` terms a
    call of ``query``: (start, records [(term, sent, answered, result)] a
    client, failures a client, the first failure, whether a client ran
    out of its stream)."""
    go = threading.Event()
    end = [0.0]
    records = [[] for _ in streams]
    failures = [0] * len(streams)
    first_error = []
    ran_out = []

    def client(i):
        stream, out, k = streams[i], records[i], 0
        go.wait()
        while True:
            sent = time.perf_counter()
            if sent >= end[0]:
                return
            if k + batch > len(stream):
                ran_out.append(i)
                return
            terms = stream[k:k + batch]
            k += batch
            try:
                results = query(terms, timeout=timeout)
            except Exception as e:     # counted as failed; the loop goes on
                failures[i] += batch
                first_error.append(repr(e))
                continue
            done = time.perf_counter()
            out.extend((t, sent, done, r) for t, r in zip(terms, results))

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(len(streams))]
    for t in threads:
        t.start()
    start = time.perf_counter()
    end[0] = start + seconds
    go.set()
    for t in threads:
        t.join(seconds + timeout + 60)
    if any(t.is_alive() for t in threads):
        raise RuntimeError("a client did not return within a minute past "
                           "its query's timeout")
    return start, records, failures, first_error[:1], bool(ran_out)


def window(ctx, seconds: float, spans) -> dict:
    from repro_torch.core.query_engine import QueryEngine
    from repro_torch.logstore.store import DynaWarpStore

    server = ctx["server"]
    if spans is not None:
        spans.wrap(DynaWarpStore, "_post_filter", "postfilter")
        spans.wrap(QueryEngine, "query_fps_batch", "wave.device")
        spans.wrap(QueryEngine, "host_query", "wave.host")
    before = server.scheduler.stats()
    start, records, failures, error, ran_out = _loop(
        _call(server, ctx["traffic"]["batch"]), ctx["streams"], seconds,
        ctx["traffic"]["timeout_s"], ctx["traffic"]["batch"])
    if ran_out:
        raise RuntimeError("a client sent its whole stream inside the "
                           "window: raise queries_per_client")
    after = server.scheduler.stats()
    end = start + seconds
    flat = [r for client in records for r in client]
    done = np.array([r[2] for r in flat])
    store = ctx["store"]
    ctx["outputs"] = ([r[0] for r in flat], [r[3].matches for r in flat])
    answered = int((done <= end).sum())
    return {
        "e2e": {"query_qps": answered / seconds},
        "answered": answered,
        "attempted": len(flat) + sum(failures),
        "failed": sum(failures),
        "first_error": error,
        "latencies_s": done - np.array([r[1] for r in flat]),
        "candidate_batches": np.array([len(r[3].candidate_batches)
                                       for r in flat]),
        "fp_batches": np.array([r[3].false_positive_batches for r in flat]),
        "waves": after.waves - before.waves,
        "device_waves": after.device_waves - before.device_waves,
        "wave_queries": after.completed - before.completed,
        "index_bytes": store.index_bytes(),
        "data_bytes": store.stats.data_bytes,
        "n_lines": len(ctx["corpus"].lines),
        "store_build_s": ctx["setup_parts"]["store_build_s"],
    }


def finish(ctx) -> None:
    """Stop serving and drop the program's state."""
    ctx.pop("server").close()
    ctx.pop("store")
    gc.unfreeze()
    gc.collect()


def check(ctx, outputs=None) -> dict:
    terms, got = outputs if outputs is not None else ctx["outputs"]
    lines = ctx["corpus"].lines
    index = TermIndex(lines, {len(t) for t in terms})
    memo = {}
    want = [memo[t] if t in memo else memo.setdefault(t, index.lines_with(t))
            for t in terms]
    return compare(got, want)


def control(ctx) -> tuple[list, list]:
    """The reference in the program's place, at batch granularity, over
    every term of the window's streams."""
    terms = [t for s in ctx["streams"] for t in s]
    lines = ctx["corpus"].lines
    index = TermIndex(lines, {len(t) for t in terms})
    want = [index.lines_with(t) for t in terms]
    return terms, batch_granular(want, ctx["config"]["store"]["batch_lines"],
                                 len(lines))
