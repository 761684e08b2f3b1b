"""Synthetic LogHub-style dataset generator (§5, Table 2).

The paper cannot publish its production data and instead ships a generator
that matches the statistical properties (lines-per-source distribution,
template redundancy) of production logs using the public LogHub corpus.
This module is the analogous generator: a library of realistic log
templates (HDFS / Spark / SSH / k8s flavored), Zipf-distributed source
volumes, and placeholder variables (IPs, 16-letter ids, hex ids, paths,
numbers) — everything needed to reproduce the paper's four query
scenarios (term/contains × ID/IP + extracted terms).
"""
from __future__ import annotations

import string
from dataclasses import dataclass

import numpy as np

_TEMPLATES = [
    "INFO dfs.DataNode$PacketResponder: PacketResponder {num} for block blk_{id} terminating",
    "INFO dfs.FSNamesystem: BLOCK* NameSystem.addStoredBlock: blockMap updated: {ip}:{port} is added to blk_{id} size {num}",
    "WARN dfs.DataNode: Slow BlockReceiver write packet to mirror took {num}ms (threshold=300ms)",
    "INFO spark.executor.Executor: Finished task {num}.0 in stage {num}.0 (TID {num}). {num} bytes result sent to driver",
    "INFO spark.storage.BlockManager: Found block rdd_{num}_{num} locally",
    "ERROR spark.scheduler.TaskSetManager: Task {num} in stage {num}.0 failed {num} times; aborting job",
    "INFO sshd[{num}]: Accepted publickey for {user} from {ip} port {port} ssh2: RSA SHA256:{hex}",
    "INFO sshd[{num}]: Connection closed by {ip} port {port} [preauth]",
    "WARN sshd[{num}]: Failed password for invalid user {user} from {ip} port {port} ssh2",
    "INFO kubelet: Successfully pulled image \"registry.local/{user}/{id}:v{num}\" in {num}ms",
    "ERROR kubelet: Pod \"{id}\" failed to start: container {hex} exited with code {num}",
    "INFO nginx: {ip} - - GET /api/v{num}/users/{id} HTTP/1.1 200 {num}",
    "INFO nginx: {ip} - - POST /api/v{num}/sessions HTTP/1.1 401 {num}",
    "INFO app.RequestHandler: request_id={id} user={user} latency_ms={num} status=OK",
    "WARN app.RetryPolicy: retrying request_id={id} attempt={num} backoff_ms={num}",
    "ERROR app.Db: connection to {ip}:{port} lost: timeout after {num}ms (pool={user})",
    "INFO gc: pause {num}ms heap {num}M->{num}M",
    "DEBUG cache.LRU: evicted key={hex} size={num}B age={num}s",
    "INFO auth.TokenService: issued token {hex} for tenant {user} ttl={num}s",
    "WARN quota.Limiter: tenant {user} exceeded {num} req/s, throttling request_id={id}",
]

_USERS = ["alice", "bob", "carol", "dave", "erin", "frank", "grace", "heidi",
          "ivan", "judy", "mallory", "oscar", "peggy", "trent", "victor",
          "walter", "svc-ingest", "svc-query", "svc-batch", "root"]


@dataclass
class LogDataset:
    name: str
    lines: list[str]
    sources: np.ndarray        # (N,) int32 source id per line
    seed: int

    @property
    def n_lines(self) -> int:
        return len(self.lines)

    def raw_bytes(self) -> int:
        return sum(len(l) for l in self.lines) + self.n_lines


def _rand_ip(rng) -> str:
    return ".".join(str(int(x)) for x in rng.integers(1, 255, size=4))


def _rand_id(rng, n=16) -> str:
    letters = np.frombuffer(string.ascii_lowercase.encode(), np.uint8)
    return bytes(rng.choice(letters, size=n)).decode()


def _rand_hex(rng, n=12) -> str:
    digits = np.frombuffer(b"0123456789abcdef", np.uint8)
    return bytes(rng.choice(digits, size=n)).decode()


def generate_dataset(name: str, *, n_lines: int, n_sources: int,
                     seed: int = 0, zipf_a: float = 1.4,
                     values_per_source: int = 40) -> LogDataset:
    """LogHub-style synthetic logs matching production *statistics*:
    Zipf lines-per-source, per-source template dialects, and — crucially
    for index size (§5.1.3) — per-source VALUE POOLS: real services log
    the same request ids / peers / users over and over, so variable slots
    draw from a bounded pool instead of being unique per line (a fresh
    value still appears with small probability, so needle queries remain
    meaningful)."""
    rng = np.random.default_rng(seed)
    w = 1.0 / np.arange(1, n_sources + 1) ** zipf_a
    w /= w.sum()
    source_of_line = rng.choice(n_sources, size=n_lines, p=w)
    source_of_line.sort()  # sources arrive clustered, like partitioned ingest
    tpl_per_source = [rng.choice(len(_TEMPLATES),
                                 size=int(rng.integers(2, 6)), replace=False)
                      for _ in range(n_sources)]
    pools = [dict(ip=[_rand_ip(rng) for _ in range(values_per_source)],
                  id=[_rand_id(rng) for _ in range(values_per_source)],
                  hex=[_rand_hex(rng) for _ in range(values_per_source)])
             for _ in range(n_sources)]

    def draw(pool, kind):
        if rng.random() < 0.02:  # rare fresh value (long-tail ids)
            return {"ip": _rand_ip, "id": _rand_id,
                    "hex": _rand_hex}[kind](rng)
        return pool[kind][int(rng.integers(len(pool[kind])))]

    lines = []
    for i in range(n_lines):
        src = int(source_of_line[i])
        pool = pools[src]
        tpl = _TEMPLATES[int(rng.choice(tpl_per_source[src]))]
        line = tpl
        while "{" in line:
            line = line.replace("{num}", str(int(rng.integers(0, 100000))), 1)
            line = line.replace("{port}", str(int(rng.integers(1024, 65535))), 1)
            line = line.replace("{ip}", draw(pool, "ip"), 1)
            line = line.replace("{id}", draw(pool, "id"), 1)
            line = line.replace("{hex}", draw(pool, "hex"), 1)
            line = line.replace("{user}", _USERS[int(rng.integers(len(_USERS)))], 1)
        lines.append(line)
    return LogDataset(name=name, lines=lines,
                      sources=source_of_line.astype(np.int32), seed=seed)


# ---------------------------------------------------------------- workloads
def id_queries(rng_seed: int, n: int) -> list[str]:
    """Random 16-letter needle-in-the-haystack identifiers (§5.2)."""
    rng = np.random.default_rng(rng_seed)
    return [_rand_id(rng) for _ in range(n)]


def ip_queries(rng_seed: int, n: int) -> list[str]:
    """Random partial (3-octet) IP addresses (§5.2)."""
    rng = np.random.default_rng(rng_seed)
    return [".".join(str(int(x)) for x in rng.integers(1, 255, size=3))
            for _ in range(n)]


def extracted_term_queries(ds: LogDataset, rng_seed: int, n: int) -> list[str]:
    """Terms sampled from the data itself (the term(extracted) scenario —
    queries that match a relevant fraction of batches)."""
    from ..core.tokenizer import _ALNUM
    rng = np.random.default_rng(rng_seed)
    terms = []
    for _ in range(n):
        line = ds.lines[int(rng.integers(ds.n_lines))]
        toks = [t for t in _ALNUM.findall(line.lower()) if 4 <= len(t) <= 24]
        terms.append(toks[int(rng.integers(len(toks)))] if toks else "info")
    return terms


def present_id_queries(ds: LogDataset, rng_seed: int, n: int) -> list[str]:
    """16-letter ids that DO occur in the data (validates zero false
    negatives end-to-end)."""
    import re
    rng = np.random.default_rng(rng_seed)
    pat = re.compile(r"[a-z]{16}")
    out = []
    tries = 0
    while len(out) < n and tries < n * 50:
        line = ds.lines[int(rng.integers(ds.n_lines))]
        m = pat.search(line)
        if m:
            out.append(m.group())
        tries += 1
    return out or ["info"]
