"""LogHub-style synthetic log lines, made in bulk from a seed.

A vectorised copy of the port's ``repro_torch/logstore/datasets.py``
generator (the paper's Table 2 statistics): the same templates and users,
Zipf-distributed lines per source, sources arriving clustered, two to five
templates a source, and per-source pools of IPs, 16-letter ids and hex ids
with a small share of fresh values.  It draws column by column instead of
line by line, so a seed gives other lines than the sequential generator
does, with the same statistics, about a hundred times faster.

The sources and templates of the lines come from a layout seed that the
configuration fixes, so that every run seed gives the same work.  Besides
the lines it records every 16-letter id it emitted and the line it
went into: the traffic draws its query terms from that record.  Nothing
here decides whether an answer is right; ``reference/`` does that from the
lines alone.
"""
from __future__ import annotations

import re
from dataclasses import dataclass

import numpy as np

TEMPLATES = [
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

USERS = ["alice", "bob", "carol", "dave", "erin", "frank", "grace", "heidi",
         "ivan", "judy", "mallory", "oscar", "peggy", "trent", "victor",
         "walter", "svc-ingest", "svc-query", "svc-batch", "root"]

ID_LETTERS = 16
_SLOT = re.compile(r"\{(num|port|ip|id|hex|user)\}")
_HEX = np.frombuffer(b"0123456789abcdef", np.uint8)


@dataclass
class Corpus:
    lines: list[str]
    sources: np.ndarray     # (N,) source of each line, ascending
    id_line: np.ndarray     # (K,) int64 line of each emitted id, ascending
    id_value: np.ndarray    # (K,) S16 the ids, in the same order

    def once_ids(self, n_lines: int | None = None) -> np.ndarray:
        """The ids emitted exactly once among the first ``n_lines`` lines
        (all of them by default), as S16, sorted."""
        vals = self.id_value if n_lines is None else \
            self.id_value[:np.searchsorted(self.id_line, n_lines)]
        uniq, counts = np.unique(vals, return_counts=True)
        return uniq[counts == 1]


def random_ids(rng, n: int) -> np.ndarray:
    """``n`` random 16-letter lowercase ids as S16."""
    return rng.integers(97, 123, size=(n, ID_LETTERS), dtype=np.uint8) \
        .view(f"S{ID_LETTERS}").ravel()


def _hexes(rng, n: int) -> np.ndarray:
    return _HEX[rng.integers(0, 16, size=(n, 12))].view("S12").ravel()


def _ips(rng, n: int) -> np.ndarray:
    octets = rng.integers(1, 255, size=(n, 4)).astype(str)
    return np.char.add(np.char.add(np.char.add(np.char.add(
        octets[:, 0], "."), octets[:, 1]), "."), np.char.add(np.char.add(
            octets[:, 2], "."), octets[:, 3]))


def _as_str(a: np.ndarray) -> np.ndarray:
    return a.astype(str) if a.dtype.kind == "S" else a


def make_corpus(seed: int, *, n_lines: int, n_sources: int, zipf_a: float,
                values_per_source: int, fresh_share: float,
                layout_seed: int) -> Corpus:
    """``layout_seed`` draws which source and template each line has (the
    work a line costs); ``seed`` draws every value in them.  So every seed
    gives the same set of templates in the same places, with other ids,
    numbers and addresses."""
    layout = np.random.default_rng(layout_seed)
    w = 1.0 / np.arange(1, n_sources + 1) ** zipf_a
    src = np.sort(layout.choice(n_sources, size=n_lines, p=w / w.sum()))
    # each source speaks a dialect of 2-5 distinct templates
    perm = np.argsort(layout.random((n_sources, len(TEMPLATES))), axis=1)
    n_tpl = layout.integers(2, 6, size=n_sources)
    tpl = perm[src, (layout.random(n_lines) * n_tpl[src]).astype(np.int64)]
    rng = np.random.default_rng(seed)
    v = values_per_source
    pools = {"ip": _ips(rng, n_sources * v).reshape(n_sources, v),
             "id": _as_str(random_ids(rng, n_sources * v))
             .reshape(n_sources, v),
             "hex": _as_str(_hexes(rng, n_sources * v)).reshape(n_sources, v)}
    fresh = {"ip": _ips, "id": lambda r, n: _as_str(random_ids(r, n)),
             "hex": lambda r, n: _as_str(_hexes(r, n))}
    users = np.asarray(USERS)

    out = np.empty(n_lines, dtype=object)
    id_lines, id_values = [], []
    for t, template in enumerate(TEMPLATES):
        at = np.flatnonzero(tpl == t)
        if not at.size:
            continue
        m = at.size
        cols = []
        for kind in _SLOT.findall(template):
            if kind == "num":
                col = rng.integers(0, 100000, size=m).astype(str)
            elif kind == "port":
                col = rng.integers(1024, 65535, size=m).astype(str)
            elif kind == "user":
                col = users[rng.integers(0, len(users), size=m)]
            else:
                col = pools[kind][src[at], rng.integers(0, v, size=m)]
                new = np.flatnonzero(rng.random(m) < fresh_share)
                if new.size:
                    col = col.astype(object)
                    col[new] = fresh[kind](rng, new.size)
                if kind == "id":
                    id_lines.append(at)
                    id_values.append(np.asarray(col, dtype="S16"))
            cols.append(col.tolist())
        fmt = _SLOT.sub("%s", template.replace("%", "%%"))
        out[at] = [fmt % vals for vals in zip(*cols)]
    id_line = np.concatenate(id_lines) if id_lines else np.empty(0, np.int64)
    id_value = (np.concatenate(id_values) if id_values
                else np.empty(0, "S16"))
    order = np.argsort(id_line, kind="stable")
    return Corpus(lines=out.tolist(), sources=src,
                  id_line=id_line[order].astype(np.int64),
                  id_value=id_value[order])
