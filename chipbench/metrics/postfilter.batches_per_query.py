"""Candidate batches a query decompressed and scanned
(``QueryResult.candidate_batches``), mean over the window's answers."""


def read(obs):
    n = obs.get("candidate_batches")
    if n is None or not len(n):
        return None
    return float(n.mean())
