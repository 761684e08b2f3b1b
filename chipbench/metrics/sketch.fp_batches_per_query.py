"""False-positive batches a query: candidates the sketch named that held
no match (``QueryResult.false_positive_batches``), mean over the window."""


def read(obs):
    n = obs.get("fp_batches")
    if n is None or not len(n):
        return None
    return float(n.mean())
