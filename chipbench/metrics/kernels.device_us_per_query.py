"""Device kernel time in the traced window (copies left out) over the
queries answered in it, in us."""


def read(obs):
    kernel_s = obs.get("device", {}).get("kernel_s")
    if kernel_s is None or not obs.get("answered"):
        return None
    return 1e6 * kernel_s / obs["answered"]
