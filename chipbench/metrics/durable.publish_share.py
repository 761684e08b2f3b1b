"""Share of the window spent publishing at spills, %: the segment file
and the manifest swap (the store's own ``stats.publish_s``, counted over
the window)."""


def read(obs):
    if "publish_s" not in obs or not obs.get("window_s"):
        return None
    return 100.0 * obs["publish_s"] / obs["window_s"]
