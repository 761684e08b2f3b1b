"""Queries a wave of the serving front end answered in the window
(``ServeStats.completed`` over ``ServeStats.waves``)."""


def read(obs):
    if not obs.get("waves"):
        return None
    return obs["wave_queries"] / obs["waves"]
