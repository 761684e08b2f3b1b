"""Spills of the 32 MB sketch buffer into sealed segments in the window
(the segment writer's ``n_spills``): 1 where the window holds the first
spill cycle whole, as the cell means it to."""


def read(obs):
    return obs.get("spills")
