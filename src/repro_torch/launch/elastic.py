"""Elastic scaling and failure handling.

  * ``largest_mesh_for``: the largest (data, model) mesh the surviving
    devices support (the shape only),
  * ``make_mesh_from_devices`` and ``remesh_state``: the mesh is a function
    of the healthy ranks, and on node loss the state (the latest
    checkpoint's full tensors) is re-sharded onto the new mesh,
  * ``StragglerMonitor``: a step longer than ``straggler_factor`` x the
    trailing median is flagged,
  * ``HealthState``: a registry of healthy devices that tests flip to
    simulate node loss.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


def largest_mesh_for(n_devices: int, model_parallel: int = 1):
    """Largest (data, model) mesh covering <= n_devices with the given TP
    degree, data a power of two."""
    data = max(1, n_devices // model_parallel)
    data = 1 << (data.bit_length() - 1)
    return (data, model_parallel)


def make_mesh_from_devices(ranks, shape, axis_names=("data", "model"), *,
                           device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` over the first prod(shape) of
    ``ranks``, laid out row-major.  The JAX package's "devices" are global
    ranks of the default process group here, and every rank of that group
    must call this (building a mesh creates its process groups), whether
    or not it is in the mesh."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh

    n = int(np.prod(shape))
    ranks = list(ranks)[:n]
    if len(ranks) < n:
        raise ValueError(f"a {tuple(shape)} mesh needs {n} ranks; "
                         f"{len(ranks)} given")
    grid = torch.tensor(ranks, dtype=torch.int64).reshape(tuple(shape))
    return DeviceMesh(device_type, grid, mesh_dim_names=tuple(axis_names))


def remesh_state(state_tree, spec_tree, new_mesh):
    """Re-shard a state tree (full tensors, numpy arrays or DTensors) onto
    ``new_mesh`` (elastic shrink/grow): a DTensor of each leaf with its
    spec's placements; ``spec_tree`` is a ``PartitionSpec`` tree matching
    ``state_tree``."""
    from .shardings import distribute_tree

    return distribute_tree(state_tree, spec_tree, new_mesh)


@dataclass
class StragglerMonitor:
    straggler_factor: float = 3.0
    window: int = 32
    times: list = field(default_factory=list)
    flagged: int = 0

    def record(self, step_s: float) -> bool:
        """Returns True if this step is a straggler (after 8 steps)."""
        is_straggler = False
        if len(self.times) >= 8:
            med = float(np.median(self.times[-self.window:]))
            is_straggler = step_s > self.straggler_factor * med
        self.times.append(step_s)
        self.flagged += int(is_straggler)
        return is_straggler


@dataclass
class HealthState:
    """Failure-injection-friendly health registry."""
    n_devices: int
    healthy: np.ndarray = None

    def __post_init__(self):
        if self.healthy is None:
            self.healthy = np.ones(self.n_devices, bool)

    def fail(self, idx: int):
        self.healthy[idx] = False

    def survivors(self):
        return int(self.healthy.sum())
