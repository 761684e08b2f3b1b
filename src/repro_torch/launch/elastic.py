"""Elastic scaling and failure handling: the parts that need no mesh.

  * ``largest_mesh_for``: the largest (data, model) mesh the surviving
    devices support (the shape only),
  * ``StragglerMonitor``: a step longer than ``straggler_factor`` x the
    trailing median is flagged,
  * ``HealthState``: a registry of healthy devices that tests flip to
    simulate node loss.

``make_mesh_from_devices`` and ``remesh_state`` build and re-shard onto a
device mesh; they wait for the mesh and raise.
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


def make_mesh_from_devices(devices, shape, axis_names=("data", "model")):
    raise NotImplementedError("make_mesh_from_devices (a device mesh) is "
                              "not yet ported")


def remesh_state(state_tree, spec_tree, new_mesh):
    raise NotImplementedError("remesh_state (re-sharding onto a new mesh) "
                              "is not yet ported")


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
