"""Architecture registry: ``get_arch(id)`` / ``ARCHS`` back --arch flags.

The ten architectures of the JAX package.  The paper's own config
(dynawarp/copr) is ``DYNAWARP_CONFIG``, not an arch."""
from . import (arctic_480b, gemma2_9b, llama3_8b, meshgraphnet, mind,
               olmo_1b, phi35_moe, sasrec, two_tower, xdeepfm)
from .base import ArchSpec, ShapeSpec
from .dynawarp import CONFIG as DYNAWARP_CONFIG
from .dynawarp import SMOKE as DYNAWARP_SMOKE
from .dynawarp import DynaWarpConfig

ARCHS: dict[str, ArchSpec] = {
    spec.id: spec for spec in (
        gemma2_9b.SPEC, olmo_1b.SPEC, llama3_8b.SPEC, phi35_moe.SPEC,
        arctic_480b.SPEC, meshgraphnet.SPEC, xdeepfm.SPEC, sasrec.SPEC,
        mind.SPEC, two_tower.SPEC)}


def get_arch(arch_id: str) -> ArchSpec:
    if arch_id in ("dynawarp", "copr"):
        raise ValueError(
            "dynawarp/copr is the paper's log-store config, not a model "
            "arch; use repro_torch.configs.DYNAWARP_CONFIG / the logstore "
            "API")
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ARCHS)}")
    return ARCHS[arch_id]


__all__ = ["ARCHS", "ArchSpec", "DYNAWARP_CONFIG", "DYNAWARP_SMOKE",
           "DynaWarpConfig", "ShapeSpec", "get_arch"]
