"""Plain PyTorch versions of the sketch_probe kernel's entries: the MPHF's
own torch lookup (``core/mphf.py lookup_torch``) and the fused segment
probe's torch chain (``core/immutable_sketch.py match_bitmap_plain``)."""
from ...core.immutable_sketch import match_bitmap_plain as match_planes_ref
from ...core.mphf import lookup_torch as sketch_probe_ref

__all__ = ["match_planes_ref", "sketch_probe_ref"]
