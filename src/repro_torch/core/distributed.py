"""Sharded device retrieval — the paper's horizontal scaling (§3, §6)
through the batched query engine.

Grail assigns immutable segments to query workers; a query fans out to
every segment's sketch and unions/intersects the per-segment candidate
sets.  Here that becomes segment parallelism over a list of torch devices,
one per shard:

  * whole segments are assigned to shards, each kept on the slot it was
    first given (:meth:`ImmutableSketch.get_shard_slot`; durable segments
    keep it by durable id across store reopens), fresh ones on the
    least-loaded shard — so an engine rebuild after compaction re-uploads
    only the merged segments,
  * each segment's flat buffers upload once to its shard's device
    (:meth:`ImmutableSketch.device_cache`, keyed by device), and a wave
    probes it there with one launch of the same fused ``sketch_probe``
    entry the single-device engine uses, OR-ing its token planes into the
    shard's own partial accumulator,
  * the only cross-shard traffic is the merge of the per-shard (Q*T, W)
    partials onto the engine's device (shard 0), OR-ed before the
    engine's shared fold (``bitset_ops``) and extraction
    (``bitmap_extract``), which run once.

A device may stand in the list more than once: its shards are logical
shards on one card, which is how one GPU holds the layout of a larger
mesh.  Semantics are bit-identical to
:class:`~repro_torch.core.query_engine.QueryEngine`: the same probe
kernels, the same fan-out OR, the same fold and extraction.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import canonical_device, resolve_device
from .query_engine import QueryEngine


def default_shard_devices(shard_axes=("data",), device=None
                          ) -> list[torch.device]:
    """One shard per visible device of ``device``'s type, ``device`` first
    (``None`` means the GPU): every CUDA card, or the one CPU.  Leading
    axes of ``shard_axes`` have size 1, so ``('pod', 'data')`` works on one
    host as ``('data',)`` does."""
    if not shard_axes or not all(isinstance(a, str) for a in shard_axes):
        raise ValueError(f"shard_axes={shard_axes!r}: a tuple of axis names")
    first = canonical_device(resolve_device(device))
    if first.type != "cuda":
        return [first]
    return [first] + [torch.device("cuda", i)
                      for i in range(torch.cuda.device_count())
                      if i != first.index]


class ShardedQueryEngine(QueryEngine):
    """Segment-parallel :class:`QueryEngine`: same wave semantics, with
    the plane-backed probe fan-out spread over ``devices`` (one per shard;
    default :func:`default_shard_devices`).  The fold and the extraction
    run on the first shard's device, the engine's ``device``."""

    def __init__(self, segments, *, devices=None, shard_axes=("data",),
                 n_postings: int | None = None, lru_lists: int = 4096,
                 device=None, extract_on_device: bool | None = None):
        self.shard_axes = tuple(shard_axes)
        if devices is None:
            devices = default_shard_devices(self.shard_axes, device)
        devices = [canonical_device(resolve_device(d)) for d in devices]
        if not devices:
            raise ValueError("a sharded engine needs at least one device")
        if len({d.type for d in devices}) > 1:
            raise ValueError(f"shard devices of several types: {devices}")
        if device is not None and \
                canonical_device(resolve_device(device)) != devices[0]:
            raise ValueError(f"device={device!r} is not the first shard's "
                             f"device {devices[0]}")
        super().__init__(segments, n_postings=n_postings,
                         lru_lists=lru_lists, device=devices[0],
                         extract_on_device=extract_on_device)
        self.devices = devices
        self.n_shards = len(devices)
        self._assign_shards()

    # ------------------------------------------------------------ placement
    def _assign_shards(self) -> None:
        """Stable segment -> shard slots: a segment keeps the slot it was
        first given while it is in range (its uploaded buffers stay on that
        shard's device across engine rebuilds; durable segments keep it
        across store reopens too, keyed by their durable id); fresh
        segments, in segment order, fill the least-loaded shard (the
        lowest index on a tie).  The placement is fixed for the engine's
        life.  A slot in range never moves, so a fleet placed over fewer
        shards spreads over more only after ``set_shard_slot(None)``."""
        load = [0] * self.n_shards
        fresh = []
        for _, seg in self._plane_segs:
            slot = seg.get_shard_slot()
            if slot is not None and slot < self.n_shards:
                load[slot] += 1
            else:
                fresh.append(seg)
        for seg in fresh:
            slot = int(np.argmin(load))
            seg.set_shard_slot(slot)
            load[slot] += 1
        # each plane-backed segment's shard, in segment order
        self.slots = [seg.get_shard_slot() for _, seg in self._plane_segs]
        self._by_shard: list[list] = [[] for _ in range(self.n_shards)]
        for slot, (_, seg) in zip(self.slots, self._plane_segs):
            self._by_shard[slot].append(seg)

    # ------------------------------------------------------------- replicas
    def clone(self) -> "ShardedQueryEngine":
        """A serving replica over the same shards: segments keep their
        slots (stable, stored on the sketch) and their uploaded buffers, so
        a replica costs only its own LRU."""
        return ShardedQueryEngine(self.segments, devices=self.devices,
                                  shard_axes=self.shard_axes,
                                  n_postings=self.n_postings,
                                  lru_lists=self._lru_cap,
                                  extract_on_device=self._extract_on_device)

    # ------------------------------------------------------------- dispatch
    def _device_token_planes(self, fps_dev: torch.Tensor) -> torch.Tensor:
        """The sharded fan-out: the wave's fingerprints go to each distinct
        shard device once; each shard ORs one fused probe launch per
        segment it owns into its own (Qb*Tb, W) partial on its device; the
        partials merge onto the engine's device by OR — the all-gather + OR
        of a mesh, kept even when every shard sits on one card."""
        qb, tb = fps_dev.shape
        flat = fps_dev.reshape(-1)
        fps_on = {self.device: flat}
        acc = None
        for dev, segs in zip(self.devices, self._by_shard):
            if not segs:
                continue
            fps = fps_on.get(dev)
            if fps is None:
                fps = fps_on[dev] = flat.to(dev)
            part = torch.zeros((qb * tb, self.words), dtype=torch.int32,
                               device=dev)
            for seg in segs:
                seg.match_bitmap_torch(fps, self._seg_arrs(seg, dev),
                                       out=part)
            part = part.to(self.device)
            if acc is None:
                acc = part
            else:
                acc |= part
        if acc is None:
            acc = torch.zeros((qb * tb, self.words), dtype=torch.int32,
                              device=self.device)
        return acc.view(qb, tb, self.words)
