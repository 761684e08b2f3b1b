"""Spans from the benchmark's side and the device's timeline, for ``--trace 1``.

``Spans`` times calls into the program's layers by wrapping the methods of
the objects a run holds (the program itself records no spans).
``DeviceTrace`` runs ``torch.profiler`` over the window, recording device
activity only (recording the host's ops slows a window of many thousand
launches more than it tells), and reduces it: the seconds in which a kernel
or a copy ran (intervals merged), kernel seconds, the device operations
that took most time, and the longest idle gaps, each named by the span
that covered most of it on the host.  A marker launch at the window's start
ties the device's clock to the host's.
"""
from __future__ import annotations

import time
from collections import defaultdict

import numpy as np

TOP = 10
NO_SPAN = "no program span (client threads, scheduler)"


class Spans:
    def __init__(self):
        self.records: list[tuple[str, float, float]] = []
        self._wrapped: list[tuple] = []

    def wrap(self, obj, attr: str, kind: str) -> None:
        """Time every call of ``obj.attr`` (a class's method or an
        object's) as a span named ``kind``, until :meth:`restore`."""
        fn = getattr(obj, attr)
        records = self.records

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                records.append((kind, t0, time.perf_counter()))

        self._wrapped.append((obj, attr, vars(obj).get(attr)))
        setattr(obj, attr, timed)

    def restore(self) -> None:
        for obj, attr, own in reversed(self._wrapped):
            if own is None:
                delattr(obj, attr)
            else:
                setattr(obj, attr, own)
        self._wrapped.clear()

    def by_kind(self) -> dict[str, tuple[np.ndarray, np.ndarray]]:
        out = defaultdict(list)
        for kind, t0, t1 in list(self.records):
            out[kind].append((t0, t1))
        return {k: tuple(np.asarray(v, dtype=np.float64).T)
                for k, v in out.items()}

    def seconds(self, kind: str) -> float:
        return sum(t1 - t0 for k, t0, t1 in list(self.records) if k == kind)


def _merge(starts: np.ndarray, ends: np.ndarray):
    """Union of intervals -> (block starts, block ends), sorted."""
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], np.maximum.accumulate(ends[order])
    cut = np.flatnonzero(s[1:] > e[:-1]) + 1
    return s[np.concatenate([[0], cut])], e[np.concatenate([cut - 1,
                                                            [s.size - 1]])]


def _covered(starts, ends, lo: float, hi: float) -> float:
    """Seconds of [lo, hi] that the union of the intervals covers."""
    s, e = np.maximum(starts, lo), np.minimum(ends, hi)
    keep = e > s
    if not keep.any():
        return 0.0
    bs, be = _merge(s[keep], e[keep])
    return float((be - bs).sum())


class DeviceTrace:
    """Context manager over a window on ``device`` (a CUDA device)."""

    def __init__(self, torch, device):
        self.torch, self.device = torch, device

    def __enter__(self) -> "DeviceTrace":
        from torch.profiler import ProfilerActivity, profile
        torch = self.torch
        torch.cuda.synchronize(self.device)
        marker = torch.zeros(1, device=self.device)
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        self.host_start = time.perf_counter()
        marker.add_(1)
        torch.cuda.synchronize(self.device)
        return self

    def __exit__(self, *exc) -> bool:
        self.torch.cuda.synchronize(self.device)
        self.host_end = time.perf_counter()
        self._prof.__exit__(*exc)
        return False

    def reduce(self, spans: Spans | None) -> dict:
        cuda = self.torch.autograd.DeviceType.CUDA
        events = sorted((e for e in self._prof.events()
                         if e.device_type == cuda),
                        key=lambda e: e.time_range.start)
        window_s = self.host_end - self.host_start
        if len(events) < 2:
            return {"window_s": window_s}
        # the first is the marker: it places the window on the device's
        # clock and is the benchmark's own, so nothing else counts it
        d0 = events[0].time_range.start
        events = events[1:]
        start = np.array([e.time_range.start for e in events], np.float64)
        end = np.array([e.time_range.end for e in events], np.float64)
        names = [e.name for e in events]
        by_name = defaultdict(float)
        for n, a, b in zip(names, start, end):
            by_name[n] += (b - a) / 1e6
        copies = np.array([n.startswith(("Memcpy", "Memset")) for n in names])
        blocks = _merge(start, end)
        gaps = np.stack([blocks[1][:-1], blocks[0][1:]], axis=1)
        longest = gaps[np.argsort(gaps[:, 1] - gaps[:, 0])[::-1][:TOP]]
        kinds = spans.by_kind() if spans is not None else {}
        idle = []
        for gs, ge in longest:
            h0 = self.host_start + (gs - d0) / 1e6
            h1 = self.host_start + (ge - d0) / 1e6
            cover = {k: _covered(s, e, h0, h1) for k, (s, e) in kinds.items()}
            label = max(cover, key=cover.get) if cover else NO_SPAN
            if not cover or cover[label] < 0.5 * (h1 - h0):
                label = NO_SPAN
            idle.append([label, (ge - gs) / 1e6])
        return {
            "window_s": window_s,
            "busy_s": float((blocks[1] - blocks[0]).sum()) / 1e6,
            "kernel_s": float((end - start)[~copies].sum()) / 1e6,
            "device_ops": sorted(([n, s] for n, s in by_name.items()),
                                 key=lambda x: -x[1])[:TOP],
            "idle_gaps": idle,
        }
