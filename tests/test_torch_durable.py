"""The port's durable segmented store against the JAX package: the
manifest lifecycle, ``open()``, durable device-cache ids, foreground and
background compaction and the segment-file format, each as
``tests/test_persistence.py`` and ``tests/test_compaction.py`` hold the
reference to it, plus what only two packages can show:

  * a store written by either package opens in the other with the same
    answers, finished or not (an unfinished one resumes and finishes in the
    other package);
  * the same sealed content gives byte-identical segment files;
  * a store reopened from ``np.memmap`` on the CPU stages copies, never the
    mapping's read-only pages.

Every port store runs on ``device="cpu"`` (the kernels' plain versions),
apart from the ``requires_cuda`` cases, which skip where there is no card.
The reference is imported in a fixture, so that those cases also run where
JAX is not installed.  Integer data throughout: exact equality.
"""
import dataclasses
import filecmp
import json
import os
import types
import warnings

import numpy as np
import pytest
import torch

from repro_torch.core import serial
from repro_torch.core.immutable_sketch import (_DURABLE_DEVICE_CACHES,
                                               ImmutableSketch)
from repro_torch.core.segment import SegmentWriter, _tier, tiered_merge
from repro_torch.logstore.blobfile import BlobFile
from repro_torch.logstore.datasets import (generate_dataset, id_queries,
                                           present_id_queries)
from repro_torch.logstore.store import MANIFEST_NAME, DynaWarpStore

SEG_KW = dict(batch_lines=64, mode="segmented", memory_limit_bytes=1 << 14,
              auto_compact=False)
TIMEOUT = 300


@pytest.fixture(scope="module")
def ref():
    """The JAX package's serial and store modules (imported here, not at the
    top, so that this file's imports stay those of the port)."""
    from repro.core import serial as ref_serial
    from repro.logstore import store as ref_store
    return types.SimpleNamespace(serial=ref_serial, store=ref_store)


def _queries(ds):
    return present_id_queries(ds, 3, 5) + ["info", "connection",
                                           "zzqqabsentzzqq"]


def _answers(store, queries):
    return [store.query_term(t).matches for t in queries]


def _port(**kw):
    return DynaWarpStore(**SEG_KW, device="cpu", **kw)


def _ingest(store, lines):
    store.ingest(lines)
    store.finish()
    return store


@pytest.fixture(scope="module")
def ram_store(small_dataset):
    return _ingest(_port(), small_dataset.lines)


@pytest.fixture(scope="module")
def ref_ram(ref, small_dataset):
    """The reference's never-closed store, and its batched answers (one JAX
    wave, computed once)."""
    s = _ingest(ref.store.DynaWarpStore(**SEG_KW), small_dataset.lines)
    return s, s.candidates_term_batch(_queries(small_dataset))


@pytest.fixture(scope="module")
def scan(ref, small_dataset):
    return _ingest(ref.store.ScanStore(batch_lines=64), small_dataset.lines)


@pytest.fixture(scope="module")
def durable_dir(small_dataset, tmp_path_factory):
    """A published port store directory (ingested once per module)."""
    d = str(tmp_path_factory.mktemp("dwstore"))
    _ingest(_port(path=d), small_dataset.lines).close()
    return d


@pytest.fixture(scope="module")
def ref_dir(ref, small_dataset, tmp_path_factory):
    """A published reference store directory."""
    d = str(tmp_path_factory.mktemp("refstore"))
    _ingest(ref.store.DynaWarpStore(**SEG_KW, path=d),
            small_dataset.lines).close()
    return d


def _fresh_durable_dir(small_dataset, tmp_path) -> str:
    """A private store directory whose durable ids no other test's waves
    have staged yet (the device-cache registry is process-global)."""
    d = str(tmp_path / "fresh_store")
    _ingest(_port(path=d), small_dataset.lines).close()
    return d


def _assert_same_answers(store, ref_store, ref_batch, ds):
    """term, contains and batched answers of ``store`` equal the reference
    store's (lone-query path) and its precomputed batched candidates."""
    qs = _queries(ds)
    assert _answers(store, qs) == _answers(ref_store, qs)
    for full_id in qs[:3]:
        sub = full_id[2:14]
        assert store.query_contains(sub).matches \
            == ref_store.query_contains(sub).matches
    for a, b in zip(store.candidates_term_batch(qs), ref_batch):
        np.testing.assert_array_equal(a, b)
    assert [r.matches for r in store.query_term_batch(qs)] \
        == _answers(ref_store, qs)


# ---------------------------------------------------------------- reopen
def test_reopen_is_bit_identical(ram_store, ref_ram, durable_dir, scan,
                                 small_dataset):
    """Fresh open() == never-closed RAM store == the reference's store."""
    re = DynaWarpStore.open(durable_dir, device="cpu")
    qs = _queries(small_dataset)
    assert len(re.segments) == len(ram_store.segments)
    assert re.n_batches == ram_store.n_batches
    for t in qs:
        np.testing.assert_array_equal(ram_store.candidates_term(t),
                                      re.candidates_term(t))
        assert re.query_term(t).matches == ram_store.query_term(t).matches \
            == scan.query_term(t).matches
    _assert_same_answers(re, *ref_ram, small_dataset)


def test_reopen_serves_segments_from_memmap(durable_dir):
    re = DynaWarpStore.open(durable_dir, mmap=True, device="cpu")
    for seg in re.segments:
        assert isinstance(seg.signatures, np.memmap)
        assert isinstance(seg.bic_bits, np.memmap)
        assert seg.planes is None or isinstance(seg.planes, np.memmap)
        assert seg.sealed_source is not None
        assert all(isinstance(l, np.memmap) for l in seg.sealed_source.lists)
    eager = DynaWarpStore.open(durable_dir, mmap=False, device="cpu")
    assert not isinstance(eager.segments[0].signatures, np.memmap)


def test_memmapped_segments_stage_copies_on_the_cpu(small_dataset,
                                                    tmp_path):
    """A store reopened from np.memmap on the CPU raises no "not writable"
    warning, and no staged tensor shares memory with a mapping."""
    d = _fresh_durable_dir(small_dataset, tmp_path)
    qs = _queries(small_dataset)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        re = DynaWarpStore.open(d, mmap=True, device="cpu")
        got = re.candidates_term_batch(qs)
    assert re.engine.upload_count == len(re.segments) > 0
    for seg in re.segments:
        mapped = [seg.signatures, seg.planes, seg.mphf.words,
                  seg.mphf.block_rank, seg.mphf.fallback_fps,
                  seg.csf.bitseq, seg.csf.lengths]
        assert all(isinstance(m, np.memmap) for m in mapped)
        for name, t in seg.device_cache("cpu").items():
            if isinstance(t, torch.Tensor):
                assert not any(np.shares_memory(t.numpy(), m)
                               for m in mapped), name
    eager = DynaWarpStore.open(d, mmap=False, device="cpu")
    for a, b in zip(got, eager.candidates_term_batch(qs)):
        np.testing.assert_array_equal(a, b)


def test_durable_id_device_cache_keying(small_dataset, tmp_path):
    """Second open() in the same process re-uploads nothing: caches key on
    (file path + generation, device), not object identity."""
    d = _fresh_durable_dir(small_dataset, tmp_path)
    qs = _queries(small_dataset)
    first = DynaWarpStore.open(d, device="cpu")
    first.candidates_term_batch(qs)     # stages every plane segment
    assert first.engine.upload_count == len(first.engine._plane_segs) > 0
    assert all((seg.durable_id, torch.device("cpu")) in _DURABLE_DEVICE_CACHES
               for seg in first.segments)
    again = DynaWarpStore.open(d, device="cpu")
    res = again.candidates_term_batch(qs)
    assert again.engine.upload_count == 0
    assert again.engine.device_bytes() == first.engine.device_bytes() > 0
    for a, b in zip(first.candidates_term_batch(qs), res):
        np.testing.assert_array_equal(a, b)
    # close() frees the registry: the next open stages anew
    again.close()
    third = DynaWarpStore.open(d, device="cpu")
    third.candidates_term_batch(qs)
    assert third.engine.upload_count == len(third.engine._plane_segs)


def test_open_refuses_unpublished_and_double_create(tmp_path, durable_dir):
    with pytest.raises(FileNotFoundError):
        DynaWarpStore.open(str(tmp_path / "nothing_here"), device="cpu")
    with pytest.raises(ValueError):
        _port(path=durable_dir)  # already published


# ------------------------------------------------------------ cross-open
def test_reference_store_opens_in_port(ref_dir, ref_ram, small_dataset):
    re = DynaWarpStore.open(ref_dir, device="cpu")
    assert re._finished
    _assert_same_answers(re, *ref_ram, small_dataset)
    re.close()


def test_port_store_opens_in_reference(ref, durable_dir, ref_ram,
                                       small_dataset):
    re = ref.store.DynaWarpStore.open(durable_dir)
    assert re._finished
    qs = _queries(small_dataset)
    assert _answers(re, qs) == _answers(ref_ram[0], qs)
    for full_id in qs[:3]:
        sub = full_id[2:14]
        assert re.query_contains(sub).matches \
            == ref_ram[0].query_contains(sub).matches
    re.close()


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_unfinished_store_resumes_in_the_other_package(ref, writer, scan,
                                                       small_dataset,
                                                       tmp_path):
    """A writer dies mid-ingest (after its per-spill publishes); the other
    package opens the unfinished manifest, resumes appending, finishes,
    and answers exactly; both packages then read the finished store."""
    lines = small_dataset.lines
    d = str(tmp_path / "live")
    port_cls, ref_cls = DynaWarpStore, ref.store.DynaWarpStore
    make = (lambda: _port(path=d)) if writer == "port" \
        else (lambda: ref_cls(**SEG_KW, path=d))
    w = make()
    w.ingest(lines[:1200])
    w.blobs.close()                     # the writer's process dies here
    resumed = ref_cls.open(d) if writer == "port" \
        else port_cls.open(d, device="cpu")
    assert not resumed._finished
    n = resumed._n_lines
    assert 0 < n <= 1200 and n % 64 == 0
    qs = _queries(small_dataset)
    for t in qs:
        assert resumed.query_term(t).matches \
            == [m for m in scan.query_term(t).matches if m < n], t
    resumed.ingest(lines[n:])
    resumed.finish()
    assert _answers(resumed, qs) == _answers(scan, qs)
    resumed.close()
    for reader in (port_cls.open(d, device="cpu"), ref_cls.open(d)):
        assert reader._finished
        assert _answers(reader, qs) == _answers(scan, qs)
        reader.close()


def test_segment_files_are_byte_identical(ref, ram_store, ref_ram,
                                          durable_dir, ref_dir, tmp_path):
    """The same sealed content gives the same segment-file bytes, with and
    without planes and sealed sources, and the two packages' durable
    directories hold the same segment files and manifest fields."""
    ref_segs = ref_ram[0].segments
    assert len(ram_store.segments) == len(ref_segs)
    for i, (a, b) in enumerate(zip(ram_store.segments, ref_segs)):
        for kw in ({}, dict(include_planes=False, include_source=False)):
            pa, pb = str(tmp_path / f"p{i}.dwp"), str(tmp_path / f"r{i}.dwp")
            assert serial.save(a, pa, **kw) == ref.serial.save(b, pb, **kw)
            assert filecmp.cmp(pa, pb, shallow=False), (i, kw)
    segs = sorted(f for f in os.listdir(durable_dir) if f.endswith(".dwp"))
    assert segs == sorted(f for f in os.listdir(ref_dir)
                          if f.endswith(".dwp"))
    for f in segs:
        assert filecmp.cmp(os.path.join(durable_dir, f),
                           os.path.join(ref_dir, f), shallow=False), f
    mans = []
    for d in (durable_dir, ref_dir):
        with open(os.path.join(d, MANIFEST_NAME)) as fh:
            mans.append(json.load(fh))
    for key in ("format", "generation", "seg_seq", "blob_file", "batch_start",
                "n_lines", "finished", "writer", "segments", "config"):
        assert mans[0][key] == mans[1][key], key
    assert list(mans[0]["stats"]) == list(mans[1]["stats"])


# ------------------------------------------------------- crash recovery
def test_crash_between_segment_write_and_manifest_swap(small_dataset,
                                                       tmp_path):
    d = str(tmp_path / "crash_first_publish")
    s = _port(path=d)

    def boom(manifest):
        raise OSError("simulated kill at publish")
    s._swap_manifest = boom
    with pytest.raises(OSError):
        _ingest(s, small_dataset.lines)
    assert any(f.startswith("seg-") for f in os.listdir(d))
    with pytest.raises(FileNotFoundError):
        DynaWarpStore.open(d, device="cpu")
    s.blobs.close()
    s2 = _port(path=d)
    assert not any(f.startswith("seg-") for f in os.listdir(d))
    assert len(s2.blobs) == 0
    s2.close()


def test_crash_mid_compaction_recovers_pre_crash_state(small_dataset,
                                                       tmp_path, ref_ram):
    d = str(tmp_path / "crash_compact")
    _ingest(_port(path=d), small_dataset.lines).close()
    files_before = sorted(os.listdir(d))
    with open(os.path.join(d, MANIFEST_NAME)) as f:
        man_before = f.read()
    qs = _queries(small_dataset)
    truth = _answers(ref_ram[0], qs)

    crashing = DynaWarpStore.open(d, device="cpu")

    def boom(manifest):
        raise OSError("simulated kill at publish")
    crashing._swap_manifest = boom
    with pytest.raises(OSError):
        crashing.compact(fanout=2)
    assert set(os.listdir(d)) - set(files_before)
    with open(os.path.join(d, MANIFEST_NAME)) as f:
        assert f.read() == man_before

    recovered = DynaWarpStore.open(d, device="cpu")
    assert sorted(os.listdir(d)) == files_before     # orphans swept
    assert _answers(recovered, qs) == truth
    for a, b in zip(ref_ram[1], recovered.candidates_term_batch(qs)):
        np.testing.assert_array_equal(a, b)


def test_orphan_and_tmp_files_are_swept_on_open(small_dataset, tmp_path,
                                                ram_store):
    d = str(tmp_path / "orphans")
    s = _ingest(_port(path=d), small_dataset.lines)
    s.close()
    serial.save(s.segments[0], os.path.join(d, "seg-999999.dwp"))
    with open(os.path.join(d, "seg-999998.dwp.tmp"), "wb") as f:
        f.write(b"torn half-write")
    re = DynaWarpStore.open(d, device="cpu")
    names = os.listdir(d)
    assert "seg-999999.dwp" not in names
    assert not any(n.endswith(".tmp") for n in names)
    qs = _queries(small_dataset)
    assert _answers(re, qs) == _answers(ram_store, qs)


# ------------------------------------------------------------ compaction
def test_durable_compaction_foreground(small_dataset, tmp_path, ref,
                                       ref_ram):
    """compact() on a REOPENED store merges from the memmapped sealed
    sources, publishes atomically, and merges as the reference does."""
    d, rd = str(tmp_path / "compact_fg"), str(tmp_path / "ref_compact_fg")
    _ingest(_port(path=d), small_dataset.lines).close()
    _ingest(ref.store.DynaWarpStore(**SEG_KW, path=rd),
            small_dataset.lines).close()
    re = DynaWarpStore.open(d, device="cpu")
    rre = ref.store.DynaWarpStore.open(rd)
    assert all(seg.sealed_source is not None for seg in re.segments)
    n0, gen0 = len(re.segments), re._manifest_gen
    merges = re.compact(fanout=2)
    assert merges == rre.compact(fanout=2) > 0
    assert len(re.segments) == len(rre.segments) < n0
    assert re._manifest_gen == rre._manifest_gen == gen0 + 1
    for f in sorted(os.listdir(d)):
        if f.endswith(".dwp"):
            assert filecmp.cmp(os.path.join(d, f), os.path.join(rd, f),
                               shallow=False), f
    qs = _queries(small_dataset)
    assert _answers(re, qs) == _answers(ref_ram[0], qs)
    re2 = DynaWarpStore.open(d, device="cpu")
    assert len(re2.segments) == len(re.segments)
    assert _answers(re2, qs) == _answers(ref_ram[0], qs)
    for a, b in zip(ref_ram[1], re2.candidates_term_batch(qs)):
        np.testing.assert_array_equal(a, b)


def test_durable_compaction_background(small_dataset, tmp_path, ref_ram):
    d = str(tmp_path / "compact_bg")
    s = _port(path=d, background_compact=True)
    assert s._worker._thread.daemon
    _ingest(s, small_dataset.lines)
    n0 = len(s.segments)
    s.request_compact(fanout=2)          # schedules on the worker
    merges = s.wait_compaction(timeout=TIMEOUT)
    assert merges > 0 and len(s.segments) < n0
    qs = _queries(small_dataset)
    assert _answers(s, qs) == _answers(ref_ram[0], qs)
    thread = s._worker._thread
    s.close()
    assert not thread.is_alive(), "worker thread wedged"
    re = DynaWarpStore.open(d, device="cpu")
    assert len(re.segments) == len(s.segments)
    assert _answers(re, qs) == _answers(ref_ram[0], qs)


def test_background_compaction_under_waves(small_dataset, tmp_path,
                                           ref_ram, monkeypatch):
    """Waves answered while the worker merges equal the reference's; the
    merged-away files go, each merged segment uploads exactly once and the
    unchanged ones not again."""
    d = str(tmp_path / "compact_waves")
    _ingest(_port(path=d), small_dataset.lines).close()
    s = DynaWarpStore.open(d, background_compact=True, device="cpu")
    qs = _queries(small_dataset)
    s.candidates_term_batch(qs)
    orig = ImmutableSketch.device_arrays

    def counting(self, device):
        self.n_staged = getattr(self, "n_staged", 0) + 1
        return orig(self, device)

    monkeypatch.setattr(ImmutableSketch, "device_arrays", counting)
    pre = list(s.segments)
    pre_ids = [p.durable_id for p in pre]
    assert all(any(k[0] == i for k in _DURABLE_DEVICE_CACHES)
               for i in pre_ids)
    before = set(os.listdir(d))
    s.request_compact(fanout=2)
    for _ in range(3):
        for a, b in zip(s.candidates_term_batch(qs), ref_ram[1]):
            np.testing.assert_array_equal(a, b)
    assert s.wait_compaction(timeout=TIMEOUT) > 0
    after = set(os.listdir(d))
    assert before - after and after - before      # merged away, merged in
    for _ in range(2):
        for a, b in zip(s.candidates_term_batch(qs), ref_ram[1]):
            np.testing.assert_array_equal(a, b)
    new = [seg for seg in s.segments if not any(seg is p for p in pre)]
    assert new and all(seg.n_staged == 1 for seg in new)
    live = {seg.durable_id for seg in s.segments}
    gone = [i for i in pre_ids if i not in live]
    assert gone and not any(k[0] in gone for k in _DURABLE_DEVICE_CACHES)
    assert all(getattr(seg, "n_staged", 0) == 0 for seg in s.segments
               if any(seg is p for p in pre))
    s.close()


def test_tiered_merge_bounds_item_count():
    items: list = []
    n = 64
    for _ in range(n):
        items.append(1)
        items, _ = tiered_merge(items, size_of=lambda x: x,
                                merge=lambda g: sum(g), fanout=2)
    assert sum(items) == n
    assert len(items) <= int(np.log2(n)) + 1
    items, merges = tiered_merge([1] * 10, size_of=lambda x: x,
                                 merge=lambda g: sum(g), fanout=1)
    assert merges == 0 and len(items) == 10


def test_writer_tiering_bounds_temporaries(rng):
    fps = (rng.integers(0, 4000, 30000).astype(np.uint64)
           * 2654435761 % (1 << 32)).astype(np.uint32)
    posts = rng.integers(0, 64, 30000).astype(np.int64)
    w = SegmentWriter(memory_limit_bytes=1 << 13, compact_fanout=2)
    for i in range(0, len(fps), 250):
        w.add_fingerprint_batch(fps[i:i + 250], posts[i:i + 250])
    assert w.n_spills >= 8
    assert w.n_compactions > 0
    assert len(w.temporaries) <= int(np.log2(w.n_spills)) + 2


def test_compaction_query_results_bit_identical(small_dataset):
    s = _ingest(DynaWarpStore(batch_lines=64, mode="segmented",
                              memory_limit_bytes=1 << 14, compact_fanout=16,
                              auto_compact=False, device="cpu"),
                small_dataset.lines)
    assert len(s.segments) > 2
    terms = (present_id_queries(small_dataset, 5, 8) + id_queries(9, 4)
             + ["info", "gc", "connection"])
    before = [s.query_term(t).matches for t in terms]
    before_batch = [r.matches for r in s.query_term_batch(terms)]
    n_pre = len(s.segments)
    assert s.compact(fanout=2) > 0
    assert len(s.segments) < n_pre
    after = [s.query_term(t).matches for t in terms]
    after_batch = [r.matches for r in s.query_term_batch(terms)]
    assert before == after == before_batch == after_batch


def test_compaction_bounds_segment_count(small_dataset):
    s = _ingest(DynaWarpStore(batch_lines=64, mode="segmented",
                              memory_limit_bytes=1 << 14, compact_fanout=2,
                              device="cpu"), small_dataset.lines)
    n_spills = max(s._writer.n_spills, 2)
    assert len(s.segments) <= int(np.log2(n_spills)) + 2


def test_auto_compact_runs_at_finish(small_dataset):
    """With auto_compact (default), finish() leaves no size tier holding
    >= compact_fanout segments (the tiered-merge fixed point)."""
    s = _ingest(DynaWarpStore(batch_lines=64, mode="segmented",
                              memory_limit_bytes=1 << 14, compact_fanout=2,
                              device="cpu"), small_dataset.lines)
    tiers: dict[int, int] = {}
    for seg in s.segments:
        t = _tier(seg.size_bytes())
        tiers[t] = tiers.get(t, 0) + 1
    assert all(n < 2 for n in tiers.values()), tiers


def test_compacted_segments_reupload_exactly_once(small_dataset,
                                                  monkeypatch):
    s = _ingest(DynaWarpStore(batch_lines=64, mode="segmented",
                              memory_limit_bytes=1 << 14, compact_fanout=16,
                              auto_compact=False, device="cpu"),
                small_dataset.lines)
    terms = present_id_queries(small_dataset, 5, 6)
    s.query_term_batch(terms)
    calls = {"n": 0}
    orig = ImmutableSketch.device_arrays

    def counting(self, device):
        calls["n"] += 1
        return orig(self, device)

    monkeypatch.setattr(ImmutableSketch, "device_arrays", counting)
    s.query_term_batch(terms)
    assert calls["n"] == 0, "pre-compaction caches must be warm"
    pre = {id(seg) for seg in s.segments}
    s.compact(fanout=2)
    n_new = sum(1 for seg in s.segments if id(seg) not in pre)
    assert n_new > 0
    s.query_term_batch(terms)
    assert calls["n"] == n_new, "each merged segment uploads exactly once"
    calls["n"] = 0
    s.query_term_batch(terms)
    assert calls["n"] == 0, "caches stay warm after the first wave"


def test_compaction_requires_sealed_sources(small_dataset):
    s = _ingest(DynaWarpStore(batch_lines=64, mode="batch", device="cpu"),
                small_dataset.lines[:200])
    assert s.compact() == 0
    m = _ingest(_port(compact_fanout=16), small_dataset.lines)
    assert len(m.segments) > 1
    for seg in m.segments:
        seg.sealed_source = None
    with pytest.raises(ValueError):
        m.compact(fanout=2)


# ------------------------------------------------- segment-file fidelity
def test_segment_file_stats_and_planes_roundtrip(ram_store, tmp_path):
    seg = ram_store.segments[0]
    p = str(tmp_path / "seg.dwp")
    serial.save(seg, p)
    lo = serial.load(p)
    assert lo.stats == serial._jsonable(seg.stats)
    assert lo.planes is not None
    np.testing.assert_array_equal(np.asarray(lo.planes),
                                  np.asarray(seg.planes))
    assert lo.planes.shape == seg.planes.shape
    assert lo.sig_bits == seg.sig_bits
    assert lo.sealed_source.canonical_lists() \
        == seg.sealed_source.canonical_lists()
    np.testing.assert_array_equal(np.asarray(lo.sealed_source.fps),
                                  np.asarray(seg.sealed_source.fps))


def test_plane_presence_is_explicit(ram_store, tmp_path):
    seg = ram_store.segments[0]
    p = str(tmp_path / "noplanes.dwp")
    serial.save(seg, p, include_planes=False)
    with open(p, "rb") as f:
        f.seek(8)
        hlen = int(np.frombuffer(f.read(4), np.uint32)[0])
        header = json.loads(f.read(hlen))
    assert header["meta"]["has_planes"] is False
    assert serial.load(p).planes is None
    with pytest.raises(ValueError):
        serial.load(p, expect_planes=True)
    p2 = str(tmp_path / "planes.dwp")
    serial.save(seg, p2)
    with pytest.raises(ValueError):
        serial.load(p2, expect_planes=False)
    bare = dataclasses.replace(seg, planes=None)
    with pytest.raises(ValueError):
        serial.save(bare, str(tmp_path / "x.dwp"), include_planes=True)


def test_blobfile_torn_tail_is_truncated(tmp_path):
    p = str(tmp_path / "blobs.dat")
    bf = BlobFile(p)
    for payload in (b"alpha", b"beta", b"gamma"):
        bf.append(payload)
    exts = list(bf.extents)
    bf.close()
    with open(p, "ab") as f:
        f.write(b"TORN-GARBAGE")
    re = BlobFile(p, extents=exts)
    assert [re[i] for i in range(len(re))] == [b"alpha", b"beta", b"gamma"]
    re.append(b"delta")
    assert re[3] == b"delta"
    assert os.path.getsize(p) == re.extents[-1][0] + re.extents[-1][1]
    re.close()
    ro = BlobFile(p, extents=exts, writable=False)
    with pytest.raises(ValueError):
        ro.append(b"nope")
    ro.close()


# ------------------------------------------------------------ on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.fixture
def card_dir(tmp_path):
    ds = generate_dataset("card", n_lines=4000, n_sources=16, seed=11)
    d = str(tmp_path / "card_store")
    _ingest(_port(path=d), ds.lines).close()
    return d, _queries(ds)


@pytest.mark.requires_cuda
def test_reopened_wave_on_the_card_equals_the_cpu(cuda, card_dir):
    d, qs = card_dir
    on_card = DynaWarpStore.open(d, device=cuda)
    on_cpu = DynaWarpStore.open(d, device="cpu")
    got = on_card.candidates_term_batch(qs)
    assert on_card.engine.upload_count == len(on_card.segments) > 0
    for a, b in zip(got, on_cpu.candidates_term_batch(qs)):
        np.testing.assert_array_equal(a, b)
    on_card.close()


@pytest.mark.requires_cuda
def test_second_open_on_the_card_uploads_nothing(cuda, card_dir):
    d, qs = card_dir
    first = DynaWarpStore.open(d, device=cuda)
    first.candidates_term_batch(qs)
    staged = torch.cuda.memory_allocated()
    again = DynaWarpStore.open(d, device=cuda)
    got = again.candidates_term_batch(qs)
    assert again.engine.upload_count == 0
    assert again.engine.device_bytes() == first.engine.device_bytes() > 0
    for a, b in zip(first.candidates_term_batch(qs), got):
        np.testing.assert_array_equal(a, b)
    assert torch.cuda.memory_allocated() <= staged + (1 << 20)
    first.close()
