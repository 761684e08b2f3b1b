"""The port's segmented DynaWarp store end to end against the JAX
package: the same lines give the same segments, the same batched and lone
term answers, the same contains answers and the same multi-token AND/OR
waves as ``repro``'s ``DynaWarpStore(mode="segmented")``, and the same
matches as the scan oracle.  Exact equality throughout (integer data)."""
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.logstore.store import DynaWarpStore as RefStore
from repro.logstore.store import ScanStore as RefScan
from repro_torch.core.query_engine import QueryEngine
from repro_torch.core.tokenizer import contains_query_tokens
from repro_torch.logstore.datasets import (id_queries, present_id_queries)
from repro_torch.logstore.store import DynaWarpStore, ScanStore

# small batches and a small memory limit: many spills, so the store holds
# several segments whose plane widths differ
STORE_KW = dict(mode="segmented", batch_lines=16,
                memory_limit_bytes=192 << 10, compact_fanout=8)


@pytest.fixture(scope="module")
def stores(small_dataset):
    port = DynaWarpStore(device="cpu", **STORE_KW)
    ref = RefStore(**STORE_KW)
    scan = ScanStore(batch_lines=16)
    for s in (port, ref, scan):
        s.ingest(small_dataset.lines)
        s.finish()
    return port, ref, scan


def _terms(ds):
    return (present_id_queries(ds, 3, 12) + id_queries(4, 6)
            + ["info", "connection", "gc", "blk", "zzqqxxyyzzqqwwee"])


def test_port_store_has_segments_of_different_widths(stores):
    port, ref, _ = stores
    widths = {s.planes.shape[1] for s in port.segments}
    assert len(port.segments) >= 3 and len(widths) >= 2, widths
    assert len(port.segments) == len(ref.segments)
    for a, b in zip(port.segments, ref.segments):
        np.testing.assert_array_equal(a.planes, b.planes)
        np.testing.assert_array_equal(a.mphf.words, b.mphf.words)
        np.testing.assert_array_equal(a.signatures, b.signatures)


def test_term_batch_and_lone_terms_match_reference_and_scan(stores,
                                                           small_dataset):
    port, ref, scan = stores
    terms = _terms(small_dataset)
    got = port.query_term_batch(terms)
    want = ref.query_term_batch(terms)
    cand = port.candidates_term_batch(terms)
    cand_ref = ref.candidates_term_batch(terms)
    for t, g, w, c, cr in zip(terms, got, want, cand, cand_ref):
        np.testing.assert_array_equal(c, cr)
        truth = scan.query_term(t).matches
        assert g.matches == w.matches == truth, t
        assert port.query_term(t).matches == truth, t


def test_contains_matches_reference_and_scan(stores, small_dataset):
    port, ref, scan = stores
    subs = [t[2:14] for t in present_id_queries(small_dataset, 5, 6)] \
        + ["ssh", "nginx: ", "blk_", "=30"]
    for sub in subs:
        truth = scan.query_contains(sub).matches
        assert port.query_contains(sub).matches \
            == ref.query_contains(sub).matches == truth, sub


@pytest.mark.parametrize("op", ["and", "or"])
def test_multi_token_waves_match_reference_engine(stores, small_dataset, op):
    port, ref, _ = stores
    needles = [t[1:12] for t in present_id_queries(small_dataset, 7, 20)] \
        + ["request_id=", "packetresponder", "zzqqxxyyzz", "a"]
    toks = [contains_query_tokens(n) for n in needles] + [[]]
    assert max(len(t) for t in toks) >= 8
    got = port.engine.query_batch(toks, op=op)
    want = ref.engine.query_batch(toks, op=op)
    for t, g, w in zip(toks, got, want):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, port.engine.host_query(t, op=op))


def _host_waves(ds):
    """A term wave and a contains wave (AND and OR) over the dataset."""
    from repro_torch.core.tokenizer import term_query_tokens
    needles = [t[1:12] for t in present_id_queries(ds, 7, 20)] \
        + ["request_id=", "packetresponder", "zzqqxxyyzz", "a"]
    contains = [contains_query_tokens(n) for n in needles] + [[]]
    terms = [term_query_tokens(t) for t in _terms(ds)]
    return [("term", terms, "and"), ("contains", contains, "and"),
            ("contains", contains, "or")]


@pytest.fixture(scope="module")
def host_stores(small_dataset, tmp_path_factory):
    """Durable host-extraction stores of both packages over the dataset
    (the ``stores`` fixture's layout: the same segments), and the
    reference's answers to ``_host_waves``."""
    d = tmp_path_factory.mktemp("host_extract")
    kw = dict(STORE_KW, extract_on_device=False)
    port = DynaWarpStore(device="cpu", path=str(d / "port"), **kw)
    ref = RefStore(path=str(d / "ref"), **kw)
    for st in (port, ref):
        st.ingest(small_dataset.lines)
        st.finish()
    assert ref.engine._extract_on_device is False
    want = [ref.engine.query_batch(w, op=op)
            for _, w, op in _host_waves(small_dataset)]
    return port, want, str(d / "port")


@pytest.mark.parametrize("how", ["built", "reopened", "clone", "sharded"])
def test_host_extraction_waves_match_device_mode_and_reference(
        how, stores, host_stores, small_dataset, monkeypatch):
    """``extract_on_device=False``: term and contains waves decode on the
    host, never call the device compaction, and answer as the reference's
    host mode and the port's device mode do; the mode survives a reopen,
    a clone and a sharded engine (3 logical CPU shards)."""
    from repro_torch.core import distributed, query_engine
    dev_port = stores[0]
    port, want, path = host_stores
    if how == "reopened":
        port = DynaWarpStore.open(path, device="cpu",
                                  extract_on_device=False)
    elif how == "sharded":
        monkeypatch.setattr(distributed, "default_shard_devices",
                            lambda shard_axes=("data",), device=None:
                            [torch.device("cpu")] * 3)
        port = DynaWarpStore.open(path, device="cpu", shard_axes=("data",),
                                  extract_on_device=False)
        assert port.engine.n_shards == 3
    eng = port.engine.clone() if how == "clone" else port.engine
    assert port.extract_on_device is False and eng._extract_on_device is False

    waves = _host_waves(small_dataset)
    device_mode = [dev_port.engine.query_batch(w, op=op)
                   for _, w, op in waves]

    def no_device_compaction(*a, **kw):
        raise AssertionError("bitmap_extract ran in host mode")

    monkeypatch.setattr(query_engine, "bitmap_extract_ragged",
                        no_device_compaction)
    for (kind, wave, op), w_ref, dev in zip(waves, want, device_mode):
        got = eng.query_batch(wave, op=op)
        assert len(got) == len(wave) == len(w_ref) == len(dev)
        for g, d, r in zip(got, dev, w_ref):
            assert g.dtype == np.int64
            np.testing.assert_array_equal(g, d)
            np.testing.assert_array_equal(g, r)
        assert sum(len(g) > 0 for g in got) >= 5, kind


@pytest.mark.parametrize("kw", [{}, {"include_planes": True}])
def test_engine_index_bytes_match_reference(stores, kw):
    port, ref, _ = stores
    assert port.engine.index_bytes(**kw) == ref.engine.index_bytes(**kw)
    assert port.engine.index_bytes(**kw) == sum(
        s.size_bytes(**kw) for s in port.segments) > 0


def test_upload_count_is_one_per_segment(small_dataset):
    st = DynaWarpStore(device="cpu", **STORE_KW)
    st.ingest(small_dataset.lines[:1200])
    st.finish()
    terms = present_id_queries(small_dataset, 9, 10)
    st.query_term_batch(terms)
    assert st.engine.upload_count == len(st.segments)
    st.query_term_batch(terms[::-1])
    assert st.engine.upload_count == len(st.segments)
    clone = st.engine.clone()
    clone.query_batch([[b"info"]] * 3)
    assert clone.upload_count == 0


def test_compaction_matches_reference(small_dataset):
    kw = dict(STORE_KW, auto_compact=False)
    port = DynaWarpStore(device="cpu", **kw)
    ref = RefStore(**kw)
    for s in (port, ref):
        s.ingest(small_dataset.lines)
        s.finish()
    n_before = len(port.segments)
    assert port.compact(fanout=2) == ref.compact(fanout=2) > 0
    assert len(port.segments) == len(ref.segments) < n_before
    for a, b in zip(port.segments, ref.segments):
        np.testing.assert_array_equal(a.planes, b.planes)
    terms = _terms(small_dataset)
    for g, w in zip(port.candidates_term_batch(terms),
                    ref.candidates_term_batch(terms)):
        np.testing.assert_array_equal(g, w)


def test_queries_during_ingest_are_exact(small_dataset):
    port = DynaWarpStore(device="cpu", **STORE_KW)
    scan = RefScan(batch_lines=16)
    lines = small_dataset.lines[:800]       # 50 whole batches
    port.ingest(lines)
    scan.ingest(lines)
    scan.finish()
    for t in present_id_queries(small_dataset, 11, 5):
        assert port.query_term(t).matches == scan.query_term(t).matches


def test_port_imports_neither_jax_nor_reference():
    code = ("import sys, repro_torch, repro_torch.logstore.store, "
            "repro_torch.kernels.build, repro_torch.baselines, "
            "repro_torch.kernels.token_hash.ops, "
            "repro_torch.kernels.csc_probe.ops, "
            "repro_torch.core.query, repro_torch.core.device_query, "
            "repro_torch.models.transformer, repro_torch.models.recsys, "
            "repro_torch.models.convert, repro_torch.configs, "
            "repro_torch.launch.serve, "
            "repro_torch.kernels.retrieval_score.ops, "
            "repro_torch.kernels.embedding_bag.ops, "
            "repro_torch.kernels.flash_decode.ops, "
            "repro_torch.core.faults, repro_torch.core.serial, "
            "repro_torch.logstore.blobfile, "
            "repro_torch.examples.quickstart, "
            "repro_torch.examples.batched_query, "
            "repro_torch.examples.tail_ingest, "
            "repro_torch.core.serving, repro_torch.configs.dynawarp, "
            "repro_torch.core.distributed, "
            "repro_torch.examples.distributed_query, "
            "repro_torch.models.moe, repro_torch.configs.gemma2_9b, "
            "repro_torch.configs.olmo_1b, repro_torch.configs.phi35_moe, "
            "repro_torch.configs.arctic_480b, "
            "repro_torch.examples.serve_lm, repro_torch.tree, "
            "repro_torch.optim, repro_torch.optim.adam, "
            "repro_torch.optim.adafactor, repro_torch.optim.compress, "
            "repro_torch.data, repro_torch.data.pipeline, "
            "repro_torch.launch.steps, repro_torch.launch.train, "
            "repro_torch.launch.dryrun, "
            "repro_torch.launch.checkpoint, repro_torch.launch.elastic, "
            "repro_torch.models.gnn, repro_torch.examples.train_lm; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_default_device_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DynaWarpStore()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DynaWarpStore(device="cuda")


def test_unported_paths_raise(small_dataset, tmp_path):
    """``shard_axes=`` is ported: a CPU store builds a
    ``ShardedQueryEngine`` and answers as the plain one; ``serving()`` of
    an unfinished batch-mode store raises as the reference's does, and a
    bad mode raises; ``path=``, ``snapshot()`` and ``open()`` work and
    answer as the reference's."""
    from repro_torch.core.distributed import ShardedQueryEngine
    sharded = DynaWarpStore(device="cpu", shard_axes=("data",), **STORE_KW)
    plain = DynaWarpStore(device="cpu", **STORE_KW)
    for s in (sharded, plain):
        s.ingest(small_dataset.lines[:800])
        s.finish()
    assert isinstance(sharded.engine, ShardedQueryEngine)
    assert sharded.engine.n_shards == 1 and sharded.shard_axes == ("data",)
    assert type(plain.engine) is QueryEngine
    shard_terms = present_id_queries(small_dataset, 11, 5) + ["info"]
    for x, y in zip(sharded.candidates_term_batch(shard_terms),
                    plain.candidates_term_batch(shard_terms)):
        np.testing.assert_array_equal(x, y)
    with pytest.raises(ValueError, match="mode='segmented'"):
        DynaWarpStore(device="cpu").serving()
    with pytest.raises(ValueError):
        DynaWarpStore(device="cpu", mode="streaming")
    lines = small_dataset.lines[:800]
    terms = present_id_queries(small_dataset, 11, 5) + ["info"]
    d, rd = str(tmp_path / "port"), str(tmp_path / "ref")
    port = DynaWarpStore(device="cpu", path=d, **STORE_KW)
    ref = RefStore(path=rd, **STORE_KW)
    for s in (port, ref):
        s.ingest(lines)
    snap, ref_snap = port.snapshot(), ref.snapshot()
    assert snap.n_lines == ref_snap.n_lines > 0
    for t in terms:
        assert snap.query_term(t).matches == ref_snap.query_term(t).matches
    for s in (port, ref):
        s.finish()
        s.close()
    re, ref_re = DynaWarpStore.open(d, device="cpu"), RefStore.open(rd)
    scan = RefScan(batch_lines=16)
    scan.ingest(lines)
    scan.finish()
    for t in terms:
        assert re.query_term(t).matches == ref_re.query_term(t).matches \
            == scan.query_term(t).matches


# the reference's keywords with the reference's default and another value
REF_ONLY_KW = [("extract_on_device", None, False), ("mmap", True, False),
               ("fsync", False, True), ("background_compact", False, True),
               ("publish_per_spill", True, False), ("compact_retry", 3, 5),
               ("compact_backoff_s", 0.05, 0.5)]


@pytest.mark.parametrize("kw,default,other", REF_ONLY_KW)
def test_reference_keywords_accepted_at_default(kw, default, other,
                                                tmp_path):
    """Each keyword has the reference's default and constructs a store at
    that default.  At its other value a durable store of each package
    answers the same, before and after a reopen."""
    import inspect
    assert inspect.signature(DynaWarpStore).parameters[kw].default \
        == inspect.signature(RefStore).parameters[kw].default == default
    st = DynaWarpStore(device="cpu", batch_lines=16, **{kw: default})
    st.ingest([f"line {i} id=abc{i % 7}" for i in range(40)])
    st.finish()
    assert st.query_term("abc3").matches == list(range(3, 40, 7))
    lines = [f"line {i} id=abc{i % 7} host=h{i % 13}" for i in range(600)]
    terms = [f"abc{k}" for k in range(7)] + ["h5", "line"]
    answers = []
    for cls, dev in ((DynaWarpStore, dict(device="cpu")), (RefStore, {})):
        d = str(tmp_path / cls.__module__.split(".")[0])
        s = cls(batch_lines=16, mode="segmented", memory_limit_bytes=1 << 11,
                auto_compact=False, path=d, **{kw: other}, **dev)
        s.ingest(lines)
        s.finish()
        if kw == "background_compact":
            s.request_compact(fanout=2)
            assert s.wait_compaction(timeout=300) > 0
        got = [s.query_term(t).matches for t in terms]
        s.close()
        re = cls.open(d, **({kw: other} if kw in ("mmap", "extract_on_device")
                            else {}), **dev)
        assert getattr(re, kw) == other or kw in ("fsync",
                                                  "background_compact")
        assert [re.query_term(t).matches for t in terms] == got
        re.close()
        answers.append(got)
    assert answers[0] == answers[1]
    assert answers[0][3] == list(range(3, 600, 7))


def test_default_mode_is_batch_as_in_reference():
    assert DynaWarpStore(device="cpu").mode == RefStore().mode == "batch"
    st = DynaWarpStore(device="cpu", batch_lines=16)
    st.ingest([f"line {i} id=abc{i % 7}" for i in range(100)])
    st.finish()
    assert len(st.segments) == 1 and st.sketch is st.segments[0]
    assert st.query_term("abc3").matches == list(range(3, 100, 7))


def test_batch_codec_is_safe_across_threads(small_dataset):
    """Serving readers decompress batches while the writer compresses new
    ones: concurrent calls from several threads give back every batch
    exactly, in the blob format the reference reads."""
    import threading

    from repro.logstore.compress import decompress_batch as ref_decompress
    from repro_torch.logstore.compress import compress_batch, decompress_batch

    lines = small_dataset.lines
    batches = [lines[i:i + 16] for i in range(0, min(len(lines), 1024), 16)]
    blobs = [compress_batch(b) for b in batches]
    assert [ref_decompress(blob) for blob in blobs] == batches
    errors: list = []

    def work(k):
        try:
            for _ in range(10):
                for b, blob in zip(batches, blobs):
                    if (decompress_batch(blob) != b
                            or decompress_batch(compress_batch(b)) != b):
                        errors.append(("mismatch", k))
                        return
        except Exception as e:   # pragma: no cover - failure path
            errors.append(repr(e))

    threads = [threading.Thread(target=work, args=(k,), daemon=True)
               for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive(), "codec thread hung"
    assert not errors, errors[:3]
