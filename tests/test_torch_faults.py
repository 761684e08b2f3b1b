"""The port's crash-safe live ingest against the JAX package: fault
injection, the crash matrix over every ingest crashpoint, reopen-for-append,
snapshot readers and the background compaction worker, each as
``tests/test_faults.py`` holds the reference to it.

  * ``CRASHPOINTS`` is the reference's tuple, in its order; an unregistered
    name raises at hook time;
  * killed at any ingest crashpoint, the port and the reference publish the
    same prefix, and the port's ``open()`` recovers answers exact over it
    (the reference's scan oracle over the first ``n_lines`` lines, and the
    reference's own recovered store on the lone-query path); resume-append
    and ``finish()`` converge to the uncrashed answers;
  * a reader thread on ``snapshot()``s during ingest sees only complete
    published prefixes;
  * the worker retries transient errors with backoff and surfaces
    persistent ones at ``wait_compaction()``.

Every store runs on ``device="cpu"`` (the kernels' plain versions).  Every
blocking wait carries a timeout followed by a liveness assert, so a wedged
thread fails the test instead of hanging the suite.  Integer data
throughout: exact equality.
"""
import json
import os
import threading
import time
import types

import pytest

from repro_torch.core import faults
from repro_torch.logstore.blobfile import BlobFile
from repro_torch.logstore.store import MANIFEST_NAME, DynaWarpStore

TIMEOUT = 300           # ceiling for any single blocking wait (seconds)
KW = dict(batch_lines=64, mode="segmented", memory_limit_bytes=1 << 14,
          auto_compact=False)
INGEST_POINTS = tuple(p for p in faults.CRASHPOINTS
                      if p != "compact.mid_merge")


@pytest.fixture(scope="module")
def ref():
    """The JAX package's faults and store modules (imported here, not at the
    top, so that this file's imports stay those of the port)."""
    from repro.core import faults as ref_faults
    from repro.logstore import store as ref_store
    return types.SimpleNamespace(faults=ref_faults, store=ref_store)


@pytest.fixture(scope="module")
def scan_oracle(ref, small_dataset):
    s = ref.store.ScanStore(batch_lines=64)
    s.ingest(small_dataset.lines)
    s.finish()
    return s


def _store(**kw):
    return DynaWarpStore(**KW, device="cpu", **kw)


def _terms(ds):
    from repro_torch.logstore.datasets import present_id_queries
    return present_id_queries(ds, 3, 3) + ["info", "connection"]


def _prefix(matches, n_lines):
    return [m for m in matches if m < n_lines]


def _assert_oracle_prefix(store, scan, terms, n_lines):
    """term / contains / query_term_batch exact against the reference's scan
    oracle over the first ``n_lines`` lines."""
    for t in terms:
        assert store.query_term(t).matches \
            == _prefix(scan.query_term(t).matches, n_lines), t
    sub = terms[0][2:14]
    assert store.query_contains(sub).matches \
        == _prefix(scan.query_contains(sub).matches, n_lines)
    for t, r in zip(terms, store.query_term_batch(terms)):
        assert r.matches == _prefix(scan.query_term(t).matches, n_lines), t


# ------------------------------------------------------------- injector
def test_crashpoints_are_the_reference_tuple(ref):
    assert faults.CRASHPOINTS == ref.faults.CRASHPOINTS
    assert issubclass(faults.CrashError, BaseException)
    assert not issubclass(faults.CrashError, Exception)


def test_injector_rejects_unknown_crashpoint():
    with pytest.raises(ValueError):
        faults.FaultInjector(crash_at="not.a.point")
    with faults.inject(crash_at="blob.append"):
        with pytest.raises(AssertionError, match="unregistered"):
            faults.fault_point("not.a.point")
    faults.fault_point("not.a.point")       # disarmed: a single global read


def test_injector_after_times_and_error_modes(tmp_path):
    """after= skips hits, times= bounds firings, error= substitutes the
    exception; hits record every arrival at the armed point."""
    bf = BlobFile(str(tmp_path / "b.dat"))
    with faults.inject(crash_at="blob.append", after=1,
                       error=OSError("EIO"), times=1) as inj:
        bf.append(b"first")                   # hit 1: skipped by after=
        with pytest.raises(OSError):
            bf.append(b"second")              # hit 2: fires
        bf.append(b"third")                   # hit 3: times=1 exhausted
    assert inj.hits == [1, 2, 3] and inj.fired == 1
    assert [bf[i] for i in range(len(bf))] == [b"first", b"third"]
    bf.close()


def test_torn_blob_append_leaves_partial_tail(tmp_path):
    """blob.append.torn writes PART of the blob before raising; reopening
    with the published extents truncates it away."""
    p = str(tmp_path / "b.dat")
    bf = BlobFile(p)
    bf.append(b"published-blob")
    exts = list(bf.extents)
    size_before = os.path.getsize(p)
    with faults.inject(crash_at="blob.append.torn"):
        with pytest.raises(faults.CrashError):
            bf.append(b"torn-away-blob")
    assert os.path.getsize(p) > size_before      # torn bytes on disk
    assert list(bf.extents) == exts              # but never published
    bf.close()
    re = BlobFile(p, extents=exts)
    assert os.path.getsize(p) == exts[-1][0] + exts[-1][1]
    assert re[0] == b"published-blob"
    re.close()


def test_blob_sync_fsyncs_directory_once(tmp_path, monkeypatch):
    from repro_torch.logstore import blobfile
    calls = []
    monkeypatch.setattr(blobfile, "fsync_dir",
                        lambda path: calls.append(path))
    bf = blobfile.BlobFile(str(tmp_path / "b.dat"), fsync=True)
    bf.append(b"x")
    bf.sync()
    bf.append(b"y")
    bf.sync()
    assert calls == [str(tmp_path)]
    bf.close()


# ----------------------------------------------------------- crash matrix
@pytest.mark.parametrize("crashpoint", INGEST_POINTS)
def test_crash_matrix_recovers_to_last_publish(crashpoint, small_dataset,
                                               scan_oracle, ref, tmp_path):
    """Kill the port's ingest and the reference's at the same crashpoint:
    both publish the same prefix; the port's open() recovers exact answers
    over it, as the reference's recovered store does, and resume-append +
    finish() converge to the uncrashed answers."""
    lines = small_dataset.lines
    d, rd = str(tmp_path / "crash"), str(tmp_path / "ref_crash")
    s = _store(path=d, fsync=True)
    with faults.inject(crash_at=crashpoint, after=2) as inj:
        with pytest.raises(faults.CrashError):
            s.ingest(lines)
            s.finish()
    assert inj.fired == 1 and len(inj.hits) >= 3
    s.blobs.close()          # the dead process's fd
    r = ref.store.DynaWarpStore(**KW, path=rd, fsync=True)
    with ref.faults.inject(crash_at=crashpoint, after=2):
        with pytest.raises(ref.faults.CrashError):
            r.ingest(lines)
            r.finish()
    r.blobs.close()

    terms = _terms(small_dataset)
    mpath = os.path.join(d, MANIFEST_NAME)
    assert os.path.exists(mpath) \
        == os.path.exists(os.path.join(rd, MANIFEST_NAME))
    if not os.path.exists(mpath):
        with pytest.raises(FileNotFoundError):
            DynaWarpStore.open(d, device="cpu")
        return
    with open(mpath) as f:
        man = json.load(f)
    with open(os.path.join(rd, MANIFEST_NAME)) as f:
        rman = json.load(f)
    assert man["finished"] is rman["finished"] is False
    for key in ("generation", "n_lines", "batch_start", "segments", "writer"):
        assert man[key] == rman[key], key

    re = DynaWarpStore.open(d, device="cpu")
    assert re._n_lines == man["n_lines"] == man["batch_start"][-1] > 0
    assert not re._finished
    _assert_oracle_prefix(re, scan_oracle, terms, re._n_lines)
    rre = ref.store.DynaWarpStore.open(rd)
    for t in terms:
        assert re.query_term(t).matches == rre.query_term(t).matches, t
    rre.close()

    re.ingest(lines[re._n_lines:])
    re.finish()
    re.finish()              # idempotent across the crash boundary
    _assert_oracle_prefix(re, scan_oracle, terms, len(lines))
    re.close()
    re2 = DynaWarpStore.open(d, device="cpu")
    assert re2._finished
    _assert_oracle_prefix(re2, scan_oracle, terms, len(lines))
    re2.close()


def test_crash_mid_compaction_keeps_pre_crash_state(small_dataset,
                                                    scan_oracle, tmp_path):
    d = str(tmp_path / "crash_compact")
    s = _store(path=d, fsync=True)
    s.ingest(small_dataset.lines)
    s.finish()
    n_segs = len(s.segments)
    s.close()
    terms = _terms(small_dataset)

    crashing = DynaWarpStore.open(d, device="cpu")
    with faults.inject(crash_at="compact.mid_merge") as inj:
        with pytest.raises(faults.CrashError):
            crashing.compact(fanout=2)
    assert inj.fired == 1
    crashing.blobs.close()

    re = DynaWarpStore.open(d, device="cpu")
    assert len(re.segments) == n_segs           # pre-crash state intact
    _assert_oracle_prefix(re, scan_oracle, terms, len(small_dataset.lines))
    assert re.compact(fanout=2) > 0
    _assert_oracle_prefix(re, scan_oracle, terms, len(small_dataset.lines))
    re.close()


def test_transient_publish_error_resumes_in_process(small_dataset,
                                                    scan_oracle, tmp_path):
    """An injected transient I/O error fails one mid-ingest publish; the
    SAME store object resumes from its own counters and the next publish
    self-heals."""
    s = _store(path=str(tmp_path / "transient"))
    with faults.inject(crash_at="manifest.replace", after=1, times=1,
                       error=OSError("transient EIO")):
        with pytest.raises(OSError):
            s.ingest(small_dataset.lines)
    done = s._n_lines
    assert 0 < done < len(small_dataset.lines)
    s.ingest(small_dataset.lines[done:])
    s.finish()
    _assert_oracle_prefix(s, scan_oracle, _terms(small_dataset),
                          len(small_dataset.lines))
    s.close()


# ----------------------------------------------------- queries during ingest
def test_live_queries_match_oracle_prefix(small_dataset, scan_oracle):
    s = _store()
    terms = _terms(small_dataset)
    step = len(small_dataset.lines) // 4
    for start in range(0, len(small_dataset.lines), step):
        s.ingest(small_dataset.lines[start:start + step])
        _assert_oracle_prefix(s, scan_oracle, terms,
                              s.batch_start[len(s.blobs)])
    s.finish()
    _assert_oracle_prefix(s, scan_oracle, terms, len(small_dataset.lines))


def test_ram_snapshot_covers_last_spill(small_dataset, scan_oracle):
    s = _store()
    half = len(small_dataset.lines) // 2
    s.ingest(small_dataset.lines[:half])
    snap = s.snapshot()
    assert 0 < snap.n_lines <= half
    assert snap.n_batches == s._covered_batches == s._spill_covered
    assert snap.n_lines == snap.batch_start[-1]
    s.ingest(small_dataset.lines[half:])
    s.finish()
    terms = _terms(small_dataset)
    for t, r in zip(terms, snap.query_term_batch(terms)):
        assert r.matches == _prefix(scan_oracle.query_term(t).matches,
                                    snap.n_lines)
    assert s.snapshot().n_lines == len(small_dataset.lines)


def test_concurrent_reader_sees_consistent_snapshots(small_dataset,
                                                     scan_oracle, tmp_path):
    """A reader thread runs query_term_batch on snapshots while the writer
    ingests and publishes per spill: every result equals the oracle over
    that snapshot's manifested prefix (no torn reads)."""
    s = _store(path=str(tmp_path / "concurrent"))
    terms = _terms(small_dataset)
    truth = {t: scan_oracle.query_term(t).matches for t in terms}
    errors: list = []
    checks = [0]
    done = threading.Event()
    deadline = time.monotonic() + TIMEOUT

    def reader():
        while (not done.is_set() or checks[0] == 0) \
                and time.monotonic() < deadline:
            snap = s.snapshot()
            try:
                results = snap.query_term_batch(terms)
            except Exception as e:          # pragma: no cover - failure path
                errors.append(repr(e))
                return
            for t, r in zip(terms, results):
                if r.matches != _prefix(truth[t], snap.n_lines):
                    errors.append((t, snap.n_lines))
                    return
            checks[0] += 1

    rt = threading.Thread(target=reader, daemon=True)
    rt.start()
    try:
        for i in range(0, len(small_dataset.lines), 100):
            s.ingest(small_dataset.lines[i:i + 100])
        s.finish()
    finally:
        done.set()
        rt.join(timeout=TIMEOUT)
    assert not rt.is_alive(), "reader thread wedged"
    assert not errors, errors[:3]
    assert checks[0] > 0
    s.close()


# ------------------------------------------------------ compaction worker
def test_worker_retries_transient_error_with_backoff(small_dataset,
                                                     tmp_path):
    s = _store(path=str(tmp_path / "retry"), background_compact=True,
               compact_retry=3, compact_backoff_s=0.01)
    assert s._worker._thread.daemon
    s.ingest(small_dataset.lines)
    s.finish()
    n0 = len(s.segments)
    with faults.inject(crash_at="compact.mid_merge",
                       error=OSError("transient EIO"), times=1) as inj:
        s.request_compact(fanout=2)
        merges = s.wait_compaction(timeout=TIMEOUT)
    assert inj.fired == 1
    assert merges > 0 and len(s.segments) < n0
    assert s._worker.retries >= 1
    assert isinstance(s._worker.last_error, OSError)
    thread = s._worker._thread
    s.close()
    assert not thread.is_alive(), "worker thread wedged"


def test_worker_surfaces_persistent_error_and_survives(small_dataset,
                                                       tmp_path,
                                                       scan_oracle):
    s = _store(path=str(tmp_path / "persistent"), background_compact=True,
               compact_retry=2, compact_backoff_s=0.01)
    s.ingest(small_dataset.lines)
    s.finish()
    with faults.inject(crash_at="compact.mid_merge",
                       error=OSError("disk on fire")) as inj:
        s.request_compact(fanout=2)
        with pytest.raises(OSError, match="disk on fire"):
            s.wait_compaction(timeout=TIMEOUT)
    assert inj.fired == 3                      # first try + 2 retries
    assert s._worker.retries == 2
    assert s._worker._thread.is_alive()
    n0 = len(s.segments)
    s.request_compact(fanout=2)
    assert s.wait_compaction(timeout=TIMEOUT) > 0
    assert len(s.segments) < n0
    _assert_oracle_prefix(s, scan_oracle, _terms(small_dataset),
                          len(small_dataset.lines))
    s.close()


def test_worker_surfaces_a_simulated_kill_without_retry(small_dataset,
                                                        tmp_path):
    """A CrashError (a kill, not an I/O error) is never retried: it
    surfaces at wait_compaction() after one attempt."""
    s = _store(path=str(tmp_path / "killed"), background_compact=True,
               compact_retry=3, compact_backoff_s=0.01)
    s.ingest(small_dataset.lines)
    s.finish()
    with faults.inject(crash_at="compact.mid_merge") as inj:
        s.request_compact(fanout=2)
        with pytest.raises(faults.CrashError):
            s.wait_compaction(timeout=TIMEOUT)
    assert inj.fired == 1 and s._worker.retries == 0
    thread = s._worker._thread
    s.close()
    assert not thread.is_alive(), "worker thread wedged"
