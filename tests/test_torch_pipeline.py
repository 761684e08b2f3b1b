"""The port's training data pipeline, checkpoints, elastic helpers and
training loop, held to the JAX package where it defines them:
``LMTokenPipeline`` batches bit for bit, ``SketchFilteredCorpus``
selecting the reference's batches and lines on the same dataset, the
checkpoint round trip bit for bit (bf16 leaves included), the async save
and ``keep_last``, a resumed ``launch/train.py`` run equal to a straight
one bit for bit on the CPU, ``StragglerMonitor`` / ``HealthState`` /
``largest_mesh_for`` as the reference's, and the port's
``examples/train_lm.py`` at ``--device cpu``."""
import os

import numpy as np
import pytest
import torch

from repro_torch.data import LMTokenPipeline, SketchFilteredCorpus
from repro_torch.examples import train_lm
from repro_torch.launch import elastic
from repro_torch.launch import train as ptrain
from repro_torch.launch.checkpoint import CheckpointManager
from repro_torch.logstore.datasets import generate_dataset
from repro_torch.logstore.store import DynaWarpStore
from repro_torch.optim.adam import AdamState
from repro_torch.tree import leaves

jax = pytest.importorskip("jax")

from repro.data import LMTokenPipeline as RefPipeline  # noqa: E402
from repro.data import SketchFilteredCorpus as RefCorpus  # noqa: E402
from repro.launch import elastic as ref_elastic  # noqa: E402
from repro.logstore.store import DynaWarpStore as RefStore  # noqa: E402


@pytest.fixture(scope="module")
def corpus_lines():
    return generate_dataset("corpus", n_lines=4000, n_sources=8, seed=1).lines


@pytest.mark.parametrize("vocab,batch,seq,seed,n_lines", [
    (256, 2, 32, 0, 4000), (50_304, 4, 64, 7, 500), (512, 3, 16, 3, 1)])
def test_lm_token_pipeline_matches_reference(corpus_lines, vocab, batch, seq,
                                             seed, n_lines):
    """Batches bit for bit; one line gives a corpus shorter than seq (the
    wrap-around branch)."""
    lines = corpus_lines[:n_lines]
    got = LMTokenPipeline(lines, vocab=vocab, batch=batch, seq=seq, seed=seed)
    want = RefPipeline(lines, vocab=vocab, batch=batch, seq=seq, seed=seed)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    for step in (0, 1, 5, 1000):
        g, w = got.batch_at(step), want.batch_at(step)
        assert g.keys() == w.keys()
        for k in g:
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])
    it = iter(got)
    np.testing.assert_array_equal(next(it)["tokens"], got.batch_at(0)["tokens"])


def test_sketch_filtered_corpus_selects_the_reference_batches(corpus_lines):
    port = DynaWarpStore(batch_lines=128, device="cpu")
    ref = RefStore(batch_lines=128)
    for s in (port, ref):
        s.ingest(corpus_lines)
        s.finish()
    for inc, exc in ((("error",), ()), (("error",), ("warn",)),
                     ((), ("error",))):
        got = SketchFilteredCorpus(port, include_terms=inc, exclude_terms=exc)
        want = RefCorpus(ref, include_terms=inc, exclude_terms=exc)
        np.testing.assert_array_equal(got.selected_batches(),
                                      want.selected_batches())
        assert 0 < len(got.selected_batches()) < port.n_batches
        assert list(got.lines()) == list(want.lines())
    corpus = SketchFilteredCorpus(port, include_terms=("error",))
    a = LMTokenPipeline(corpus.lines(), vocab=256, batch=2, seq=32)
    b = RefPipeline(RefCorpus(ref, include_terms=("error",)).lines(),
                    vocab=256, batch=2, seq=32)
    np.testing.assert_array_equal(a.batch_at(3)["tokens"],
                                  b.batch_at(3)["tokens"])


def _state(seed):
    g = torch.Generator().manual_seed(seed)
    params = {"w": torch.randn(3, 4, generator=g),
              "emb": torch.randn(5, 2, generator=g).to(torch.bfloat16),
              "blocks": [torch.randn(2, generator=g),
                         {"b": torch.randint(0, 9, (3,), generator=g,
                                             dtype=torch.int32)}]}
    opt = AdamState(step=torch.tensor(seed, dtype=torch.int32),
                    mu={k: torch.zeros(1) for k in ("w", "emb")},
                    nu={k: torch.full((1,), float(seed)) for k in ("w", "emb")})
    return params, opt


def test_checkpoint_round_trip_is_bit_exact(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep_last=2)
    for step in (5, 10, 15):
        cm.save(step, _state(step), blocking=True, extra={"cursor": step})
    assert cm.latest_step() == 15
    man = cm.manifest()
    assert man["extra"] == {"cursor": 15} and man["n_leaves"] == 9
    restored, step = cm.restore(_state(0))
    assert step == 15 and isinstance(restored[1], AdamState)
    for got, want in zip(leaves(restored), leaves(_state(15))):
        assert got.dtype == want.dtype and got.device == want.device
        assert torch.equal(got.view(torch.int16) if got.dtype == torch.bfloat16
                           else got,
                           want.view(torch.int16)
                           if want.dtype == torch.bfloat16 else want)
    ckpts = sorted(f for f in os.listdir(tmp_path) if f.endswith(".npz"))
    assert ckpts == ["step_0000000010.npz", "step_0000000015.npz"]
    older, step = cm.restore(_state(0), step=10)
    assert step == 10 and int(older[1].step) == 10
    with pytest.raises(ValueError):        # another structure
        cm.restore({"w": torch.zeros(3, 4)})
    assert CheckpointManager(str(tmp_path / "none")).restore(_state(0)) \
        == (None, None)


def test_checkpoint_async_save_then_wait_and_keep_last(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep_last=3)
    state = _state(1)
    for step in range(1, 7):
        cm.save(step, state)               # each save joins the last one
    cm.wait()
    assert cm.latest_step() == 6
    ckpts = sorted(f for f in os.listdir(tmp_path) if f.endswith(".npz"))
    assert ckpts == [f"step_{s:010d}.npz" for s in (4, 5, 6)]
    assert not [f for f in os.listdir(tmp_path) if ".tmp" in f]
    # the leaves are copied at save time: a later in-place change is not saved
    params = {"x": torch.ones(4)}
    cm.save(7, params)
    params["x"].zero_()
    cm.wait()
    restored, _ = cm.restore({"x": torch.zeros(4)})
    assert torch.equal(restored["x"], torch.ones(4))


@pytest.mark.parametrize("arch", ["xdeepfm", "olmo-1b"])
def test_train_resume_equals_straight_run(tmp_path, arch):
    """12 steps with a checkpoint every 5, then --resume to 16, against 16
    steps in one run: the losses of steps 12-15 and the final state bit for
    bit (the CPU sums in one order)."""
    common = ["--arch", arch, "--device", "cpu", "--log-every", "100"]
    straight = ptrain.run(common + ["--steps", "16", "--ckpt-dir",
                                    str(tmp_path / "a")])
    first = ptrain.run(common + ["--steps", "12", "--ckpt-every", "5",
                                 "--ckpt-dir", str(tmp_path / "b")])
    assert sorted(os.listdir(tmp_path / "b")) == [
        "MANIFEST.json", "step_0000000005.npz", "step_0000000010.npz",
        "step_0000000011.npz"]
    resumed = ptrain.run(common + ["--steps", "16", "--resume",
                                   "--ckpt-dir", str(tmp_path / "b")])
    assert straight["rc"] == first["rc"] == resumed["rc"] == 0
    assert resumed["start_step"] == 12
    assert resumed["losses"] == {s: straight["losses"][s]
                                 for s in range(12, 16)}
    assert {s: straight["losses"][s] for s in range(12)} == first["losses"]
    assert np.isfinite(list(straight["losses"].values())).all()
    with np.load(tmp_path / "a" / "step_0000000015.npz") as a, \
            np.load(tmp_path / "b" / "step_0000000015.npz") as b:
        assert a.files == b.files
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])


def test_elastic_helpers_match_reference():
    for n in (1, 7, 8, 255, 256, 512):
        for tp in (1, 4, 16):
            assert elastic.largest_mesh_for(n, tp) == \
                ref_elastic.largest_mesh_for(n, tp)
    times = [0.1] * 10 + [1.0, 0.1, 0.05, 0.5, 0.12] * 4
    got, want = elastic.StragglerMonitor(), ref_elastic.StragglerMonitor()
    assert [got.record(t) for t in times] == [want.record(t) for t in times]
    assert got.flagged == want.flagged > 0
    h, r = elastic.HealthState(8), ref_elastic.HealthState(8)
    for s in (h, r):
        s.fail(3)
        s.fail(5)
    assert h.survivors() == r.survivors() == 6
    np.testing.assert_array_equal(h.healthy, r.healthy)
    with pytest.raises(NotImplementedError):
        elastic.make_mesh_from_devices(["cpu"], (1, 1))
    with pytest.raises(NotImplementedError):
        elastic.remesh_state({}, {}, None)


def test_train_lm_example_runs_on_cpu(tmp_path, capsys):
    ckpt = tmp_path / "ckpt"
    assert train_lm.main(["--device", "cpu", "--ckpt-dir", str(ckpt)]) == 0
    out = capsys.readouterr().out
    assert "sketch selected" in out and "resumed from step 29" in out
    assert "[train_lm] resume after a checkpoint exercised OK" in out
    assert (ckpt / "step_0000000039.npz").exists()
