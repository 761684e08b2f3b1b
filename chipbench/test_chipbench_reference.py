"""The plain reference against the port's answers on the CPU, the
comparison's counts, and the controls that have to fail it."""
import numpy as np
import pytest

from chipbench import control
from chipbench.corpus import make_corpus
from chipbench.reference.check import batch_granular, compare, lose_tail
from chipbench.reference.terms import TermIndex
from chipbench.traffic import terms as term_kinds

STATS = dict(n_sources=12, zipf_a=1.4, values_per_source=40,
             fresh_share=0.02, layout_seed=3)


@pytest.fixture(scope="module")
def corpus():
    return make_corpus(2**31 + 5, n_lines=2000, **STATS)


def test_reference_matches_the_ports_answers_on_the_cpu(corpus):
    from repro_torch.logstore.store import DynaWarpStore
    store = DynaWarpStore(mode="segmented", batch_lines=64,
                          memory_limit_bytes=16 << 10, device="cpu")
    store.ingest(corpus.lines)
    store.finish()
    assert len(store.segments) > 1
    rng = np.random.default_rng(0)
    terms = term_kinds.draw(corpus, [{"kind": "absent_id", "share": 0.3},
                                     {"kind": "once_id", "share": 0.3},
                                     {"kind": "present_id", "share": 0.4}],
                            rng, 120)
    terms += ["info", "ERROR", "blk", "tid", "0", "svc", "ingest", "http"]
    index = TermIndex(corpus.lines, {len(t) for t in terms})
    want = [index.lines_with(t) for t in terms]
    got = [r.matches for r in store.query_term_batch(terms)]
    assert compare(got, want)["wrong_answers"] == 0
    assert sum(w.size for w in want) > 100
    assert all(np.array_equal(store.query_term(t).matches, w)
               for t, w in zip(terms[::10], want[::10]))


def test_reference_refuses_terms_outside_its_rule(corpus):
    index = TermIndex(corpus.lines, {4})
    for term in ("blk_", "a.b", "", "x" * 65):
        with pytest.raises(ValueError):
            index.lines_with(term)
    with pytest.raises(ValueError):
        index.lines_with("abc")             # length not indexed


def test_compare_counts_each_departure():
    want = [np.array([1, 5]), np.array([], np.int64), np.array([7])]
    assert compare([[1, 5], [], [7]], want)["wrong_answers"] == 0
    out = compare([[1], [3], [7, 7]], want)
    assert (out["wrong_answers"], out["missing_lines"],
            out["extra_lines"]) == (3, 1, 2)


def test_controls_break_their_guarantee():
    want = [np.array([3]), np.array([], np.int64), np.array([600, 1100])]
    wide = batch_granular(want, 512, 1300)
    assert [w.size for w in wide] == [512, 0, 512 + 276]
    assert compare(wide, want)["extra_lines"] == 511 + 786
    assert [w.tolist() for w in lose_tail(want, 1000)] == [[3], [], [600]]


def _small(config, traffic, cell):
    if "n_lines" in config:
        config["n_lines"] = 6000
    traffic.update({k: v for k, v in dict(
        clients=4, queries_per_client=256, supply_lines=40_000).items()
        if k in traffic})


@pytest.mark.parametrize("cell,acked", [("needle-serve", 0),
                                        ("durable-ingest", 30_720)])
def test_each_cells_control_fails_its_check(cell, acked):
    found = control.readings(cell, 2**31 + 99, acked, _small)
    assert found["answers"] > 100
    assert found["wrong_answers"] > 0
    if cell == "durable-ingest":
        assert found["line_gap"] == 2048 and found["missing_lines"] > 0
    else:
        assert found["extra_lines"] > 0
