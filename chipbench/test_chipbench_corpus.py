"""The corpus copy: its statistics against the port's sequential generator,
its record of emitted ids, and its seeds."""
import re

import numpy as np
import pytest

from chipbench.corpus import TEMPLATES, make_corpus

STATS = dict(n_sources=50, zipf_a=1.4, values_per_source=40,
             fresh_share=0.02, layout_seed=3)
N = 20_000


@pytest.fixture(scope="module")
def corpus():
    return make_corpus(2**31 + 11, n_lines=N, **STATS)


def test_statistics_match_the_ports_generator(corpus):
    from repro_torch.logstore.datasets import generate_dataset
    ds = generate_dataset("x", n_lines=N, n_sources=STATS["n_sources"],
                          seed=5)
    ours = np.fromiter(map(len, corpus.lines), float)
    theirs = np.fromiter(map(len, ds.lines), float)
    # same templates and value kinds: line lengths and id-bearing shares
    # agree within what one layout of 2-5 templates a source can move
    assert abs(ours.mean() / theirs.mean() - 1) < 0.25
    ids = re.compile(r"\b[a-z]{16}\b")
    share = [np.mean([bool(ids.search(x)) for x in lines])
             for lines in (corpus.lines, ds.lines)]
    assert abs(share[0] - share[1]) < 0.25
    assert all(line.isascii() for line in corpus.lines)


def test_sources_are_zipf_and_clustered(corpus):
    assert len(corpus.lines) == N
    assert np.all(np.diff(corpus.sources) >= 0)
    top = np.sort(np.bincount(corpus.sources))[::-1][:8]
    slope = np.polyfit(np.log(np.arange(1, 9)), np.log(top), 1)[0]
    assert -1.7 < slope < -1.1


def test_id_record_and_once_ids(corpus):
    assert np.all(np.diff(corpus.id_line) >= 0)
    for line, value in zip(corpus.id_line[::97], corpus.id_value[::97]):
        assert value.decode() in re.findall(r"[0-9a-z]+",
                                            corpus.lines[line].lower())
    once = corpus.once_ids()
    assert once.size > 0
    counts = {v: 0 for v in once.tolist()}
    for v in corpus.id_value.tolist():
        if v in counts:
            counts[v] += 1
    assert set(counts.values()) == {1}
    half = corpus.once_ids(N // 2)
    assert np.isin(corpus.id_value[corpus.id_line < N // 2], half).sum() \
        == half.size


def test_seed_changes_values_not_layout(corpus):
    again = make_corpus(2**31 + 11, n_lines=N, **STATS)
    other = make_corpus(7, n_lines=N, **STATS)
    assert again.lines == corpus.lines
    assert other.lines != corpus.lines
    # the layout seed fixes which template each line has, so every run
    # seed gets the same work
    assert [_template(x) for x in other.lines[:500]] == \
        [_template(x) for x in corpus.lines[:500]]
    assert np.array_equal(other.id_line, corpus.id_line)


_PATTERNS = [re.compile(re.sub(r"\\\{[a-z]+\\\}", ".+?", re.escape(t)) + "$")
             for t in TEMPLATES]


def _template(line: str) -> int:
    return next(i for i, p in enumerate(_PATTERNS) if p.match(line))
