"""The port's copies of ``examples/quickstart.py``, ``batched_query.py`` and
``tail_ingest.py`` run end to end on the CPU at a tiny size, and their
checks of their own answers hold."""
from repro_torch.examples import batched_query, quickstart, tail_ingest


def test_quickstart_runs_on_cpu(capsys):
    assert quickstart.main(["--device", "cpu", "--n-lines", "1500"]) == 0
    out = capsys.readouterr().out
    assert "(matches in-RAM store: True)" in out
    assert "resumed + finished: term 'alice' matches in-RAM store: True" \
        in out
    assert "crashed mid-ingest; recovered" in out and "finished=False" in out
    assert "served 24 queries from 8 clients in " in out
    assert "answers match direct queries: True" in out


def test_batched_query_runs_on_cpu(capsys):
    assert batched_query.main(["--device", "cpu", "--n-lines", "3000",
                               "--repeat", "4"]) == 0
    out = capsys.readouterr().out
    assert "wave of 64 term queries" in out
    assert out.count("matches from both stores") == 3


def test_tail_ingest_runs_on_cpu(capsys, tmp_path):
    assert tail_ingest.main(["--device", "cpu", "--n-lines", "3000",
                             "--path", str(tmp_path / "tail")]) == 0
    out = capsys.readouterr().out
    assert "standing query 'error'" in out
    assert "finished store holds 3000 lines" in out
