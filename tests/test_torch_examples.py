"""The port's copies of ``examples/quickstart.py``, ``batched_query.py``,
``tail_ingest.py``, ``distributed_query.py``, ``serve_lm.py`` and
``log_search.py`` run end to end on the CPU at a tiny size, and their checks
of their own answers hold."""
import os
import subprocess
import sys
from pathlib import Path

from repro_torch.examples import (batched_query, log_search, quickstart,
                                  serve_lm, tail_ingest)


def test_quickstart_runs_on_cpu(capsys):
    assert quickstart.main(["--device", "cpu", "--n-lines", "1500"]) == 0
    out = capsys.readouterr().out
    assert "(matches in-RAM store: True)" in out
    assert "resumed + finished: term 'alice' matches in-RAM store: True" \
        in out
    assert "crashed mid-ingest; recovered" in out and "finished=False" in out
    assert "served 24 queries from 8 clients in " in out
    assert "answers match direct queries: True" in out


def test_log_search_finds_the_planted_lines_in_every_store(capsys):
    assert log_search.main(["--device", "cpu", "--n-lines", "4000"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert [ln.split()[0] for ln in out] == ["dynawarp", "csc", "lucene",
                                             "bloom", "scan"]
    assert all(" found 3 attacks" in ln for ln in out)


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


def test_distributed_query_runs_on_cpu_over_8_logical_shards():
    """``python -m repro_torch.examples.distributed_query --device cpu
    --shards 8``: the counterpart of the reference's run on a forced
    8-device host mesh."""
    src = str(Path(__file__).resolve().parents[1] / "src")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [src] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.examples.distributed_query",
         "--device", "cpu", "--shards", "8", "--n-lines", "6000"],
        capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode == 0, r.stdout + r.stderr
    out = r.stdout
    assert "over 8 shard(s) on ['cpu']" in out
    assert "sharded candidates bit-identical to the single-device engine: " \
        "True" in out
    assert "surviving segments kept their shards: True, wave equal to the " \
        "host path: True" in out


def test_serve_lm_runs_on_cpu(capsys):
    """gemma2-9b's smoke config, batch 4, prompt 16, 12 tokens: its
    prompt is longer than the smoke window of 8."""
    assert serve_lm.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "[serve] gemma2-smoke on cpu: generated (4, 12) tokens" in out
