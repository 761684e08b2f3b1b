"""run.py: without a card it fails loudly; no run loads JAX or the JAX
package; on the CPU, with its look for a card skipped, a sound run of each
cell is correct and reports its metrics.  The card's own case runs each
cell briefly on the H100 and skips elsewhere."""
import ast
import json
import os
import subprocess
import sys
import time

import pytest
import torch

from chipbench import run
from chipbench.rehearsal import small

BENCH = run.load_json(run.ROOT / "BENCHMARK.json")
CELLS = [w["name"] for w in BENCH["workloads"]]


def cpu_run(cell: str, trace: bool = False, seconds: float = 1.5) -> dict:
    return run.execute(BENCH, cell, 2**31 + 21, seconds, trace,
                       torch.device("cpu"), small,
                       t0=time.perf_counter())


def test_without_a_card_run_fails_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run(
        [sys.executable, str(run.HERE / "run.py"), "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, env=env, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_no_harness_source_imports_jax_or_the_jax_package():
    banned = set(run.FORBIDDEN) | {"benchmarks"}
    for path in run.HERE.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            assert not {n.split(".")[0] for n in names} & banned, path


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = (
        "import time, torch\n"
        "from chipbench import run\n"
        "from chipbench.rehearsal import small\n"
        "bench = run.load_json(run.ROOT / 'BENCHMARK.json')\n"
        "r = run.execute(bench, 'needle-serve', 3, 0.5, False,\n"
        "                torch.device('cpu'), small, t0=time.perf_counter())\n"
        "print(r['correct'], run.forbidden_modules())\n")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=run.ROOT,
                       env=dict(os.environ, PYTHONPATH=os.pathsep.join(
                           [str(run.ROOT / "src"), str(run.ROOT)])))
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.split("\n")[-2] == "True []"


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_cpu_run_is_correct_and_reports_its_metrics(cell, trace):
    r = cpu_run(cell, trace)
    assert r["correct"], r["check"]
    assert r["answers_compared"] > 50
    assert list(r)[-1] == "check"
    # the device's readers find nothing on the CPU; the rest read, but for
    # a span of a path the front end may not have taken
    either = {"engine.device_wave_ms", "engine.host_query_ms"}
    if trace:
        want = {m["name"] for m in BENCH["per_layer"]
                if cell in m["workloads"] and m["source"] != "device_trace"}
    else:
        want = {m["name"] for m in BENCH["end_to_end"]
                if cell in m.get("workloads", [cell])}
    assert set(r["metrics"]) - either == want - either
    assert all(v["value"] > 0 for k, v in r["metrics"].items()
               if k != "serve.device_wave_share")


@pytest.mark.requires_cuda
@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_runs_correct_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    p = subprocess.run(
        [sys.executable, str(run.HERE / "run.py"), "--workload", cell,
         "--seed", str(2**31 + 77), "--seconds", "3", "--trace", "1"],
        capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-4000:]
    result = json.loads(p.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["busy_s"] > 0
