"""Each cell of BENCHMARK.json for 3 seconds on the card, untraced and traced:
the run exits 0, prints a result line with ``correct`` true, the cell's
metrics and the device. Marked ``cuda``; skipped without a card.

    python -m pytest -p no:cacheprovider portbench/tests/test_portbench_smoke_cuda.py
"""

import json
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    BENCH = json.load(f)
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


def expected(cell, trace):
    kind = BENCH["per_layer"] if trace else BENCH["end_to_end"]
    return {m["name"] for m in kind if cell in m.get("workloads", [cell])}


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs(card, cell, trace):
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed", "3000000017",
         "--seconds", "3", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    sys.stderr.write(proc.stderr[-3000:])
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    print(json.dumps(result))
    assert result["correct"], result["check"]
    assert set(result["metrics"]) == expected(cell, trace)
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1
    if trace:
        assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
        assert result["breakdown"]["device_ops"]
