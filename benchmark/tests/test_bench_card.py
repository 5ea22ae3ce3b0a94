"""Each cell run on the card for a short window, its result line read back:
correct, nothing failed, every metric the cell reports present. Skips
without a card (run on the card: ``python -m pytest benchmark/tests -m cuda -q``)."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from benchmark.harness import common


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in common.manifest()["workloads"]])
@pytest.mark.parametrize("trace", [0, 1])
def test_a_cell_runs_correct_on_the_card(cell, trace):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    args = [sys.executable, "benchmark/run.py", "--workload", cell, "--seed", "2718281828", "--seconds", "3", "--trace", str(trace)]
    out = subprocess.run(args, capture_output=True, text=True, timeout=1200, cwd=common.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["failed"] == 0, result
    assert list(result)[-1] == "checks" and result["device"]["platform"] == "gpu"
    bench = common.manifest()
    workload = common.cell(cell)
    e2e = {m["name"] for m in bench["end_to_end"] if common.reports(m, workload, set())}
    want = e2e if not trace else {m["name"] for m in bench["per_layer"] if common.reports(m, workload, e2e)}
    assert set(result["metrics"]) == want
