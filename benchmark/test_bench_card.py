"""One short run of each cell on the card, as the driver runs it: a result
line with the cell's metrics, correct. Needs a CUDA card (and nvcc for the
program's kernels); skips without one."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["thesis_train_s2", "dg_train_s2", "thesis_serve"])
@pytest.mark.parametrize("trace", [0, 1])
def test_a_cell_runs_on_the_card(workload, trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", workload,
                          "--seed", "2147483659", "--seconds", "3", "--trace", str(trace)],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu" and result["metrics"]
    assert list(result)[-1] == "checks"
