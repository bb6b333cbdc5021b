"""What a run loads, and what the reference loads, compared by whole
top-level module names: no JAX, no flax or optax, no JAX package (whose
name the port's begins with, hence whole names); and the reference nothing
of the program."""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "conditioned_nerf_gan_tpu"}

RUN_A_CELL = """
import json, sys, torch
torch.set_num_threads(2)
from benchmark import harness, calibrate
from benchmark.conftest import TINY
from benchmark.run import run_cell
for w in ("thesis_train_s2", "dg_train_s2", "thesis_serve"):
    cell = harness.load_cell(w, 5, 0.2, False)
    cell.device, cell.overrides = "cpu", dict(TINY)
    run_cell(cell, 0.0)
for path in (harness.BENCH / "metrics").glob("*.py"):
    harness.metric_reader(path.stem)
print(json.dumps(sorted({m.split(".", 1)[0] for m in sys.modules})))
"""

RUN_THE_REFERENCE = """
import json, sys, torch
from benchmark.reference import dg, plain, thesis
cfg = json.load(open("benchmark/configs/thesis.json"))
with torch.no_grad():
    m = thesis.build(cfg)
    z, _ = plain.encode_pcl(m["encoder"], torch.rand(2, 16, 6))
    render = dict(img_size=8, num_steps=4, fov=30.0, ray_start=0.5, ray_end=1.5,
                  white_back=True, clamp_mode="relu", ray_chunks=2, perturb=False)
    m["generator"](z, plain.create_cam2world_matrix(torch.rand(2, 3) + 0.5), render)
    dg.build(json.load(open("benchmark/configs/dg.json")))
print(json.dumps(sorted({m.split(".", 1)[0] for m in sys.modules})))
"""


def loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    tops = loaded(RUN_A_CELL)
    assert "conditioned_nerf_gan_torch" in tops  # the program did run
    assert not tops & FORBIDDEN, tops & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    tops = loaded(RUN_THE_REFERENCE)
    assert "torch" in tops
    assert not tops & (FORBIDDEN | {"conditioned_nerf_gan_torch"}), tops
