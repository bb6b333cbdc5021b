"""A configuration, a traffic mix, a per-layer metric and a cell added as
new files and new BENCHMARK.json entries alone are found by name and run,
with no existing file edited; and BENCHMARK.json keeps its contract's
names, units and links."""

import hashlib
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def digest(tree: Path) -> dict:
    return {str(p.relative_to(tree)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(tree.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_new_files_and_entries_are_enough(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    (tmp_path / "conditioned_nerf_gan_torch").symlink_to(ROOT / "conditioned_nerf_gan_torch")
    before = digest(tmp_path / "benchmark")
    bench = tmp_path / "benchmark"

    config = json.loads((bench / "configs" / "thesis.json").read_text())
    config["name"] = "thesis_again"
    (bench / "configs" / "thesis_again.json").write_text(json.dumps(config))
    (bench / "reference" / "thesis_again.py").write_text(
        '"""The thesis model again."""\nfrom .thesis import (  # noqa: F401\n'
        '    ENCODER, build, discriminator_flops, encoder_flops, encoder_shapes, mapping_dims)\n')
    # stage 0: density noise in the render, as a traffic file alone
    (bench / "traffic" / "train_short.json").write_text(json.dumps(
        {"driver": "train", "step": 0, "pool_batches": 3, "checked_steps": 2,
         "profiled_steps": 1}))
    (bench / "metrics" / "step_gflop.train.py").write_text(
        "def read(trace):\n    f = trace.values.get('step_flops')\n"
        "    return None if f is None else f / 1e9\n")
    (bench / "limits" / "thesis_again_short.json").write_text(json.dumps({"loss1_gap": 1.0}))
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "thesis_again", "source": "https://example.org/x",
                            "file": "benchmark/configs/thesis_again.json", "reduced": [],
                            "why": "a throwaway"})
    spec["workloads"].append({"name": "thesis_again_short", "config": "thesis_again",
                              "traffic": "train_short", "chips": 1, "why": "a throwaway"})
    for m in spec["end_to_end"]:
        if m["name"] == "train_images_per_s":
            m["workloads"].append("thesis_again_short")
    spec["per_layer"].append({"name": "step_gflop.train", "unit": "GFLOP", "better": "higher",
                              "source": "program_counter", "layer": "Train step",
                              "moves": "train_images_per_s",
                              "workloads": ["thesis_again_short"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    code = """
import json, torch
torch.set_num_threads(2)
from benchmark import harness
from benchmark.conftest import TINY
from benchmark.run import run_cell
cell = harness.load_cell("thesis_again_short", 9, 0.2, False)
cell.device, cell.overrides = "cpu", dict(TINY)
result, checks = run_cell(cell, 0.0)
trace = harness.Trace("train", values={"step_flops": 2e9})
print(json.dumps({"result": result, "checks": checks,
                  "metric": harness.metric_reader("step_gflop.train")(trace),
                  "per_layer": [m["name"] for m in cell.per_layer],
                  "bench": str(harness.BENCH)}))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["bench"] == str(bench)
    assert got["result"]["attempted"] >= 1
    assert set(got["result"]["metrics"]) == {"train_images_per_s", "setup_s"}
    assert set(got["checks"]) == {"loss1_gap"}
    assert got["metric"] == 2.0
    assert "step_gflop.train" in got["per_layer"]
    after = digest(bench)
    assert {k: v for k, v in after.items() if k in before} == before  # nothing edited


def test_benchmark_json_keeps_its_contract():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    cells = {w["name"]: w for w in spec["workloads"]}
    configs = {c["name"]: c for c in spec["configs"]}
    names = list(e2e) + [m["name"] for m in spec["per_layer"]] + list(cells) + list(configs)
    assert len(names) == len(set(names))
    for name in names + [w["traffic"] for w in cells.values()]:
        assert NAME.match(name), name
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher"), m
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in spec["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")

    def reports(cell, metric):
        return "workloads" not in metric or cell in metric["workloads"]

    for cell, w in cells.items():
        assert w["config"] in configs and w["chips"] == 1
        assert (ROOT / "benchmark" / "traffic" / f"{w['traffic']}.json").exists()
        assert (ROOT / "benchmark" / "limits" / f"{cell}.json").exists()
        assert sum(reports(cell, m) for m in spec["end_to_end"]) >= 2
        assert any(cell in m["workloads"] for m in spec["per_layer"])
    for m in spec["per_layer"]:
        assert m["moves"] in e2e, m["name"]
        assert m["workloads"], m["name"]
        for cell in m["workloads"]:
            assert cell in cells and reports(cell, e2e[m["moves"]]), (m["name"], cell)
        assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").exists()
    for c in configs.values():
        assert (ROOT / c["file"]).exists() and c["file"].startswith("benchmark/")
        assert (ROOT / "benchmark" / "reference" / f"{c['name']}.py").exists()
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"]
