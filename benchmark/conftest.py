"""The benchmark's own CPU tests (python -m pytest benchmark -q). Tests
that need a CUDA card carry the `cuda` marker and skip without one."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (hand-written kernels have no CPU mode); "
        "skips without one")


TINY = dict(batch_size=2, img_size=16, num_steps=6, ray_chunks=4, points=256,
            voxel_resolution=16)


# pairs of a configuration and a traffic mix that no cell of BENCHMARK.json
# holds yet, whose paths the tests keep
PAIRS = {"dg_serve": ("dg", "serve_render8")}


@pytest.fixture
def tiny_cell():
    """A cell of BENCHMARK.json (or of PAIRS) on the CPU at a size a test
    can hold."""
    import json

    from benchmark import harness

    def make(workload, seed=20240601, seconds=0.3, trace=False):
        if workload in PAIRS:
            spec = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
            config, traffic = PAIRS[workload]
            cell = harness.make_cell(spec, {"name": workload, "config": config,
                                            "traffic": traffic, "chips": 1},
                                     seed, seconds, trace)
        else:
            cell = harness.load_cell(workload, seed, seconds, trace)
        cell.device = "cpu"
        cell.overrides = dict(TINY)
        return cell

    return make
