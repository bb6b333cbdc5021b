"""The port's train CLI on two gloo ranks on the CPU (each a process of its
own, tests/torch_parallel_worker.py): `--smoke` with rank 0 writing the
fixture, an eval whose fid.txt line rank 0 alone writes over both ranks'
image shards, checkpoints written once, and a resume that replays the
uninterrupted run (the four flags' path into `initialize_distributed` is
tests/test_torch_trainer.py's). The eval's scoring is stood in for (it counts the
generated images): the FID nets' sqrtm is tests/test_torch_eval.py's.
~50 s of CPU alone (two two-rank runs)."""

import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_parallel_worker as worker
from conditioned_nerf_gan_torch.config import curriculum_from_json, extract_metadata
from conditioned_nerf_gan_torch.data import ShapeNetDataset

FLAGS = ["--smoke", "--device", "cpu", "-e", "2", "-s", "1000", "-p", "1"]


def _run(out: Path, stop_step: int, *flags: str) -> None:
    worker.spawn(worker.train_cli_rank, 2, ["-o", str(out), *FLAGS, "--stop_step",
                                            str(stop_step), *flags])


def _histories(out: Path, step: int) -> dict:
    return json.loads((out / "checkpoints" / f"{step}.json").read_text())


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("two_ranks")
    _run(root / "a", 2)  # steps 0-2, the eval and a checkpoint at step 1
    # a second run resumed from step 1's checkpoint, on the same fixture
    shutil.copytree(root / "a" / "synthetic_data", root / "b" / "synthetic_data")
    _run(root / "b", 2, "--load_dir", str(root / "a" / "checkpoints" / "1.pt"))
    return root


def test_two_rank_smoke_run_writes_once_from_rank_0(runs):
    """Rank 0 wrote the fixture and the checkpoints; fid.txt has one line,
    scored over both ranks' shards: every view of the `fid` subset was
    rendered. The resumed run wrote its own step's checkpoint alone."""
    out = runs / "a"
    assert sorted(p.name for p in (out / "checkpoints").iterdir()) == [
        "1.json", "1.pt", "2.json", "2.pt"]
    assert sorted(p.name for p in (runs / "b" / "checkpoints").iterdir()) == [
        "2.json", "2.pt"]
    meta = extract_metadata(curriculum_from_json(out / "curriculum.json"), 0)
    fidset = ShapeNetDataset(meta["dataset"]["path"], meta["fid"]["target_size"],
                             meta["fid"]["subset"], meta, load_voxel=False, load_pcl=False,
                             dataset_mode="test", load_img=False, load_depth=False,
                             load_cam=True, shuffle=False)
    lines = [line.split() for line in (out / "fid.txt").read_text().splitlines()
             if line and not line.startswith("#")]
    assert [(int(s), float(f)) for s, f, *_ in lines] == [(1, len(fidset))]
    assert len(list((out / "evaluation").glob("*.png"))) == len(fidset) > 0
    assert (out / "synthetic_data" / "ShapeNetCar").is_dir()


def test_two_rank_resume_replays_the_uninterrupted_run(runs):
    """The run resumed from step 1's checkpoint (every rank restores it,
    then rank 0's state is broadcast) takes step 2 as the uninterrupted
    two-rank run does: the same losses and params."""
    resumed, straight = _histories(runs / "b", 2), _histories(runs / "a", 2)
    for key in ("generator_losses", "discriminator_losses", "photometry_losses"):
        assert len(resumed[key]) == len(straight[key]) == 3, key
        np.testing.assert_allclose(resumed[key], straight[key], rtol=0, atol=1e-6,
                                   err_msg=key)
    a = torch.load(runs / "a" / "checkpoints" / "2.pt", weights_only=False)
    b = torch.load(runs / "b" / "checkpoints" / "2.pt", weights_only=False)
    for net in ("params_G", "params_E", "params_D"):
        for name, p in a[net].items():
            np.testing.assert_allclose(p.numpy(), b[net][name].numpy(), rtol=0, atol=1e-6,
                                       err_msg=f"{net} {name}")
