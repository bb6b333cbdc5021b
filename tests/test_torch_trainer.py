"""The port's Trainer and train CLI on the CPU, on the JAX-written synthetic
fixture and the `smoke` preset: the schedule against the JAX Trainer's, the
optimizer state across a milestone, the checkpoint round trip and the
resume precedence, an Inferencer render of a trainer checkpoint, an
end-to-end run across a data-affecting milestone with its resume, and the
CLI. The curricula go in as JSON files (the runs' own curriculum.json or
--load_curriculum) naming the fixture, so no preset module is reloaded."""

import copy
import importlib
import os
import shutil
import types

import numpy as np
import pytest
import torch

import conditioned_nerf_gan_tpu.data as jdata
from conditioned_nerf_gan_torch import train as train_cli
from conditioned_nerf_gan_torch.config import curriculum_to_json, load_curriculum
from conditioned_nerf_gan_torch.infer import Inferencer
from conditioned_nerf_gan_torch.training.checkpoints import find_newest_checkpoint
from conditioned_nerf_gan_torch.training.trainer import HISTORY_KEYS, Trainer
from conditioned_nerf_gan_torch.utils.png import read_png

pytest.importorskip("cv2")  # the JAX fixture writer


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread: the tier-1 run puts six test processes on the
    machine's cores at once, where more threads a process only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def no_eval(monkeypatch):
    """Trainer.evaluate (FID, oFID, LPIPS, PSNR at eval_freq) is held by
    tests/test_torch_eval.py; here it does nothing, as it did before the
    eval was ported, so these runs test the training contract alone (one
    eval takes ~40 s of this CPU, most of it its FID's 2048^2 sqrtm)."""
    monkeypatch.setattr(Trainer, "evaluate", lambda self: None)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    return jdata.make_synthetic_shapenet(tmp_path_factory.mktemp("fixture"), n_cars=3,
                                         n_views=4, img_size=32, n_points=512)


def smoke_curriculum(dataset, milestones=(0, 5, 7)) -> dict:
    """The smoke preset with its three stages at `milestones`: stage 1
    changes the image size (a data-affecting milestone), stage 2 only the
    samples and learning rates."""
    cur = copy.deepcopy(load_curriculum(config_base="smoke"))
    stages = sorted(k for k in cur if isinstance(k, int))
    cur.update({m: cur.pop(k) for m, k in zip(milestones, stages)})
    cur["dataset"]["path"] = str(dataset)
    return cur


def args(out, **overrides):
    base = dict(output_dir=str(out), load_dir="", load_curriculum="", sampling_interval=100,
                print_freq=100, eval_freq=1000, n_epochs=100, stop_step=4, config=None,
                config_base="smoke", seed=0, profile_dir=None, device="cpu")
    base.update(overrides)
    return types.SimpleNamespace(**base)


def run(out, curriculum, **overrides) -> Trainer:
    out.mkdir(parents=True, exist_ok=True)
    curriculum_to_json(curriculum, out / "curriculum.json")
    trainer = Trainer(args(out, **overrides))
    trainer.load_models()
    trainer.train()
    return trainer


def test_schedule_matches_the_jax_trainer(dataset, tmp_path):
    """update_metadata()'s return, `_data_changed` and the metadata equal,
    alpha and nerf_noise within a float32 rounding, at every step 0..10 of
    a curriculum with a data-affecting
    milestone (3), a samples-and-lr one (5) and an lr-only one (8), against
    the JAX Trainer (whose constructor compiles nothing). After a True each
    side re-derives its step config, as its rebuild does."""
    from conditioned_nerf_gan_tpu.training import Trainer as JTrainer

    cur = smoke_curriculum(dataset, milestones=(0, 3, 5))
    cur[8] = dict(cur[5], gen_lr=5e-5, enc_lr=5e-5, disc_lr=5e-5)
    path = tmp_path / "curriculum.json"
    curriculum_to_json(cur, path)
    jt = JTrainer(args(tmp_path / "jax", load_curriculum=str(path)))
    pt = Trainer(args(tmp_path / "port", load_curriculum=str(path)))
    jt.step_config = jt._current_step_config(jt.metadata)
    jt._chain_k_req = max(1, int(jt.metadata.get("steps_per_dispatch", 1) or 1))
    pt.step_config = pt._current_step_config(pt.metadata)
    seen = []
    for step in range(11):
        jt.step = pt.step = step
        changed = jt.update_metadata()
        assert pt.update_metadata() == changed, step
        assert pt._data_changed == jt._data_changed, step
        assert pt.metadata == jt.metadata, step
        if changed:
            seen.append((step, jt._data_changed))
            jt.step_config = jt._current_step_config(jt.metadata)
            jt._chain_k_req = max(1, int(jt.metadata.get("steps_per_dispatch", 1) or 1))
            pt.step_config = pt._current_step_config(pt.metadata)
        jt.set_alpha()
        pt.set_alpha()
        # JAX's schedules are float32 arrays, the port's Python floats: the
        # step consumes both as float32, where they agree to a rounding
        np.testing.assert_allclose([pt.alpha, pt.nerf_noise], [jt.alpha, jt.nerf_noise],
                                   rtol=2.0 ** -23, atol=0, err_msg=str(step))
    assert seen == [(3, True), (5, False), (8, False)]


def test_optimizer_moments_survive_a_milestone(dataset, tmp_path):
    """The rebuild at a milestone sets each param group's learning rate in
    place (the mapping network's at mapping_lr_mult x gen_lr) and keeps
    every Adam moment and step count."""
    cur = smoke_curriculum(dataset, milestones=(0, 3, 5))
    trainer = run(tmp_path / "run", cur, stop_step=2)
    state = trainer.state
    opts = {"G": state.opt_G, "E": state.opt_E, "D": state.opt_D}
    before = {name: [{k: v.clone() for k, v in opt.state[p].items()}
                     for group in opt.param_groups for p in group["params"]]
              for name, opt in opts.items()}
    for name, states in before.items():
        assert all(int(s["step"]) == 3 for s in states), name
        assert max(float(s["exp_avg_sq"].abs().max()) for s in states) > 0, name
    trainer.step = 3
    assert trainer.update_metadata() and trainer._data_changed
    trainer._rebuild_step_fn()
    assert trainer.state is state
    for name, opt in opts.items():
        after = [opt.state[p] for group in opt.param_groups for p in group["params"]]
        for i, (a, b) in enumerate(zip(after, before[name])):
            for k, v in b.items():
                assert torch.equal(a[k], v), (name, i, k)
    lrs = cur[3]
    mult = trainer.metadata.get("mapping_lr_mult", 1.0)
    assert [g["lr"] for g in state.opt_G.param_groups] == [
        lrs["gen_lr"], lrs["gen_lr"] * mult][:len(state.opt_G.param_groups)]
    assert state.opt_E.param_groups[0]["lr"] == lrs["enc_lr"]
    assert state.opt_D.param_groups[0]["lr"] == lrs["disc_lr"]


def _same_state(a, b):
    for net in ("generator", "encoder", "discriminator"):
        sa, sb = getattr(a, net).state_dict(), getattr(b, net).state_dict()
        assert sa.keys() == sb.keys()
        for k in sa:
            assert torch.equal(sa[k], sb[k]), (net, k)
    for opt in ("opt_G", "opt_E", "opt_D"):
        da, db = getattr(a, opt).state_dict(), getattr(b, opt).state_dict()
        assert da["param_groups"] == db["param_groups"], opt
        assert da["state"].keys() == db["state"].keys(), opt
        for i in da["state"]:
            for k, v in da["state"][i].items():
                assert torch.equal(v, db["state"][i][k]), (opt, i, k)


def test_checkpoint_round_trip_and_resume_precedence(dataset, tmp_path):
    """A resumed Trainer holds the saved params, all three optimizer
    states, histories and loader position exactly. The newest checkpoint
    of the run beats --load_dir, --load_dir beats a fresh start. An
    Inferencer renders from a trainer checkpoint."""
    cur = smoke_curriculum(dataset)
    first = run(tmp_path / "a", cur, stop_step=2, eval_freq=2)
    assert sorted(p.name for p in (tmp_path / "a" / "checkpoints").iterdir()) == [
        "1.json", "1.pt", "2.json", "2.pt"]
    assert find_newest_checkpoint(tmp_path / "a" / "checkpoints").name == "2.pt"

    resumed = Trainer(args(tmp_path / "a", load_dir=str(tmp_path / "a/checkpoints/1.pt")))
    resumed.load_models()  # the run's newest checkpoint beats --load_dir
    assert resumed.step == first.step == 3 and resumed.state.step == 3
    _same_state(resumed.state, first.state)
    for k in HISTORY_KEYS:
        assert resumed.histories[k] == first.histories[k], k
    assert resumed._restored_loader_state == {"epoch": first._loader_epoch,
                                              "offset": first._batch_offset}

    other = tmp_path / "b"
    other.mkdir()
    curriculum_to_json(cur, other / "curriculum.json")
    loaded = Trainer(args(other, load_dir=str(tmp_path / "a/checkpoints/1.pt")))
    loaded.load_models()
    assert loaded.step == 2 and len(loaded.histories["photometry_losses"]) == 2

    fresh = Trainer(args(other))
    fresh.load_models()
    assert fresh.step == 0 and fresh.histories["photometry_losses"] == []

    inf = Inferencer(tmp_path / "a/checkpoints/2.pt", image_size=16, num_imgs=2,
                     device="cpu")
    grid = read_png(inf.render_imgs(is_fixed=False))
    assert grid.shape == (4 * 16, 2 * 16, 3)


# the JAX Trainer's file names for a run to stop_step 8 with
# sampling_interval 3 and eval_freq 4 (checkpoints after steps 3 and 7, and
# the final one at 8; grids after steps 2, 5 and 8), `.pt` for `.ckpt`
E2E_FILES = sorted(
    [f"checkpoints/{s}.{ext}" for s in (3, 7, 8) for ext in ("pt", "json")]
    + [f"samples/{v}/{s:06}.png" for v in ("trainview", "valview", "testview")
       for s in (2, 5, 8)]
    + ["curriculum.json", "train_spec.txt"])
E2E_DIRS = ["checkpoints", "evaluation", "logs", "samples", "samples/testview",
            "samples/trainview", "samples/valview"]


def test_end_to_end_run_and_resume_across_a_milestone(dataset, tmp_path):
    """The smoke preset across a data-affecting milestone at step 5, to
    stop_step 8: the JAX Trainer's directory layout, and a run resumed
    from the step-3 checkpoint with the same histories (atol 1e-6) and
    byte-equal sample grids after the resume point."""
    cur = smoke_curriculum(dataset)
    flags = dict(stop_step=8, sampling_interval=3, eval_freq=4)
    full = run(tmp_path / "full", cur, **flags)
    out = tmp_path / "full"
    assert sorted(str(p.relative_to(out)) for p in out.rglob("*") if p.is_file()) == E2E_FILES
    assert sorted(str(p.relative_to(out)) for p in out.rglob("*") if p.is_dir()) == E2E_DIRS
    assert full.step == 9 and full.step_config.render.img_size == cur[5]["img_size"]
    assert len(full.histories["photometry_losses"]) == 9
    assert len(full.histories["photometry_losses_val"]) == 3
    assert all(np.isfinite(v) for v in full.histories["generator_losses"])

    part = tmp_path / "resumed"
    (part / "checkpoints").mkdir(parents=True)
    for name in ("3.pt", "3.json"):
        shutil.copy(out / "checkpoints" / name, part / "checkpoints" / name)
    resumed = run(part, cur, **flags)
    assert resumed.step == 9
    for key in HISTORY_KEYS:
        a, b = full.histories[key], resumed.histories[key]
        assert len(a) == len(b), key
        if a:
            np.testing.assert_allclose(np.asarray(b, np.float64), np.asarray(a, np.float64),
                                       rtol=0, atol=1e-6, err_msg=key)
    for view in ("trainview", "valview", "testview"):
        for step in (5, 8):
            name = f"samples/{view}/{step:06}.png"
            assert (part / name).read_bytes() == (out / name).read_bytes(), name


@pytest.fixture
def restore_smoke_preset():
    """`--smoke` points CNG_DATASET_PATH at its fixture and reloads the
    smoke preset, which reads it; put both back for the tests after."""
    saved = os.environ.get("CNG_DATASET_PATH")
    yield
    if saved is None:
        os.environ.pop("CNG_DATASET_PATH", None)
    else:
        os.environ["CNG_DATASET_PATH"] = saved
    importlib.reload(importlib.import_module("conditioned_nerf_gan_torch.config.presets.smoke"))


def test_cli_smoke_on_the_cpu(tmp_path, restore_smoke_preset):
    """`--smoke --device cpu --stop_step 2` writes its fixture, trains and
    leaves the JAX Trainer's layout with a final checkpoint."""
    out = tmp_path / "smoke"
    assert train_cli.main(["-o", str(out), "--smoke", "--device", "cpu",
                           "--stop_step", "2", "-p", "1"]) == 0
    assert (out / "synthetic_data" / "ShapeNetCar").is_dir()
    assert sorted(p.name for p in (out / "checkpoints").iterdir()) == ["2.json", "2.pt"]
    for name in ("curriculum.json", "train_spec.txt", "logs", "evaluation",
                 "samples/trainview", "samples/valview", "samples/testview"):
        assert (out / name).exists(), name


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a card")
def test_cli_without_a_card_exits_2(tmp_path, capsys):
    assert train_cli.main(["-o", str(tmp_path / "x"), "--smoke"]) == 2
    assert "--device cpu" in capsys.readouterr().err
    assert not (tmp_path / "x").exists()


@pytest.mark.parametrize("flag", [["--distributed"], ["--coordinator", "localhost:1234"],
                                  ["--num_processes", "5"], ["--process_id", "1"]])
def test_cli_refuses_the_multi_process_flags(tmp_path, monkeypatch, flag):
    """The four multi-process flags, once refused, are taken now: each
    reaches `initialize_distributed` (the CNG_* variables filling in what
    the flags leave out), the Trainer gets the rank and the world size, and
    the process group is shut down after."""
    from conditioned_nerf_gan_torch import parallel
    from conditioned_nerf_gan_torch.parallel import distributed
    from conditioned_nerf_gan_torch.training import trainer as trainer_module

    for name, value in (("CNG_COORDINATOR", "envhost:9"), ("CNG_NUM_PROCESSES", "4"),
                        ("CNG_PROCESS_ID", "3")):
        monkeypatch.setenv(name, value)
    for name in ("LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(name, raising=False)
    started = {}

    def rendezvous(url, rank, world_size, timeout):
        # an in-process store that already holds the other ranks' host names
        started.update(url=url)
        store = distributed.dist.HashStore()
        for r in range(world_size):
            store.set(f"cng_host/{r}", f"host{r}")
        yield store, rank, world_size

    def init_process_group(**kwargs):
        started.update(kwargs)

    monkeypatch.setattr(distributed.dist, "rendezvous", rendezvous)
    monkeypatch.setattr(distributed.dist, "init_process_group", init_process_group)
    monkeypatch.setattr(distributed.dist, "new_group", lambda **kw: None)
    shut = []
    monkeypatch.setattr(parallel, "shutdown_distributed", lambda: shut.append(True))

    class StubTrainer:
        def __init__(self, args):
            started["trainer"] = args.device

        def load_models(self):
            pass

        def train(self):
            pass

    monkeypatch.setattr(trainer_module, "Trainer", StubTrainer)
    assert train_cli.main(["-o", str(tmp_path / "x"), "--device", "cpu", *flag]) == 0
    expect = {"--distributed": ("tcp://envhost:9", 4, 3),
              "--coordinator": ("tcp://localhost:1234", 4, 3),
              "--num_processes": ("tcp://envhost:9", 5, 3),
              "--process_id": ("tcp://envhost:9", 4, 1)}[flag[0]]
    assert (started["url"], started["world_size"], started["rank"]) == expect
    assert started["backend"] == "gloo"
    assert started["trainer"] == "cpu"
    assert shut == [True]
