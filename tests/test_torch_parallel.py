"""The port's data parallelism and ray-sharded render (parallel/) on the CPU:
two gloo ranks (processes of their own, tests/torch_parallel_worker.py)
train the thesis step at a small width against JAX's manual shard_map step
on a 2-device CPU mesh, with the ranks' params bit-equal after the step;
the two-slab render against the plain render and JAX `render_ray_sharded`,
and through replicas; the loader's rank shards; the backend and the
start-up's argument resolution. The `dg` step, the barrier and the
torchrun start-up are in tests/test_torch_parallel_ranks.py. ~60 s of CPU
alone (the thesis step's ~45 s: the JAX manual-step compile and the two
ranks)."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from conditioned_nerf_gan_tpu.models import ImplicitGenerator3d as JGenerator
from conditioned_nerf_gan_tpu.models import RenderConfig as JRenderConfig
from conditioned_nerf_gan_tpu.models import ResnetPointnet as JPointnet
from conditioned_nerf_gan_tpu.models import make_discriminator as j_make_discriminator
from conditioned_nerf_gan_tpu.training import train_step as jts
from conditioned_nerf_gan_torch import bridge
from conditioned_nerf_gan_torch.models import ImplicitGenerator3d, RenderConfig
from conditioned_nerf_gan_torch.models import ResnetPointnet, make_discriminator
from conditioned_nerf_gan_torch.parallel import distributed, render_ray_sharded
from conditioned_nerf_gan_torch.training import (
    TrainStepConfig,
    build_stage_bench,
    create_train_state,
    make_train_step,
)
from conditioned_nerf_gan_torch.training.trainer import step_seed
from test_torch_train import POLICY_J, POLICY_T, Z, H, CFG, _DeterministicGenerator, _cams
from test_torch_train import _np_tree, _record_jax_grads
import torch_parallel_worker as worker


def test_two_rank_thesis_step_matches_jax_manual_shard_map_step(tmp_path, monkeypatch):
    """One D-then-G/E step of the thesis model (small width, R1, alpha 0.5,
    batch_split 2 of the per-rank batch, 4 ray chunks) on two gloo ranks
    against JAX `make_train_step(..., axis_name="data")` compiled with
    `compile_train_step(..., manual=True)` over `make_mesh(jax.devices()[:2])`:
    the averaged pre-clip grads at test_torch_train.py's tolerances, the
    averaged metrics, the updated params; the ranks' params bit-equal and
    one all-reduce per optimizer step."""
    from conditioned_nerf_gan_tpu.parallel import (
        compile_train_step,
        make_mesh,
        replicate,
        shard_batch,
    )

    render = dict(CFG, ray_chunks=4, perturb=True, density_noise=False)
    step_kwargs = dict(
        batch_split=2, enable_discriminator=True, photo_loss=True, load_pcl=True,
        random_gen_img=False, noise_weight=0.0, r1_lambda=10.0, grad_clip=1.0,
        z_reg_weight=0.01, gen_lr=1e-4, disc_lr=2e-4, enc_lr=5e-5, betas=(0.0, 0.9),
        weight_decay=1e-3, mapping_lr_mult=0.5)
    jcfg = jts.TrainStepConfig(render=JRenderConfig(**render), **step_kwargs)
    tcfg = TrainStepConfig(render=RenderConfig(**render), **step_kwargs)
    B, alpha = 8, 0.5  # 4 a rank, 2 a split
    rng = np.random.default_rng(31)
    batch = {
        "img": rng.uniform(-1, 1, (B, 16, 16, 3)).astype(np.float32),
        "cam2world": _cams(B, seed=32).numpy(),
        "pcl": rng.uniform(-0.4, 0.4, (B, 64, 6)).astype(np.float32),
    }
    jgen = _DeterministicGenerator(JGenerator(siren_type="SHORTSIREN", z_dim=Z, hidden_dim=H,
                                              **POLICY_J))
    jenc = JPointnet(c_dim=Z, hidden_dim=16)
    jdisc = j_make_discriminator("ProgressiveDiscriminator")
    j_batch = {k: jnp.asarray(v) for k, v in batch.items()}
    state = jts.create_train_state(jax.random.PRNGKey(33), jgen, jenc, jdisc, j_batch, jcfg)
    nets = [ImplicitGenerator3d(z_dim=Z, hidden_dim=H, **POLICY_T),
            ResnetPointnet(c_dim=Z, hidden_dim=16), make_discriminator("ProgressiveDiscriminator")]
    for module, params in zip(nets, (state.params_G, state.params_E, state.params_D)):
        module.load_state_dict(bridge.params_to_state_dict(_np_tree(params)))

    old = {"G": _np_tree(state.params_G), "E": _np_tree(state.params_E),
           "D": _np_tree(state.params_D)}  # the step donates the state
    j_recorded = _record_jax_grads(monkeypatch)
    mesh = make_mesh(jax.devices()[:2])
    j_step = compile_train_step(jts.make_train_step(jgen, jenc, jdisc, jcfg, axis_name="data"),
                                mesh, manual=True)
    repl = lambda x: replicate(x, mesh)  # noqa: E731
    j_state, j_metrics = j_step(repl(state), shard_batch(batch, mesh),
                                repl(jax.random.PRNGKey(34)), repl(jnp.float32(alpha)),
                                repl(jnp.float32(0.0)))
    jax.effects_barrier()

    torch.save({"nets": nets, "config": tcfg, "alpha": alpha, "seed": None,
                "batch": {k: torch.from_numpy(v) for k, v in batch.items()}},
               tmp_path / "inputs.pt")
    worker.spawn(worker.step_rank, 2, str(tmp_path))
    ranks = worker.assert_replicas_equal(tmp_path)
    assert ranks[0]["all_reduce_calls"] == 3  # D, G (with the metrics), E

    t_metrics = ranks[0]["metrics"][0]
    for name in ("d_loss", "g_loss", "photo_loss", "z_reg"):
        np.testing.assert_allclose(t_metrics[name], float(j_metrics[name]), rtol=1e-5,
                                   err_msg=name)
    new = {"G": j_state.params_G, "E": j_state.params_E, "D": j_state.params_D}
    lrs = {"G": tcfg.gen_lr, "E": tcfg.enc_lr, "D": tcfg.disc_lr}
    for net in "GED":
        ref = bridge.params_to_state_dict(_np_tree(j_recorded[net]))
        got = ranks[0]["grads"][net]
        assert set(ref) == set(got)
        for name, g in ref.items():
            t, g = got[name].numpy(), g.numpy()
            assert np.linalg.norm(t - g) <= 2e-3 * np.linalg.norm(g), f"{net} {name}"
            np.testing.assert_allclose(t, g, rtol=0, atol=1e-2 * np.abs(g).max() + 1e-12,
                                       err_msg=f"{net} {name}")
        # the first Adam step (beta1 0) moves by ~lr * sign(u): compare where
        # u is not near 0, to 1% of the step, as test_torch_train.py does
        norm = np.sqrt(sum(np.sum(g.numpy().astype(np.float64) ** 2) for g in ref.values()))
        clip = 1.0 if norm < tcfg.grad_clip else tcfg.grad_clip / norm
        old_p = bridge.params_to_state_dict(old[net])
        new_p = bridge.params_to_state_dict(_np_tree(new[net]))
        for name, p in ranks[0]["params"][net].items():
            u = clip * ref[name].numpy() + tcfg.weight_decay * old_p[name].numpy()
            where = np.abs(u) > 1e-2 * np.abs(u).max()
            np.testing.assert_allclose(p.numpy()[where], new_p[name].numpy()[where],
                                       rtol=0, atol=1e-2 * lrs[net], err_msg=f"{net} {name}")


def test_ray_sharded_render_is_bit_equal_and_matches_jax():
    """`render_ray_sharded` over [cpu, cpu] (one device named twice, two
    slabs of 8 rows) is bit-equal to the plain render, and within fp32
    roundings of JAX `render_ray_sharded` on a 2-device mesh; a noisy render
    decorrelates its slabs; an image size that does not divide is refused."""
    from conditioned_nerf_gan_tpu.parallel import make_mesh
    from conditioned_nerf_gan_tpu.parallel import render_ray_sharded as j_render_ray_sharded

    jgen = JGenerator(siren_type="SHORTSIREN", z_dim=Z, hidden_dim=H, **POLICY_J)
    jcfg = JRenderConfig(**dict(CFG, ray_chunks=4))
    z = np.random.default_rng(41).normal(size=(2, Z)).astype(np.float32)
    cams = _cams(2, seed=42)
    params = jgen.init(jax.random.PRNGKey(43), jnp.asarray(z), jnp.asarray(cams.numpy()),
                       JRenderConfig(img_size=4, num_steps=4))
    tgen = ImplicitGenerator3d(z_dim=Z, hidden_dim=H, **POLICY_T)
    tgen.load_state_dict(bridge.params_to_state_dict(_np_tree(params)))
    cfg = RenderConfig(**dict(CFG, ray_chunks=4))
    with torch.no_grad():
        plain = tgen(torch.from_numpy(z), cams, cfg, generator=None)
        sharded = render_ray_sharded(tgen, torch.from_numpy(z), cams, cfg, ["cpu", "cpu"])
        four = render_ray_sharded(tgen, torch.from_numpy(z), cams, cfg, ["cpu"] * 4)
    for got in (sharded, four):
        assert torch.equal(got[0], plain[0]) and torch.equal(got[1], plain[1])
    mesh = make_mesh(jax.devices()[:2])
    j_px, j_d = j_render_ray_sharded(jgen, params, jnp.asarray(z), jnp.asarray(cams.numpy()),
                                     jcfg, mesh)
    np.testing.assert_allclose(sharded[0].numpy(), np.asarray(j_px), atol=2e-5)
    np.testing.assert_allclose(sharded[1].numpy(), np.asarray(j_d), atol=2e-5)
    # a noisy render's two slabs draw different numbers (the depth shows the
    # perturbed samples once the sigma bias puts density in the rays)
    with torch.no_grad():
        tgen.siren.final_layer.bias[3] += 3.0
        plain = tgen(torch.from_numpy(z), cams, cfg, generator=None)
        noisy = render_ray_sharded(tgen, torch.from_numpy(z), cams,
                                   dataclasses.replace(cfg, perturb=True), ["cpu", "cpu"],
                                   generator_rng=torch.Generator().manual_seed(5))
    shift = noisy[1] - plain[1]
    assert noisy[1].shape == plain[1].shape and shift.abs().max() > 0
    assert not torch.equal(shift[:, :8], shift[:, 8:])

    with pytest.raises(ValueError, match="must divide over 3 devices"):
        render_ray_sharded(tgen, torch.from_numpy(z), cams, cfg, ["cpu"] * 3)


def test_ray_sharded_render_through_replicas(monkeypatch):
    """A render whose slabs run on other devices than the generator's goes
    through cached replicas, as a render over several cards does: torch
    names the CPU "cpu" and "cpu:0" as two devices, so a generator on "cpu"
    rendered over ["cpu:0", "cpu:0"] is copied once. The slabs are
    bit-equal to the plain render, the replica is reused, refreshed when a
    param changes in place, and evicted past `_REPLICAS_MAX`. The
    Inferencer's `shard_rays` cards start from its own."""
    from conditioned_nerf_gan_torch.infer.inference import shard_devices
    from conditioned_nerf_gan_torch.parallel import render

    monkeypatch.setattr(render, "_REPLICAS", {})
    torch.manual_seed(44)
    tgen = ImplicitGenerator3d(z_dim=Z, hidden_dim=H, **POLICY_T)
    cfg = RenderConfig(**dict(CFG, ray_chunks=4))
    z = torch.from_numpy(np.random.default_rng(45).normal(size=(2, Z)).astype(np.float32))
    cams = _cams(2, seed=46)
    key = (id(tgen), "cpu:0")
    replicas = []
    with torch.no_grad():
        for change in (0.0, 0.0, 3.0):
            if change:
                tgen.siren.final_layer.bias[3] += change
            plain = tgen(z, cams, cfg, generator=None)
            sharded = render_ray_sharded(tgen, z, cams, cfg, ["cpu:0", "cpu:0"])
            assert torch.equal(sharded[0], plain[0]) and torch.equal(sharded[1], plain[1])
            replicas.append(render._REPLICAS[key][1])
        # one copy, reused, its params refreshed in place after the change
        assert replicas[0] is not tgen and all(r is replicas[0] for r in replicas)
        assert torch.equal(replicas[0].siren.final_layer.bias, tgen.siren.final_layer.bias)
        monkeypatch.setattr(render, "_REPLICAS_MAX", 1)
        other = ImplicitGenerator3d(z_dim=Z, hidden_dim=H, **POLICY_T)
        render_ray_sharded(other, z, cams, cfg, ["cpu:0", "cpu:0"])
    assert list(render._REPLICAS) == [(id(other), "cpu:0")]

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert shard_devices(torch.device("cuda", 1), 128) == [
        torch.device("cuda", i) for i in (1, 2, 3, 0)]
    assert shard_devices(torch.device("cuda", 1), 126) is None
    assert shard_devices(torch.device("cpu"), 128) is None
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert shard_devices(torch.device("cuda", 0), 128) is None


@pytest.mark.parametrize("world", [2, 3])
def test_loader_rank_shards_are_disjoint_and_cover(tmp_path, world):
    """The loader's rank shards (`process_index` / `process_count`, the
    Trainer's and the eval's) are disjoint and together cover the epoch,
    the same permutation on every rank."""
    from conditioned_nerf_gan_torch.data import DataLoader

    class Indices:
        def __init__(self, n):
            self.n = n

        def __len__(self):
            return self.n

        def get_batch(self, idx):
            return {"index": np.asarray(idx)}

    seen = []
    for rank in range(world):
        loader = DataLoader(Indices(24), 2, shuffle=True, drop_last=False, seed=7,
                            process_index=rank, process_count=world, prefetch=0)
        seen.append([int(i) for batch in loader for i in batch["index"]])
    flat = [i for s in seen for i in s]
    assert sorted(flat) == list(range(24)) and len(set(flat)) == 24
    assert all(len(s) == 24 // world for s in seen)


def test_step_seed_folds_in_the_rank():
    """Rank 0's step seed is the one-process run's; every (rank, step) pair
    draws its own numbers."""
    assert step_seed(3, 17, 0) == step_seed(3, 17)
    seeds = {step_seed(3, s, r) for s in range(50) for r in range(8)}
    assert len(seeds) == 400 and max(seeds) < 2 ** 64


def test_backend_and_device_follow_the_cards(monkeypatch):
    """NCCL only where each rank has a card of its own: no more ranks on a
    host than it has cards, counted from the ranks' host names (2 hosts x 8
    cards take NCCL at 16 ranks); gloo on the CPU, with more ranks on a host
    than cards or with a pinned card; an unnumbered cuda device becomes the
    rank's card by its index on its host."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert distributed.choose_backend("cpu", 2) == "gloo"
    assert distributed.choose_backend("cuda", 2) == "nccl"
    assert distributed.choose_backend("cuda", 3) == "gloo"
    assert distributed.choose_backend("cuda:0", 2) == "gloo"
    assert distributed.rank_device("cuda", 3) == torch.device("cuda", 1)
    assert distributed.rank_device("cuda:0", 3) == torch.device("cuda", 0)
    assert distributed.rank_device("cpu", 3) == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    two_hosts = ["a"] * 8 + ["b"] * 8
    assert distributed.local_ranks(two_hosts, 11) == (3, 8)
    assert distributed.choose_backend("cuda", distributed.local_ranks(two_hosts, 11)[1]) == "nccl"
    one_host = ["a"] * 16
    assert distributed.local_ranks(one_host, 11) == (11, 16)
    assert distributed.choose_backend("cuda", distributed.local_ranks(one_host, 11)[1]) == "gloo"
    assert distributed.local_ranks(["a", "b", "a", "b"], 2) == (1, 2)


def test_initialize_falls_back_to_the_environment(monkeypatch):
    """Flags first, then CNG_COORDINATOR / CNG_NUM_PROCESSES /
    CNG_PROCESS_ID; a coordinator without a count or an id, or nothing at
    all, is refused."""
    for name in ("CNG_COORDINATOR", "CNG_NUM_PROCESSES", "CNG_PROCESS_ID", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(name, raising=False)
    assert distributed.resolve_arguments("h:1", 4, 2) == ("h:1", 4, 2)
    monkeypatch.setenv("CNG_COORDINATOR", "h:2")
    monkeypatch.setenv("CNG_NUM_PROCESSES", "3")
    monkeypatch.setenv("CNG_PROCESS_ID", "1")
    assert distributed.resolve_arguments() == ("h:2", 3, 1)
    assert distributed.resolve_arguments("h:1", 4, 0) == ("h:1", 4, 0)
    with pytest.raises(ValueError, match="process_id 3 is not a rank of 3"):
        distributed.initialize_distributed(process_id=3, device="cpu")
    monkeypatch.delenv("CNG_NUM_PROCESSES")
    with pytest.raises(ValueError, match="num_processes and process_id"):
        distributed.initialize_distributed(device="cpu")
    monkeypatch.delenv("CNG_COORDINATOR")
    with pytest.raises(ValueError, match="torchrun"):
        distributed.initialize_distributed(device="cpu")


def test_batch_split_must_divide_the_per_rank_batch():
    """The data-parallel step names the per-rank batch when batch_split
    does not divide it."""
    bench = build_stage_bench("thousand", stage=0, meta_overrides=dict(
        batch_size=3, img_size=8, num_steps=4, ray_chunks=0, num_points_ratio=1 / 512))
    cfg = dataclasses.replace(bench.config, batch_split=2, enable_discriminator=False)
    state = create_train_state(bench.generator, bench.encoder, None, cfg)
    step = make_train_step(cfg, group=object())
    batch = {k: torch.from_numpy(v) for k, v in bench.batch.items()}
    with pytest.raises(ValueError, match="must divide the per-rank batch 3"):
        step(state, batch, torch.Generator().manual_seed(0), 1.0, 0.0)
