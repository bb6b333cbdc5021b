"""A JAX training state carried into the port's optimizers on the CPU: the
bridge's `load_optax_state` after two JAX train steps, then one step in
each package at the next stage's learning rates; and
`convert_train_checkpoint` on a JAX trainer checkpoint, which the port's
Trainer then resumes from. The models and step settings are
tests/test_torch_train.py's (deterministic renders, rng=None)."""

import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from conditioned_nerf_gan_tpu.data import make_synthetic_shapenet
from conditioned_nerf_gan_tpu.models import ImplicitGenerator3d as JGenerator
from conditioned_nerf_gan_tpu.models import RenderConfig as JRenderConfig
from conditioned_nerf_gan_tpu.models import ResnetPointnet as JPointnet
from conditioned_nerf_gan_tpu.models import make_discriminator as j_make_discriminator
from conditioned_nerf_gan_tpu.training import train_step as jts
from conditioned_nerf_gan_torch import bridge
from conditioned_nerf_gan_torch.config import curriculum_to_json, load_curriculum
from conditioned_nerf_gan_torch.models import ImplicitGenerator3d, RenderConfig
from conditioned_nerf_gan_torch.models import ResnetPointnet, make_discriminator
from conditioned_nerf_gan_torch.training import TrainStepConfig, create_train_state
from conditioned_nerf_gan_torch.training import make_train_step
from conditioned_nerf_gan_torch.training.trainer import Trainer, set_learning_rates
from test_torch_train import CFG, H, POLICY_J, POLICY_T, Z, _cams, _DeterministicGenerator


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def test_carried_state_steps_like_jax_at_the_next_stages_rates():
    """Two JAX steps at one stage's rates, the state carried across by the
    bridge (params and each optax chain's Adam state), then one step in
    each package at the next stage's rates. With beta1 0 the step divides
    by the carried second moment, so a fresh optimizer would move every
    parameter by ~lr instead. Tolerances are test_full_train_step_matches_
    jax's: updated params within 1% of the step where the update is not
    near 0; the new second moments within 1% (norm) of JAX's."""
    render = dict(CFG, ray_chunks=4, perturb=True, density_noise=False)
    common = dict(batch_split=2, enable_discriminator=True, photo_loss=True, load_pcl=True,
                  random_gen_img=False, noise_weight=0.0, r1_lambda=10.0, grad_clip=1.0,
                  z_reg_weight=0.01, grad_accum_scale=3.0, betas=(0.0, 0.9),
                  weight_decay=1e-3, mapping_lr_mult=0.5)
    stage_a = dict(common, gen_lr=1e-4, disc_lr=2e-4, enc_lr=5e-5)
    stage_b = dict(common, gen_lr=3e-5, disc_lr=7e-5, enc_lr=2e-5)
    B, alpha = 4, 0.5
    rng = np.random.default_rng(21)
    batches = [{
        "img": rng.uniform(-1, 1, (B, 16, 16, 3)).astype(np.float32),
        "cam2world": _cams(B, seed=22 + i).numpy(),
        "pcl": rng.uniform(-0.4, 0.4, (B, 64, 6)).astype(np.float32),
    } for i in range(3)]

    jgen = _DeterministicGenerator(JGenerator(siren_type="SHORTSIREN", z_dim=Z, hidden_dim=H,
                                              **POLICY_J))
    jenc = JPointnet(c_dim=Z, hidden_dim=16)
    jdisc = j_make_discriminator("ProgressiveDiscriminator")
    jcfg_a = jts.TrainStepConfig(render=JRenderConfig(**render), **stage_a)
    jcfg_b = jts.TrainStepConfig(render=JRenderConfig(**render), **stage_b)
    j_batches = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]
    state = jts.create_train_state(jax.random.PRNGKey(23), jgen, jenc, jdisc, j_batches[0],
                                   jcfg_a)
    step_a = jax.jit(jts.make_train_step(jgen, jenc, jdisc, jcfg_a))
    for b in j_batches[:2]:
        state, _ = step_a(state, b, jax.random.PRNGKey(24), jnp.float32(alpha),
                          jnp.float32(0.0))
    carried = state
    j_state, _ = jax.jit(jts.make_train_step(jgen, jenc, jdisc, jcfg_b))(
        carried, j_batches[2], jax.random.PRNGKey(25), jnp.float32(alpha), jnp.float32(0.0))

    tgen = ImplicitGenerator3d(z_dim=Z, hidden_dim=H, **POLICY_T)
    tenc = ResnetPointnet(c_dim=Z, hidden_dim=16)
    tdisc = make_discriminator("ProgressiveDiscriminator")
    tcfg_a = TrainStepConfig(render=RenderConfig(**render), **stage_a)
    tcfg_b = TrainStepConfig(render=RenderConfig(**render), **stage_b)
    t_state = create_train_state(tgen, tenc, tdisc, tcfg_a)
    nets = {"G": tgen, "E": tenc, "D": tdisc}
    for net, module in nets.items():
        module.load_state_dict(bridge.params_to_state_dict(_np(getattr(carried,
                                                                       f"params_{net}"))))
        bridge.load_optax_state(_np(getattr(carried, f"opt_{net}")), module,
                                getattr(t_state, f"opt_{net}"))
    t_state.step = int(carried.step)
    set_learning_rates(t_state, tcfg_b)
    old = {net: {k: v.detach().clone() for k, v in m.named_parameters()}
           for net, m in nets.items()}
    make_train_step(tcfg_b)(t_state, {k: torch.from_numpy(v) for k, v in batches[2].items()},
                            None, alpha, 0.0)

    lrs = {"G": tcfg_b.gen_lr, "E": tcfg_b.enc_lr, "D": tcfg_b.disc_lr}
    for net, module in nets.items():
        new = bridge.params_to_state_dict(_np(getattr(j_state, f"params_{net}")))
        opt = getattr(t_state, f"opt_{net}")
        _, _, nu = bridge._adam_state(_np(getattr(j_state, f"opt_{net}")))
        nu = bridge.params_to_state_dict(bridge._numpy_tree(nu))
        for name, p in module.named_parameters():
            assert int(opt.state[p]["step"]) == 3
            ref_nu, got_nu = nu[name].numpy(), opt.state[p]["exp_avg_sq"].numpy()
            assert np.linalg.norm(got_nu - ref_nu) <= 1e-2 * np.linalg.norm(ref_nu) + 1e-30, \
                f"{net} {name}"
            move = new[name].numpy() - old[net][name].numpy()
            where = np.abs(move) > 1e-2 * np.abs(move).max()
            if not where.any():
                continue
            np.testing.assert_allclose(p.detach().numpy()[where], new[name].numpy()[where],
                                       rtol=0, atol=1e-2 * lrs[net], err_msg=f"{net} {name}")


def test_convert_train_checkpoint_and_resume_from_it(tmp_path):
    """A JAX trainer checkpoint (the smoke preset's models, its Adam
    moments filled with seeded values) through `convert_train_checkpoint`:
    the port's Trainer resumes from the `.pt` with the JAX params, moments
    and step counts, the step counter and the JAX sidecar's histories."""
    from conditioned_nerf_gan_tpu.training import Trainer as JTrainer
    from conditioned_nerf_gan_tpu.training.checkpoints import save_checkpoint as j_save

    pytest.importorskip("cv2")  # the JAX fixture writer
    ds = make_synthetic_shapenet(tmp_path / "data", n_cars=2, n_views=3, img_size=16,
                                 n_points=256, voxel_resolutions=(32,))
    cur = load_curriculum(config_base="smoke")
    cur["dataset"]["path"] = str(ds)
    out = tmp_path / "run"
    out.mkdir()
    curriculum_to_json(cur, out / "curriculum.json")
    args = types.SimpleNamespace(output_dir=str(out), load_dir="", load_curriculum="",
                                 sampling_interval=100, print_freq=100, eval_freq=1000,
                                 n_epochs=1, stop_step=None, config=None, config_base="smoke",
                                 seed=0, profile_dir=None, device="cpu")
    jt = JTrainer(args)
    jt.load_models()
    rng = np.random.default_rng(31)

    def seeded(x):
        x = np.asarray(x)
        if np.issubdtype(x.dtype, np.floating):
            return rng.uniform(0.1, 1.0, x.shape).astype(x.dtype)
        return np.full_like(x, 7)  # Adam's count

    j_state = jax.device_get(jt.state)
    j_state = j_state.replace(step=np.asarray(8, np.int32),
                              **{f"opt_{n}": jax.tree.map(seeded, getattr(j_state, f"opt_{n}"))
                                 for n in "GED"})
    histories = {"photometry_losses": [0.5, 0.25], "loader_state": {"epoch": 1, "offset": 2}}
    path = j_save(out / "checkpoints", 7, j_state, histories)
    converted = bridge.convert_train_checkpoint(path)
    assert converted == out / "checkpoints" / "7.pt"

    pt = Trainer(args)
    pt.load_models()
    assert pt.step == pt.state.step == 8
    assert pt.histories["photometry_losses"] == [0.5, 0.25]
    assert pt._restored_loader_state == {"epoch": 1, "offset": 2}
    for net, attr in (("G", "generator"), ("E", "encoder"), ("D", "discriminator")):
        module, opt = getattr(pt.state, attr), getattr(pt.state, f"opt_{net}")
        params = bridge.params_to_state_dict(_np(getattr(j_state, f"params_{net}")))
        _, mu, nu = bridge._adam_state(getattr(j_state, f"opt_{net}"))
        mu = bridge.params_to_state_dict(bridge._numpy_tree(mu))
        nu = bridge.params_to_state_dict(bridge._numpy_tree(nu))
        for name, p in module.named_parameters():
            assert torch.equal(p.detach(), params[name]), (net, name)
            assert torch.equal(opt.state[p]["exp_avg"], mu[name]), (net, name)
            assert torch.equal(opt.state[p]["exp_avg_sq"], nu[name]), (net, name)
            assert int(opt.state[p]["step"]) == 7
