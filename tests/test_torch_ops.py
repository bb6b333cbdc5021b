"""Port ops vs the JAX ops on the CPU: same inputs, same injected randomness.

Tolerance 1e-6 unless stated: both sides are fp32 elementwise/small-sum math,
so only rounding order differs (observed max differences in comments).
"""

import math

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from conditioned_nerf_gan_tpu import ops as jops
from conditioned_nerf_gan_torch import ops as tops
from conditioned_nerf_gan_torch.ops import rays as trays

TOL = 1e-6


def close(t, j, atol=TOL, rtol=0.0):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=atol, rtol=rtol)


def _cams(rng, n, up="y"):
    u = rng.uniform(0.05, 0.95, (n, 3)).astype(np.float32)
    jo = jops.sample_camera_positions(None, n, up_direction=up, cam_r_start=0.7,
                                      cam_r_end=1.5, uniforms=jnp.asarray(u))
    to = tops.sample_camera_positions(n, up_direction=up, cam_r_start=0.7,
                                      cam_r_end=1.5, uniforms=torch.from_numpy(u))
    return jo, to


@pytest.mark.parametrize("case", ["scalar", "row_offset", "batched_fov"])
def test_initial_rays(case):
    kw, fov_j, fov_t = {}, 49.13, 49.13
    if case == "row_offset":
        kw = dict(row_offset=3, full_height=12)
    elif case == "batched_fov":
        f = np.array([30.0, 49.1, 75.0], np.float32)
        fov_j, fov_t = jnp.asarray(f), torch.from_numpy(f)
    jp, jz, jd = jops.get_initial_rays(3, 7, fov_j, (10, 5), 0.25, 1.95, **kw)
    tp, tz, td = tops.get_initial_rays(3, 7, fov_t, (10, 5), 0.25, 1.95, **kw)
    for t, j in ((tp, jp), (tz, jz), (td, jd)):
        assert tuple(t.shape) == j.shape
        close(t, j)  # observed 1.2e-7 (linspace rounding)


def _pixel_rays_before(fov, width, height, dtype=torch.float32, row_offset=None,
                       full_height=None, device=None):
    """`ops.pixel_rays` as it was before a number became a device fill: the
    fov through `torch.as_tensor`, then the same `tan` and arithmetic."""
    x = torch.linspace(-1.0, 1.0, width, dtype=dtype, device=device)
    if row_offset is not None:
        fh = full_height if full_height is not None else height
        y = torch.linspace(-1.0, 1.0, fh, dtype=dtype,
                           device=device)[row_offset:row_offset + height]
    else:
        y = torch.linspace(-1.0, 1.0, height, dtype=dtype, device=device)
    xx = x[None, :].expand(height, width).reshape(-1)
    yy = y[:, None].expand(height, width).reshape(-1)
    fov_t = torch.as_tensor(fov, dtype=dtype, device=device)
    inv_tan = 1.0 / torch.tan(fov_t * (math.pi / 360.0))
    if fov_t.ndim == 0:
        return tops.normalize_vecs(torch.stack([xx, yy, inv_tan.expand(xx.shape)], dim=-1))
    B, n = fov_t.shape[0], xx.shape[0]
    return tops.normalize_vecs(torch.stack(
        [xx[None].expand(B, n), yy[None].expand(B, n), inv_tan[:, None].expand(B, n)],
        dim=-1))


FOV_FORMS = {
    "python_float": 49.13,
    "cpu_tensor_0d": torch.tensor(49.13),
    "numpy_per_image": np.array([30.0, 49.13, 75.0], np.float32),
    "numpy_per_image_f64": np.array([30.0, 49.13, 75.0]),
}


@pytest.mark.parametrize("rows", [{}, dict(row_offset=3, full_height=12)])
@pytest.mark.parametrize("form", sorted(FOV_FORMS))
def test_rays_bit_equal_to_the_copied_fov(form, rows, monkeypatch):
    """The rays of every form of fov (a number is a fill on the device, an
    array a copy that does not wait) are bit-equal to those of the earlier
    formulation, which copied each form with `torch.as_tensor`."""
    fov = FOV_FORMS[form]
    got = tops.pixel_rays(fov, 10, 5, **rows)
    want = _pixel_rays_before(fov, 10, 5, **rows)
    assert got.shape == want.shape and torch.equal(got, want)
    now = tops.get_initial_rays(3, 7, fov, (10, 5), 0.25, 1.95, **rows)
    monkeypatch.setattr(trays, "pixel_rays", _pixel_rays_before)
    before = tops.get_initial_rays(3, 7, fov, (10, 5), 0.25, 1.95, **rows)
    for a, b in zip(now, before, strict=True):
        assert a.shape == b.shape and torch.equal(a, b)


def test_perturb_and_transform_rays():
    rng = np.random.default_rng(0)
    jp, jz, jd = jops.get_initial_rays(2, 6, 49.13, (4, 4), 0.25, 1.95)
    tp, tz, td = tops.get_initial_rays(2, 6, 49.13, (4, 4), 0.25, 1.95)
    u = rng.uniform(size=jz.shape).astype(np.float32)
    jp, jz = jops.perturb_points(jp, jz, jd, uniforms=jnp.asarray(u))
    tp, tz = tops.perturb_points(tp, tz, td, uniforms=torch.from_numpy(u))
    close(tp, jp)
    close(tz, jz)
    jo, to = _cams(rng, 2)
    jc = jops.create_cam2world_matrix(jo)
    tc = tops.create_cam2world_matrix(to)
    close(tc, jc)
    jout = jops.transform_rays(jp, jz, jd, jc)
    tout = tops.transform_rays(tp, tz, td, tc)
    for t, j in zip(tout, jout):
        close(t, j, atol=1e-6)  # observed 2.4e-7


@pytest.mark.parametrize("up", ["y", "z"])
def test_cameras_and_depth(up):
    rng = np.random.default_rng(1)
    jo, to = _cams(rng, 5, up)
    close(to, jo)
    close(tops.create_cam2world_matrix(to, up), jops.create_cam2world_matrix(jo, up))
    dist = rng.uniform(0.3, 1.9, (5, 9, 1)).astype(np.float32)
    dirs = rng.normal(size=(5, 9, 3)).astype(np.float32)
    close(tops.distance2depth(torch.from_numpy(dist), torch.from_numpy(dirs)),
          jops.distance2depth(jnp.asarray(dist), jnp.asarray(dirs)))


@pytest.mark.parametrize("mode", ["uniforms", "det", "edges"])
def test_sample_pdf(mode):
    rng = np.random.default_rng(2)
    R, S, n = 16, 10, 12
    bins = np.sort(rng.uniform(0.25, 1.95, (R, S + 1)), axis=1).astype(np.float32)
    weights = rng.uniform(0, 1, (R, S)).astype(np.float32)
    weights[3] = 0.0  # an all-empty ray: the +eps pdf is uniform
    u = rng.uniform(size=(R, n)).astype(np.float32)
    if mode == "edges":  # u at 0 and 1 exercise the empty-set clamps
        u[:, 0], u[:, -1] = 0.0, 1.0
    kw_j = dict(det=True) if mode == "det" else dict(uniforms=jnp.asarray(u))
    kw_t = dict(det=True) if mode == "det" else dict(uniforms=torch.from_numpy(u))
    j = jops.sample_pdf(jnp.asarray(bins), jnp.asarray(weights), n, **kw_j)
    t = tops.sample_pdf(torch.from_numpy(bins), torch.from_numpy(weights), n, **kw_t)
    close(t, j, atol=2e-6)  # observed 8.3e-7: cumsum order


def test_merge_is_fine_first_and_stable():
    """Tied depths keep the first set (fine) before the second (coarse)."""
    z_a = np.array([[[[0.5], [1.0], [1.5]]]], np.float32)
    z_b = np.array([[[[0.5], [1.0], [2.0]]]], np.float32)
    out_a = np.full((1, 1, 3, 4), 1.0, np.float32)
    out_b = np.full((1, 1, 3, 4), 2.0, np.float32)
    j_out, j_z = jops.merge_sorted_samples(*map(jnp.asarray, (out_a, z_a, out_b, z_b)))
    t_out, t_z = tops.merge_sorted_samples(*map(torch.from_numpy, (out_a, z_a, out_b, z_b)))
    np.testing.assert_array_equal(t_out.numpy(), np.asarray(j_out))
    np.testing.assert_array_equal(t_z.numpy(), np.asarray(j_z))
    np.testing.assert_array_equal(t_out.numpy()[0, 0, :, 0], [1, 2, 1, 2, 1, 2])

    rng = np.random.default_rng(3)
    z = np.round(rng.uniform(0, 2, (2, 5, 8, 1)) * 4) / 4  # many ties
    o = rng.normal(size=(2, 5, 8, 4))
    args = [x.astype(np.float32) for x in (o, z, o[::-1].copy(), z[::-1].copy())]
    j_out, j_z = jops.merge_sorted_samples(*map(jnp.asarray, args))
    t_out, t_z = tops.merge_sorted_samples(*map(torch.from_numpy, args))
    np.testing.assert_array_equal(t_out.numpy(), np.asarray(j_out))
    np.testing.assert_array_equal(t_z.numpy(), np.asarray(j_z))


@pytest.mark.parametrize("opts", [
    dict(),
    dict(white_back=True),
    dict(last_back=True),
    dict(white_back=True, clamp_mode="softplus"),
    dict(fill_mode="debug"),
    dict(fill_mode="weight"),
])
def test_volume_integrate(opts):
    rng = np.random.default_rng(4)
    B, R, S = 2, 6, 9
    rgb_sigma = rng.normal(0, 3, (B, R, S, 4)).astype(np.float32)
    z = np.sort(rng.uniform(0.25, 1.95, (B, R, S, 1)), axis=2).astype(np.float32)
    noise = rng.normal(size=(B, R, S, 1)).astype(np.float32)
    j = jops.volume_integrate(jnp.asarray(rgb_sigma), jnp.asarray(z), noise_std=0.5,
                              noise=jnp.asarray(noise), **opts)
    t = tops.volume_integrate(torch.from_numpy(rgb_sigma), torch.from_numpy(z),
                              noise_std=0.5, noise=torch.from_numpy(noise), **opts)
    for a, b in zip(t, j):
        close(a, b, atol=2e-6)  # observed 4.8e-7: exp/cumprod rounding


@pytest.mark.parametrize("opts", [dict(), dict(white_back=True, clamp_mode="softplus"),
                                  dict(last_back=True)])
def test_volume_integrate_grads_bit_equal_to_torch_cumprod(opts, monkeypatch):
    """The transmittance's cumprod differentiates without torch's test for
    zeros (a wait on the device): its factors are never zero, so the grads
    are torch.cumprod's, bit for bit, with large densities too (factors
    of 1e-10)."""
    from conditioned_nerf_gan_torch.ops import integration

    rng = np.random.default_rng(6)
    B, R, S = 2, 6, 9
    rgb_sigma = rng.normal(0, 3, (B, R, S, 4)).astype(np.float32)
    rgb_sigma[0, :2, 3:, 3] = 1e4
    z = np.sort(rng.uniform(0.25, 1.95, (B, R, S, 1)), axis=2).astype(np.float32)
    g = [torch.from_numpy(rng.normal(size=s).astype(np.float32))
         for s in ((B, R, 3), (B, R, 1), (B, R, S, 1))]

    def grads():
        x = torch.from_numpy(rgb_sigma).requires_grad_()
        outs = tops.volume_integrate(x, torch.from_numpy(z), **opts)
        sum((o * gi).sum() for o, gi in zip(outs, g)).backward()
        return outs, x.grad

    outs, grad = grads()
    monkeypatch.setattr(integration, "cumprod_of_nonzeros", torch.cumprod)
    outs_before, grad_before = grads()
    assert all(torch.equal(a, b) for a, b in zip(outs, outs_before))
    assert torch.isfinite(grad).all() and torch.equal(grad, grad_before)
