"""The port's spans (`utils/tracing.py`) on the CPU: nothing is built or
recorded without a profiler; under one, a train step and an Inferencer
request record their spans, nested under their roots, in the profiler's
trace too."""

import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from conditioned_nerf_gan_torch.infer.inference import (
    Inferencer,
    build_models,
    load_metadata,
    save_checkpoint,
)
from conditioned_nerf_gan_torch.models import ImplicitGenerator3d, RenderConfig
from conditioned_nerf_gan_torch.models import ResnetPointnet, make_discriminator
from conditioned_nerf_gan_torch.ops import create_cam2world_matrix, sample_camera_positions
from conditioned_nerf_gan_torch.training import (
    TrainStepConfig,
    create_train_state,
    make_train_step,
)
from conditioned_nerf_gan_torch.utils import tracing

CHUNKS = 4


def _cams(n, seed):
    u = torch.from_numpy(np.random.default_rng(seed).uniform(0.1, 0.9, (n, 3))
                         .astype(np.float32))
    return create_cam2world_matrix(sample_camera_positions(
        n, cam_r_start=0.7, cam_r_end=1.5, uniforms=u))


def _train_step():
    """A tiny D-then-G/E step on the CPU (the thesis policy; on the CPU the
    kernel wrappers take their fp32 references) -> a function running one."""
    torch.manual_seed(3)
    render = RenderConfig(img_size=16, num_steps=6, fov=30.0, ray_start=0.7, ray_end=1.3,
                          ray_chunks=CHUNKS, perturb=True, density_noise=False)
    cfg = TrainStepConfig(render=render, enable_discriminator=True, photo_loss=True,
                          load_pcl=True, random_gen_img=False, r1_lambda=10.0)
    G = ImplicitGenerator3d(z_dim=16, hidden_dim=32, compute_dtype=torch.bfloat16,
                            use_fast_sin=True, use_kernel=True)
    E = ResnetPointnet(c_dim=16, hidden_dim=16)
    D = make_discriminator("ProgressiveDiscriminator")
    state = create_train_state(G, E, D, cfg)
    step = make_train_step(cfg)
    rng = np.random.default_rng(5)
    batch = {"img": torch.from_numpy(rng.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)),
             "cam2world": _cams(2, seed=6),
             "pcl": torch.from_numpy(rng.uniform(-0.4, 0.4, (2, 64, 6)).astype(np.float32))}

    def run():
        _, metrics = step(state, batch, torch.Generator().manual_seed(7), 0.5, 0.0)
        assert all(np.isfinite(v.item()) for v in metrics.values())

    return run


@pytest.fixture(scope="module")
def inferencer(tmp_path_factory):
    """The thesis model's Inferencer on the CPU at 16² and 6 samples."""
    G, E = build_models(load_metadata(30000), generator=torch.Generator().manual_seed(0))
    ckpt = save_checkpoint(tmp_path_factory.mktemp("run") / "checkpoints" / "30000.pt",
                           30000, G, E)
    inf = Inferencer(ckpt, load_dataset=False, device="cpu", num_imgs=2, image_size=16)
    inf.curriculum.update(num_steps=6, ray_chunks=CHUNKS)
    return inf


def _request(inf):
    rng = np.random.default_rng(9)
    pcl = rng.uniform(-0.4, 0.4, (2, 64, 6)).astype(np.float32)
    z = inf.encode({"pcl": pcl})
    rgb, depth = inf.render_batched(z, _cams(2, seed=10).numpy(), z_batched=True)
    assert rgb.shape == (2, 16, 16, 3) and depth.shape == (2, 16, 16)


def test_without_a_profiler_a_span_builds_and_records_nothing(monkeypatch, inferencer):
    tracing.clear()

    def refuse(*args, **kwargs):
        raise AssertionError("a profiler range built with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    assert not torch.autograd._profiler_enabled()
    assert tracing.span("a") is tracing.span("b", device_time=True)
    _train_step()()
    _request(inferencer)
    assert tracing.records() == []


def test_a_train_step_records_its_spans_under_the_profiler():
    tracing.clear()
    run = _train_step()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    got = tracing.records()
    by_name = {}
    for r in got:
        by_name.setdefault(r["name"], []).append(r)
    (step,) = by_name["train.step"]
    (d_step,) = by_name["train.d_step"]
    (g_step,) = by_name["train.g_step"]
    assert step["parent"] is None and step["root"] == step["id"]
    assert d_step["parent"] == step["id"] and g_step["parent"] == step["id"]
    assert {r["root"] for r in got} == {step["id"]}
    assert len(by_name["train.optim"]) == 3  # D, G, E
    assert len(by_name["train.encode"]) == 2
    renders = by_name["gen.render"]
    assert len(renders) == 2
    for render in renders:  # the D step's render and the G step's
        chunks = [r for r in by_name["gen.chunk"] if r["parent"] == render["id"]]
        assert len(chunks) == CHUNKS
    # and each checkpointed chunk's recompute in the G step's backward
    assert len(by_name["gen.chunk"]) == 3 * CHUNKS
    # each render's field of view, a number copied to the device
    assert sorted(r["parent"] for r in by_name["infer.h2d"]) == sorted(
        r["id"] for r in renders)
    for r in got:
        assert r["end_ns"] >= r["start_ns"] and r["host_ms"] >= 0
        assert r["device_ms"] is None  # no CUDA here
    assert step["start_ns"] <= d_step["start_ns"] <= g_step["end_ns"] <= step["end_ns"]
    names = {e.name for e in prof.events()}
    assert set(by_name) <= names


def test_a_request_records_its_spans_under_the_profiler(inferencer):
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _request(inferencer)
    got = tracing.records()
    roots = [r for r in got if r["parent"] is None]
    assert [r["name"] for r in sorted(roots, key=lambda r: r["id"])] == [
        "infer.encode", "infer.render_batched"]
    encode, render_batched = sorted(roots, key=lambda r: r["id"])
    names = {}
    for r in got:
        names.setdefault(r["name"], []).append(r)
    # the cloud's copy (numpy) under encode; the cameras' (and here, on the
    # CPU, the latent's) under the render
    assert {r["root"] for r in names["infer.h2d"]} == {encode["id"], render_batched["id"]}
    (render,) = names["gen.render"]
    (to_host,) = names["infer.to_host"]
    assert render["root"] == to_host["root"] == render_batched["id"]
    assert len(names["gen.chunk"]) == CHUNKS
    assert set(names) <= {e.name for e in prof.events()}


def test_a_span_on_another_thread_keeps_the_open_root(monkeypatch):
    """A span on another thread, as on autograd's backward thread on the
    card (which the engine hands the profiler's state; a plain thread here
    is handed the flag): no parent on its own thread, the root of the span
    open in the process."""
    tracing.clear()
    monkeypatch.setattr(torch.autograd, "_profiler_enabled", lambda: True)

    def on_the_worker():
        with tracing.span("inner"):
            pass

    with tracing.span("outer"):
        worker = threading.Thread(target=on_the_worker)
        worker.start()
        worker.join(timeout=30)
    assert not worker.is_alive()
    with tracing.span("next"):
        pass
    inner, outer, after = tracing.records()
    assert (inner["name"], outer["name"], after["name"]) == ("inner", "outer", "next")
    assert inner["parent"] is None and inner["root"] == outer["id"]
    assert inner["thread"] != outer["thread"]
    assert after["root"] == after["id"]  # the first root closed
    tracing.clear()
    assert tracing.records() == []
