"""Faults planted in the program underneath an unchanged harness, for the
check that `correct` comes out false (test_faults.py on the CPU, and
calibrate.py's readings on the card at a cell's own size):

  state_unchanged  every optimizer step leaves its parameters as they were;
  half_batch       the step trains on the first half of each batch, its
                   means taken over that half;
  noisy_answer     (train) the generator's rendered images come out with
                   seeded N(0, 0.2^2) noise added to each pixel, where they
                   are produced (a scale, such as 0.9 x the images, is
                   undone for the gradients by the global-norm clip, and
                   moved the losses of one `dg` seed by under 0.5%);
  answer_altered   (serve) the rendered images and depths come out for the
                   wrong rows (each handed to the next view), where they are
                   produced.

One chip has no exchange between chips to leave out.
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def state_unchanged():
    from conditioned_nerf_gan_torch.training import train_step

    saved = train_step.ClippedAdam.step
    train_step.ClippedAdam.step = lambda self, closure=None: None
    try:
        yield
    finally:
        train_step.ClippedAdam.step = saved


@contextlib.contextmanager
def half_batch():
    from conditioned_nerf_gan_torch import training

    saved = training.make_train_step

    def make(config, group=None):
        inner = saved(config, group)

        def step(state, batch, generator, alpha, nerf_noise):
            half = {k: v[: v.shape[0] // 2] for k, v in batch.items()}
            return inner(state, half, generator, alpha, nerf_noise)

        return step

    training.make_train_step = make
    try:
        yield
    finally:
        training.make_train_step = saved


@contextlib.contextmanager
def _generator_output(alter):
    from conditioned_nerf_gan_torch.models.generator import ImplicitGenerator3d

    saved = ImplicitGenerator3d.forward

    def forward(self, *args, **kwargs):
        return alter(*saved(self, *args, **kwargs))

    ImplicitGenerator3d.forward = forward
    try:
        yield
    finally:
        ImplicitGenerator3d.forward = saved


def noisy_answer():
    import torch

    def alter(pixels, depth):
        gen = torch.Generator(device=pixels.device).manual_seed(0)
        noise = torch.randn(pixels.shape, generator=gen, device=pixels.device)
        return pixels + 0.2 * noise.to(pixels.dtype), depth

    return _generator_output(alter)


def answer_altered():
    return _generator_output(lambda pixels, depth: (pixels.roll(1, dims=0),
                                                    depth.roll(1, dims=0)))


TRAIN = {"state_unchanged": state_unchanged, "half_batch": half_batch,
         "noisy_answer": noisy_answer}
SERVE = {"answer_altered": answer_altered}
