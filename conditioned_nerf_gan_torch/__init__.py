"""conditioned_nerf_gan_torch — the PyTorch/CUDA port of conditioned_nerf_gan_tpu.

The JAX package beside it is the reference: every module here has a
counterpart at the same path there, and tests/test_torch_*.py hold each one
against it on the CPU. This package imports `torch`, never `jax` or `flax`
(the one exception is `bridge.convert_checkpoint`, which reads a JAX
checkpoint where flax is installed).

Layout (bottom-up, mirroring the JAX package):
    ops/          rays, volume integration, importance sampling;
                  `ops/kernels/` holds the wrappers of the hand-written
                  CUDA kernels (sources in `csrc/`, built at first use).
    models/       SIREN layers and SHORTSIREN, ResNet-PointNet, the generator,
                  the progressive discriminator.
    training/     losses, schedules, the GAN train step, the stage workload.
    infer/        the Inferencer and its CLI (`python -m
                  conditioned_nerf_gan_torch.infer`).
    bridge.py     flax param tree / JAX checkpoint -> torch state_dict.

Curricula (`conditioned_nerf_gan_tpu.config`) and the ShapeNet reader
(`conditioned_nerf_gan_tpu.data`) import neither jax nor flax and are shared
as they are.
"""

__version__ = "0.1.0"
