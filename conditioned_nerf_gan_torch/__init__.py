"""conditioned_nerf_gan_torch — the PyTorch/CUDA port of conditioned_nerf_gan_tpu.

The JAX package beside it is the reference: every module here has a
counterpart at the same path there, and tests/test_torch_*.py hold each one
against it on the CPU. This package imports `torch`, never `jax` or `flax`:
`bridge.convert_checkpoint` and `bridge.convert_train_checkpoint` read a
JAX checkpoint with the port's own msgpack reader (`utils/flax_msgpack.py`).

Layout (bottom-up, mirroring the JAX package):
    ops/          rays, volume integration, importance sampling,
                  trilinear feature-volume sampling; `ops/kernels/` holds
                  the wrappers of the hand-written CUDA kernels (sources in
                  `csrc/`, built at first use).
    models/       SIREN layers, every SIREN of the registry, ResNet-PointNet,
                  the 3-D U-Nets, the generator, the seven discriminators.
    training/     losses, schedules, the GAN train step, the stage workload,
                  checkpoints and the Trainer.
    train.py      the train CLI (`python -m conditioned_nerf_gan_torch.train`).
    infer/        the Inferencer and its CLI (`python -m
                  conditioned_nerf_gan_torch.infer`).
    config/       the curriculum system and every preset.
    data/         the ShapeNet reader, the EXR decoder, the native loader,
                  the synthetic fixture writer.
    utils/        image grids, PNG decode/encode, cv2's resize rules, the
                  flax msgpack reader.
    tools/        the FiLM-SIREN kernel study (`python -m
                  conditioned_nerf_gan_torch.tools.bench_film_kernel`).
    bridge.py     flax param tree / JAX checkpoint -> torch state_dict.

`config/`, `data/` and `utils/` are the port's own copies of the JAX
package's modules of those names, which import no jax either; nothing here
imports `conditioned_nerf_gan_tpu`, and the tests hold the copies equal to
the originals.
"""

__version__ = "0.1.0"
