"""Default hyperparameters for the thousand-car ShapeNet runs.

Value parity with reference configs/thousand/default.py:12-91 (4-stage
curriculum at steps 0/5k/15k/25k).
"""

import math

upsample_step = [0, 5000, 15000, 25000]

default = {
    upsample_step[0]: {
        "batch_size": 32,
        "num_steps": 48,
        "img_size": 32,
        "batch_split": 1,
        "gen_lr": 4e-5,
        "disc_lr": 4e-4,
        "enc_lr": 8e-5,
        "num_points_ratio": 0.0625,
        "voxel_resolution": 64,
        "z_reg_weight": 0.01,
    },
    upsample_step[1]: {
        "batch_size": 24,
        "num_steps": 48,
        "img_size": 64,
        "batch_split": 2,
        "gen_lr": 2e-5,
        "disc_lr": 2e-4,
        "enc_lr": 4e-5,
        "num_points_ratio": 0.25,
        "voxel_resolution": 64,
        "z_reg_weight": 0.001,
    },
    upsample_step[2]: {
        "batch_size": 4,
        "num_steps": 48,
        "img_size": 128,
        "batch_split": 4,
        "gen_lr": 10e-6,
        "disc_lr": 10e-5,
        "enc_lr": 2e-5,
        "num_points_ratio": 1.0,
        "voxel_resolution": 64,
        "z_reg_weight": 0.0005,
    },
    upsample_step[3]: {
        "batch_size": 4,
        "num_steps": 64,
        "img_size": 128,
        "batch_split": 4,
        "gen_lr": 10e-6,
        "disc_lr": 10e-5,
        "enc_lr": 2e-5,
        "num_points_ratio": 1.0,
        "voxel_resolution": 64,
        "z_reg_weight": 0.0001,
    },
    "white_back": True,
    "fov": 30,
    "ray_start": 0.7,
    "ray_end": 1.3,
    "cam_r_start": 0,
    "cam_r_end": 1,
    "fade_steps": 2000,
    "h_stddev": math.pi,
    "v_stddev": math.pi / 4 * 85 / 90,
    "h_mean": math.pi * 0.5,
    "v_mean": math.pi / 4 * 85 / 90,
    "topk_interval": 1000,
    "topk_v": 1,
    "betas": (0, 0.9),
    "unique_lr": False,
    "weight_decay": 0,
    "r1_lambda": 10,
    "grad_clip": 1,
    "discriminator": "ProgressiveDiscriminator",
    "clamp_mode": "relu",
    "z_dist": "gaussian",
    "hierarchical_sample": True,
    "z_lambda": 0,
    "pos_lambda": 0,
    "learnable_dist": False,
    "lock_view_dependence": False,
    "geo_loss": False,
    "photo_loss": False,
    # range-reduced polynomial sin: ~3x faster renders on TPU; ~1e-7 output
    # drift at trained weight scales (ops/fastmath.py)
    "use_fast_sin": True,
    # bf16 mixed precision (the TPU analogue of the reference's fp16
    # amp.autocast training, utils.py:644-663/803-829): matmul/conv operands
    # and relu-chain activations in bf16, params/grads/optimizer fp32, sin
    # epilogues and norm statistics fp32. No GradScaler needed on TPU.
    "compute_dtype": "bfloat16",
    # fused FiLM-SIREN Pallas kernel (forward + fused VJP): stage-2 train
    # step 1.155 -> 0.696 s/step, stage-0 0.157 -> 0.106 (BASELINE.md kernel
    # study). Self-gates on TPU + the bf16/fast-sin policy above, so this is
    # inert on CPU or under a fp32 override; multi-device meshes switch the
    # train step to the manual shard_map path (parallel/mesh.py).
    "use_pallas": True,
    # scan 8 train steps into one dispatched program (training/train_step.py
    # make_chained_step): each dispatch is a host<->device round trip, which
    # dominates the small stages — stage-0 in-run A/B on v5e-1: 0.134 ->
    # 0.098 s/step (1.37x), step-0 losses bit-identical, trajectories within
    # bf16 reassociation. Windows auto-trim at milestones and
    # print/sample/eval gates; partial windows fall back to the per-step
    # program, so logging/checkpoint cadence is unchanged.
    "steps_per_dispatch": 8,
}
