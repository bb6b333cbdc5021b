"""CPU-smoke config base: the `train.py -o test -p 1` flow at toy scale.

Mirrors the thousand/special structure (same schema, same loss/GAN settings)
with shapes small enough for a single-core CPU run on the synthetic fixture
dataset (BASELINE.json "CPU smoke" config).
"""

import math
import os

upsample_step = [0, 60, 120]

default = {
    upsample_step[0]: {
        "batch_size": 4,
        "num_steps": 12,
        "img_size": 16,
        "batch_split": 1,
        "gen_lr": 4e-4,
        "disc_lr": 4e-4,
        "enc_lr": 4e-4,
        "num_points_ratio": 0.125,
        "voxel_resolution": 32,
        "z_reg_weight": 0.01,
    },
    upsample_step[1]: {
        "batch_size": 4,
        "num_steps": 12,
        "img_size": 32,
        "batch_split": 2,
        "gen_lr": 2e-4,
        "disc_lr": 2e-4,
        "enc_lr": 2e-4,
        "num_points_ratio": 0.25,
        "voxel_resolution": 32,
        "z_reg_weight": 0.001,
    },
    upsample_step[2]: {
        "batch_size": 4,
        "num_steps": 16,
        "img_size": 32,
        "batch_split": 2,
        "gen_lr": 1e-4,
        "disc_lr": 1e-4,
        "enc_lr": 1e-4,
        "num_points_ratio": 0.25,
        "voxel_resolution": 32,
        "z_reg_weight": 0.0005,
    },
    "white_back": True,
    "fov": 49.134342641202636,
    "ray_start": 0.25,
    "ray_end": 1.95,
    "cam_r_start": 0.9,
    "cam_r_end": 1.3,
    "fade_steps": 30,
    "h_stddev": math.pi,
    "v_stddev": math.pi / 4 * 85 / 90,
    "h_mean": math.pi * 0.5,
    "v_mean": math.pi / 4 * 85 / 90,
    "topk_interval": 1000,
    "topk_v": 1,
    "betas": (0.0, 0.9),
    "unique_lr": False,
    "weight_decay": 0,
    "r1_lambda": 10,
    "grad_clip": 1,
    "clamp_mode": "relu",
    "z_dist": "gaussian",
    "hierarchical_sample": True,
    "z_lambda": 0,
    "pos_lambda": 0,
    "learnable_dist": False,
    "lock_view_dependence": True,
    "geo_loss": False,
    "photo_loss": True,
    "depth_loss": False,
    "depth_loss_weight": 1,
    "noise_weight": 0,
    "dropout_ratio": 0,
    "num_workers": 0,
    "enable_discriminator": True,
    "random_gen_img": True,
    "generator": {
        "siren_type": "SHORTSIREN",
        "z_dim": 64,
        "input_dim": 3,
        "output_dim": 4,
        "hidden_dim": 64,
    },
    "discriminator": "ProgressiveDiscriminator",
    "unet": {
        "type": "UNet3D",
        "in_channels": 4,
        "out_channels": 16,
        "f_maps": 8,
        "num_levels": 3,
        "is_segmentation": False,
        "final_sigmoid": False,
        "return_global": True,
    },
    "fid": {"subset": "val", "target_size": 32},
    "use_fast_sin": True,
    "sample_img_size": 32,
    "sample_num_steps": 12,
    "val_num_imgs": 4,
    "dataset": {
        "path": os.environ.get("CNG_DATASET_PATH", "data/ShapeNetCar"),
        "trainset": "thousand",
        "testset": "twenty",
        "load_voxel": False,
        "load_pcl": True,
        "load_depth": False,
        "cond_mode": False,
    },
}

special = {}

# Voxel-conditioned smoke variant (the direct_volume/dg_dis experiment family
# at toy scale: 3D U-Net encoder + feature-volume FG siren).
voxel = {
    "generator": {
        "siren_type": "SHORTSIREN_dg",  # alias → SHORTSIREN_FG
        "z_dim": 32,
        "input_dim": 16,
        "output_dim": 4,
        "hidden_dim": 64,
    },
    "unet": {
        "type": "UNet3D",
        "in_channels": 4,
        "out_channels": 16,
        "f_maps": 8,
        "num_levels": 3,
        "is_segmentation": False,
        "final_sigmoid": False,
        "return_global": True,
    },
    "dataset": {"load_voxel": True, "load_pcl": False},
}

# Conditioned-discriminator smoke variant (featvol_cond_dis family at toy
# scale: conditioning view concatenated on the discriminator input).
cond = {
    "generator": {
        "siren_type": "SHORTSIREN_dg",
        "z_dim": 32,
        "input_dim": 16,
        "output_dim": 4,
        "hidden_dim": 64,
    },
    "unet": {
        "type": "UNet3D",
        "in_channels": 4,
        "out_channels": 16,
        "f_maps": 8,
        "num_levels": 3,
        "is_segmentation": False,
        "final_sigmoid": False,
        "return_global": True,
    },
    "dataset": {"load_voxel": True, "load_pcl": False, "cond_mode": "random"},
    "discriminator": "ProgressiveDiscriminator_inputCat",
}
