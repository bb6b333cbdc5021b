"""Conditioned-discriminator experiment family.

Value parity with reference configs/thousand/featvol_cond_dis/{dg_cond,
dg_proj,chair}.py; same deliberate load_voxel fix as direct_volume.py.
"""

from copy import deepcopy

from .default import upsample_step

cond_nearest = {
    upsample_step[0]: {"batch_size": 24, "batch_split": 2, "ray_chunks": 4},
    "enable_discriminator": True,
    "generator": {
        "siren_type": "TALLSIREN_dg",
        "z_dim": 256,
        "input_dim": 32,
        "output_dim": 4,
        "hidden_dim": 256,
    },
    "unet": {
        "in_channels": 4,
        "out_channels": 32,
        "f_maps": 32,
        "num_levels": 4,
        "is_segmentation": False,
        "final_sigmoid": False,
        "return_global": True,
    },
    "dataset": {"cond_mode": "nearest", "load_voxel": True, "load_pcl": False},
    "discriminator": "ProgressiveDiscriminator_inputCat",
}

cond_random = deepcopy(cond_nearest)
cond_random["dataset"]["cond_mode"] = "random"

cond_furthest = deepcopy(cond_nearest)
cond_furthest["dataset"]["cond_mode"] = "furthest"

cond_nearest_fix = deepcopy(cond_nearest)
cond_nearest_fix["random_gen_img"] = False

cond_nearest_nophotoloss = deepcopy(cond_nearest)
cond_nearest_nophotoloss["photo_loss"] = False
cond_nearest_nophotoloss["random_gen_img"] = False

cond_random_32 = deepcopy(cond_random)
cond_random_32["dataset"]["voxel_resolution"] = 32

cond_random_nophotoloss_32 = deepcopy(cond_random_32)
cond_random_nophotoloss_32["photo_loss"] = False
cond_random_nophotoloss_32["random_gen_img"] = False

cond_random_nophotoloss = deepcopy(cond_nearest_nophotoloss)
cond_random_nophotoloss["dataset"]["cond_mode"] = "random"

proj_random = {
    upsample_step[0]: {"batch_size": 24, "batch_split": 2, "ray_chunks": 4},
    "enable_discriminator": True,
    "generator": {
        "siren_type": "TALLSIREN_dg",
        "z_dim": 256,
        "input_dim": 32,
        "output_dim": 4,
        "hidden_dim": 256,
    },
    "unet": {
        "in_channels": 4,
        "out_channels": 32,
        "f_maps": 32,
        "num_levels": 4,
        "is_segmentation": False,
        "final_sigmoid": False,
        "return_global": True,
    },
    "dataset": {"cond_mode": "random", "load_voxel": True, "load_pcl": False},
    "discriminator": "ProgressiveDiscriminator_projection",
}

chair_doublesiren_nophotoloss = {
    upsample_step[0]: {"batch_size": 24, "batch_split": 2, "ray_chunks": 4},
    "enable_discriminator": True,
    "generator": {
        "siren_type": "DoubleSIREN_dg",
        "z_dim": 256,
        "input_dim": 32,
        "output_dim": 4,
        "hidden_dim": 256,
    },
    "unet": {
        "type": "UNet3D",
        "in_channels": 4,
        "out_channels": 32,
        "f_maps": 32,
        "num_levels": 4,
        "is_segmentation": False,
        "final_sigmoid": False,
        "return_global": True,
    },
    "dataset": {
        "path": "data/ShapeNetChair",
        "trainset": "thousand",
        "testset": "twenty",
        "cond_mode": False,
        "voxel_resolution": 64,
        "load_voxel": True,
        "load_pcl": False,
    },
    "photo_loss": False,
    "random_gen_img": False,
}

chair_doublesiren_dis = deepcopy(chair_doublesiren_nophotoloss)
chair_doublesiren_dis["photo_loss"] = True
chair_doublesiren_dis["random_gen_img"] = True
