"""Direct feature-volume experiment family.

Value parity with reference configs/thousand/direct_volume/{dg,dRes,indirect}.py.
Siren names use the reference's (stale) experiment spellings and are resolved
through `presets.ALIASES` (SURVEY §2.3). One deliberate fix: these voxel-
conditioned experiments explicitly set dataset.load_voxel=True/load_pcl=False
— the reference configs relied on an overlay that actually left special.py's
point-cloud path enabled, which would route them to the wrong encoder.
"""

from copy import deepcopy

from .default import upsample_step

dg = {
    # batch_split 2 is the TPU stage-0 memory knob for the voxel family
    # (batch 24 × 64³ U-Net + feature-volume render needs >16 GB unsplit on
    # v5e; the special.py grad_accum_scale 2 already matches the reference's
    # effective-gradient semantics at this stage). ray_chunks bounds the
    # per-split render activations the same way as the pcl path.
    upsample_step[0]: {"batch_size": 24, "batch_split": 2, "ray_chunks": 4},
    "enable_discriminator": False,
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
    "dataset": {"load_voxel": True, "load_pcl": False},
}

dg_dis = deepcopy(dg)
dg_dis["enable_discriminator"] = True

dg_deepunet = deepcopy(dg)
dg_deepunet["generator"]["z_dim"] = 512
dg_deepunet["unet"]["num_levels"] = 5

dg_shortsiren = deepcopy(dg)
dg_shortsiren["generator"]["siren_type"] = "SHORTSIREN_dg"

dg_doublesiren = deepcopy(dg)
dg_doublesiren["generator"]["siren_type"] = "DoubleSIREN_dg"

dg_singlesiren = deepcopy(dg)
dg_singlesiren["generator"]["siren_type"] = "SingleSIREN_dg"

dg_shortsiren_dis = deepcopy(dg_shortsiren)
dg_shortsiren_dis["enable_discriminator"] = True

dg_shortsiren_dis_nophotoloss = deepcopy(dg_shortsiren_dis)
dg_shortsiren_dis_nophotoloss["photo_loss"] = False
dg_shortsiren_dis_nophotoloss["random_gen_img"] = False

dg_shortsiren_dis_nophotoloss_randomgenimg = deepcopy(dg_shortsiren_dis_nophotoloss)
dg_shortsiren_dis_nophotoloss_randomgenimg["random_gen_img"] = True

doublesiren_dis_featurepyramid = deepcopy(dg_shortsiren_dis)
doublesiren_dis_featurepyramid["generator"]["siren_type"] = "DoubleSIREN_dg"
doublesiren_dis_featurepyramid["unet"]["type"] = "PyramidUNet3D"
doublesiren_dis_featurepyramid["generator"]["input_dim"] = 224

doublesiren_dis = deepcopy(dg_shortsiren_dis)
doublesiren_dis["generator"]["siren_type"] = "DoubleSIREN_dg"

dRes = {
    "enable_discriminator": True,
    "generator": {
        "siren_type": "TALLSIREN_dRes",
        "z_dim": 32,
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
        "return_global": False,
    },
    "dataset": {"load_voxel": True, "load_pcl": False},
}

indirect = {
    upsample_step[0]: {"batch_size": 24, "batch_split": 2, "ray_chunks": 4},
    upsample_step[2]: {"batch_split": 12},
    upsample_step[3]: {"batch_split": 12},
    "enable_discriminator": False,
    "generator": {
        "siren_type": "TALLSIREN",
        "z_dim": 32,
        "input_dim": 3,
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
        "return_global": False,
    },
    "dataset": {"load_voxel": True, "load_pcl": False},
}

indirect_dis = deepcopy(indirect)
indirect_dis["enable_discriminator"] = True
