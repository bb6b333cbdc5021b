"""Thousand-car ShapeNet preset family (reference configs/thousand/)."""

from .default import default, upsample_step
from .special import special
from .direct_volume import (
    dg,
    dg_dis,
    dRes,
    indirect,
    indirect_dis,
    dg_deepunet,
    dg_shortsiren,
    dg_doublesiren,
    dg_singlesiren,
    dg_shortsiren_dis,
    dg_shortsiren_dis_nophotoloss,
    dg_shortsiren_dis_nophotoloss_randomgenimg,
    doublesiren_dis_featurepyramid,
    doublesiren_dis,
)
from .featvol_cond_dis import (
    cond_nearest,
    cond_random,
    cond_furthest,
    cond_nearest_fix,
    cond_nearest_nophotoloss,
    cond_random_32,
    cond_random_nophotoloss_32,
    cond_random_nophotoloss,
    proj_random,
    chair_doublesiren_nophotoloss,
    chair_doublesiren_dis,
)
