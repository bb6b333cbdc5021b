"""Curriculum/config system (reference configs/curriculums.py semantics):
the port's copy of conditioned_nerf_gan_tpu/config, presets included."""

from .curriculums import (
    extract_metadata,
    update_recursive,
    next_upsample_step,
    last_upsample_step,
    json_keys_to_int,
    load_curriculum,
    curriculum_to_json,
    curriculum_from_json,
    get_config_base,
)

__all__ = [
    "extract_metadata",
    "update_recursive",
    "next_upsample_step",
    "last_upsample_step",
    "json_keys_to_int",
    "load_curriculum",
    "curriculum_to_json",
    "curriculum_from_json",
    "get_config_base",
]
