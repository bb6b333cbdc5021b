"""Models (port of conditioned_nerf_gan_tpu/models): SHORTSIREN, the
ResNet-PointNet encoder, the generator composition and the progressive
discriminator."""

from .discriminators import ProgressiveDiscriminator, make_discriminator
from .generator import ImplicitGenerator3d, RenderConfig
from .pointnet import ResnetPointnet, encode_pcl
from .siren import SIREN_REGISTRY, SIREN_SPECS, ConditionedSiren, make_siren

__all__ = [
    "ConditionedSiren",
    "ImplicitGenerator3d",
    "ProgressiveDiscriminator",
    "RenderConfig",
    "ResnetPointnet",
    "SIREN_REGISTRY",
    "SIREN_SPECS",
    "encode_pcl",
    "make_discriminator",
    "make_siren",
]
