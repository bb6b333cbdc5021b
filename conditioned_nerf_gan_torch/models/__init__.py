"""Models (port of conditioned_nerf_gan_tpu/models): every SIREN of the
registry, the ResNet-PointNet and 3-D U-Net encoders, the generator
composition and the seven discriminators."""

from .discriminators import ProgressiveDiscriminator, make_discriminator
from .generator import ImplicitGenerator3d, RenderConfig
from .pointnet import ResnetPointnet, encode_pcl
from .siren import SIREN_REGISTRY, SIREN_SPECS, ConditionedSiren, make_siren
from .unet3d import AbstractUNet3D, make_unet

__all__ = [
    "AbstractUNet3D",
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
    "make_unet",
]
