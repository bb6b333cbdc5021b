"""Wrappers of the hand-written Hopper kernels (sources in `csrc/`)."""

from .film_siren import (
    FilmSirenMLP,
    cos7,
    film_siren_mlp,
    film_siren_mlp_bwd,
    film_siren_mlp_folded,
    film_siren_mlp_folded_vjp,
    film_siren_mlp_reference,
    fold_film,
    sin7,
    unfold_film_grads,
)
from .film_study import STUDY_MODES, film_siren_study, film_study_reference
from .trilinear import trilinear_fwd

__all__ = [
    "FilmSirenMLP",
    "STUDY_MODES",
    "cos7",
    "film_siren_mlp",
    "film_siren_mlp_bwd",
    "film_siren_mlp_folded",
    "film_siren_mlp_folded_vjp",
    "film_siren_mlp_reference",
    "film_siren_study",
    "film_study_reference",
    "fold_film",
    "sin7",
    "trilinear_fwd",
    "unfold_film_grads",
]
