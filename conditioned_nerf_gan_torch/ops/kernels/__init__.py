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

__all__ = [
    "FilmSirenMLP",
    "cos7",
    "film_siren_mlp",
    "film_siren_mlp_bwd",
    "film_siren_mlp_folded",
    "film_siren_mlp_folded_vjp",
    "film_siren_mlp_reference",
    "fold_film",
    "sin7",
    "unfold_film_grads",
]
