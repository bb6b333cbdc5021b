"""Fast sin and cos polynomials (port of conditioned_nerf_gan_tpu/ops/fastmath.py).

`fast_sin` is a range-reduced 11th-order odd least-squares polynomial:

    x' = x - round(x / 2π) · 2π          (round half to even: torch.round)
    sin(x') ≈ x'·(c1 + x'²·(c3 + x'²·(c5 + x'²·(c7 + x'²·(c9 + x'²·c11)))))

Max abs error 3.4e-6 over arguments in [-45, 45] in fp32. The constants,
the range reduction and the order of every fp32 operation are the JAX
package's, so on fp32 inputs the two agree to the bit (tests hold that).
Its gradient is `fast_cos` of the same reduced argument, as the JAX
function's custom JVP defines it. The CUDA study kernels
(csrc/film_siren_study.cu) evaluate the same polynomial, rounding half to
even by the trunk's 1.5 x 2^23 shift.
"""

from __future__ import annotations

import math

import torch

_TWO_PI = 2.0 * math.pi
_INV_TWO_PI = 1.0 / _TWO_PI

# least-squares odd-polynomial fit of sin on [-pi, pi]
_C1 = 9.9999970703e-01
_C3 = -1.6666577215e-01
_C5 = 8.3325581177e-03
_C7 = -1.9812575520e-04
_C9 = 2.7040512127e-06
_C11 = -2.0534244526e-08

# even least-squares fit of cos on [-pi, pi] at chebyshev nodes (~1e-8 max err)
_D0 = 9.9999998904e-01
_D2 = -4.9999989102e-01
_D4 = 4.1666489215e-02
_D6 = -1.3887803571e-03
_D8 = 2.4769882906e-05
_D10 = -2.7079024307e-07
_D12 = 1.7245067986e-09


def _reduce(x: torch.Tensor) -> torch.Tensor:
    return x - torch.round(x * _INV_TWO_PI) * _TWO_PI


def _sin_poly(x: torch.Tensor) -> torch.Tensor:
    x = _reduce(x)
    x2 = x * x
    return x * (_C1 + x2 * (_C3 + x2 * (_C5 + x2 * (_C7 + x2 * (_C9 + x2 * _C11)))))


def fast_cos(x: torch.Tensor) -> torch.Tensor:
    """cos(x) to ~3e-6 absolute accuracy end to end, matching fast_sin."""
    x = _reduce(x)
    x2 = x * x
    return _D0 + x2 * (_D2 + x2 * (_D4 + x2 * (_D6 + x2 * (
        _D8 + x2 * (_D10 + x2 * _D12)))))


class _FastSin(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return _sin_poly(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return fast_cos(x) * g


def fast_sin(x: torch.Tensor) -> torch.Tensor:
    """sin(x) to ~3e-6 absolute accuracy; d/dx is `fast_cos(x)`."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _FastSin.apply(x)
    return _sin_poly(x)
