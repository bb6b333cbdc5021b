"""SIREN/FiLM building blocks and the mapping networks (port of
conditioned_nerf_gan_tpu/models/layers.py).

Weights are (out, in) as in `nn.Linear`; the init schemes replicate the JAX
package's (which replicate PyTorch's), drawn from an explicit
`torch.Generator`:
  * torch default:        W, b ~ U(+-1/sqrt(fan_in))
  * frequency_init(freq): W ~ U(+-sqrt(6/fan_in)/freq)
  * first_layer_film_sine: W ~ U(+-1/fan_in)
  * kaiming_leaky(a=0.2): W ~ N(0, gain^2/fan_in), gain = sqrt(2/(1+a^2)),
                          times `scale` (0.25 on the mapping net's last layer)

Everything here is fp32 unless a layer is given a `compute_dtype`: then
`FiLMLayer`, `SirenLayer`, `ResSirenBlock` and `TorchLinear` do what the JAX
layers do under the presets' bf16 policy, each cast written where the JAX
package writes it. Do not wrap
any of it in `torch.autocast`: the sin inputs must stay fp32 (freq*x with
freq ~ 30-45 is far too coarse in bf16).
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.fastmath import fast_sin

Init = Callable[[torch.Tensor, "torch.Generator | None"], None]


def torch_default_uniform(weight: torch.Tensor, generator=None) -> None:
    bound = 1.0 / math.sqrt(weight.shape[1])
    weight.uniform_(-bound, bound, generator=generator)


def frequency_init(freq: float) -> Init:
    def init(weight, generator=None):
        bound = math.sqrt(6.0 / weight.shape[1]) / freq
        weight.uniform_(-bound, bound, generator=generator)

    return init


def first_layer_film_sine_init(weight: torch.Tensor, generator=None) -> None:
    bound = 1.0 / weight.shape[1]
    weight.uniform_(-bound, bound, generator=generator)


def kaiming_leaky_init(scale: float = 1.0, a: float = 0.2) -> Init:
    gain = math.sqrt(2.0 / (1.0 + a * a))

    def init(weight, generator=None):
        std = gain / math.sqrt(weight.shape[1])
        weight.normal_(0.0, std * scale, generator=generator)

    return init


def zeros_init(weight: torch.Tensor, generator=None) -> None:
    weight.zero_()


class _MixedLinear(torch.autograd.Function):
    """x @ W^T with `dtype` operands and fp32 sums and output, and a
    backward whose operands are `dtype` too (the cotangent rounded to it),
    summed in fp32: the JAX package's `ops/mixed.py::mixed_dot` and its
    custom VJP. The grads come back in the primal dtypes."""

    @staticmethod
    def forward(ctx, x, weight, dtype):
        xl, wl = x.to(dtype), weight.to(dtype)
        ctx.save_for_backward(xl, wl)
        ctx.dtypes = (x.dtype, weight.dtype)
        # bf16 products are exact in fp32: round the operands, multiply in fp32
        return F.linear(xl.float(), wl.float())

    @staticmethod
    def backward(ctx, g):
        xl, wl = ctx.saved_tensors
        x_dtype, w_dtype = ctx.dtypes
        gl = g.to(xl.dtype).float()
        dx = (gl @ wl.float()).to(x_dtype)
        dw = (gl.reshape(-1, gl.shape[-1]).t() @ xl.reshape(-1, xl.shape[-1]).float())
        return dx, dw.to(w_dtype), None


class TorchLinear(nn.Module):
    """Linear layer with the JAX package's init choices.

    The bias is U(+-1/sqrt(fan_in)) unless `bias_init_zero`; `use_bias=False`
    drops it.

    `compute_dtype` (None: fp32) is the JAX layer's `dtype`, params staying
    fp32. With `fp32_out=False` (the AMP policy of PointNet) the operands
    are cast to it, the product is rounded to it and the bias is added in
    it; with `fp32_out=True` (the default) the operands are cast to it and
    the product is summed and returned in fp32, with `_MixedLinear`'s
    backward.

    `extra` (B, 1, K_e) is an operand constant over the point axis, the
    policy's form alone: under a compute_dtype the layer computes
    `self(concat([x, broadcast(extra)], -1))` with one weight of fan_in
    K_x + K_e as the JAX layer does, a once-per-batch product with the
    weight's tail columns added to the per-point one, each rounded as the
    JAX layer rounds it. The fp32 path takes the concat itself.
    """

    def __init__(self, in_features: int, out_features: int, *,
                 kernel_init: Init = torch_default_uniform, use_bias: bool = True,
                 bias_init_zero: bool = False, compute_dtype: torch.dtype | None = None,
                 fp32_out: bool = True, generator: torch.Generator | None = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.fp32_out = fp32_out
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features)) if use_bias else None
        with torch.no_grad():
            kernel_init(self.weight, generator)
            if self.bias is not None:
                if bias_init_zero:
                    self.bias.zero_()
                else:
                    bound = 1.0 / math.sqrt(in_features)
                    self.bias.uniform_(-bound, bound, generator=generator)

    def forward(self, x: torch.Tensor, extra: torch.Tensor | None = None) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is None:
            if extra is not None:
                raise ValueError("TorchLinear: `extra=` is the compute_dtype policy's form; "
                                 "the fp32 path takes the concat itself")
            return F.linear(x, self.weight, self.bias)
        if extra is not None:
            dx = x.shape[-1]
            w_x, w_e = self.weight[:, :dx], self.weight[:, dx:]
            if self.fp32_out:
                y = (F.linear(x.to(dt).float(), w_x.to(dt).float())
                     + F.linear(extra.to(dt).float(), w_e.to(dt).float()))
            else:
                y = F.linear(x.to(dt), w_x.to(dt)) + F.linear(extra.to(dt), w_e.to(dt))
        elif self.fp32_out:
            y = _MixedLinear.apply(x, self.weight, dt)
        else:
            y = F.linear(x.to(dt), self.weight.to(dt))
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y


class FiLMLayer(nn.Module):
    """sin(freq * (W x + b) + phase). freq/phase are per batch element (B, F),
    broadcast over the point axis, or per point (B, N, F) (TALLSIREN's
    `pointfeat` mapping).

    fp32 without a `compute_dtype`. With one, the JAX layer's policy
    (models/layers.py FiLMLayer): for freq per batch element, TorchLinear's
    fold_scale branch, freq folded into the weights and rounded to
    compute_dtype, x rounded to it, products summed in fp32, plus bias *
    freq and the phase; for freq per point, `_MixedLinear`'s bf16 operands
    and fp32 sums plus the bias, then freq * y + phase in fp32. Either way
    the sin (`fast_sin` with `use_fast_sin`, else `torch.sin`, as on the
    fp32 path) runs in fp32 and the output is stored in compute_dtype."""

    def __init__(self, in_features: int, hidden_dim: int, *,
                 kernel_init: Init = frequency_init(25),
                 compute_dtype: torch.dtype | None = None, use_fast_sin: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.linear = TorchLinear(in_features, hidden_dim, kernel_init=kernel_init,
                                  generator=generator)
        self.compute_dtype = compute_dtype
        self.sin = fast_sin if use_fast_sin else torch.sin

    def forward(self, x, freq, phase_shift):
        dt = self.compute_dtype
        if dt is not None and freq.ndim == 2 and x.ndim == 3:
            scaled = (self.linear.weight.t()[None] * freq[:, None, :]).to(dt)
            # operands rounded to dt, multiplied and summed in fp32 (a dt
            # matmul would round its output too)
            y = torch.bmm(x.to(dt).float(), scaled.float())
            y = y + (self.linear.bias * freq)[:, None, :]
            return self.sin(y + phase_shift[:, None, :]).to(dt)
        if dt is None:
            x = self.linear(x)
        else:
            x = _MixedLinear.apply(x, self.linear.weight, dt) + self.linear.bias
        if freq.ndim == x.ndim - 1:
            freq = freq[:, None, :]
            phase_shift = phase_shift[:, None, :]
        y = self.sin(freq * x + phase_shift)
        return y if dt is None else y.to(dt)


class SirenLayer(nn.Module):
    """sin(W x + b): a SIREN layer without FiLM. Under a `compute_dtype`
    (the JAX layer's policy) the linear takes `_MixedLinear`'s bf16
    operands and fp32 sums, the sin (`fast_sin` with `use_fast_sin`) runs
    in fp32 and the output is stored in compute_dtype."""

    def __init__(self, in_features: int, hidden_dim: int, *,
                 kernel_init: Init = frequency_init(25),
                 compute_dtype: torch.dtype | None = None, use_fast_sin: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.linear = TorchLinear(in_features, hidden_dim, kernel_init=kernel_init,
                                  compute_dtype=compute_dtype, generator=generator)
        self.compute_dtype = compute_dtype
        self.sin = fast_sin if use_fast_sin else torch.sin

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.sin(self.linear(x))
        return y if self.compute_dtype is None else y.to(self.compute_dtype)


class ResSirenBlock(nn.Module):
    """sin(x + W_1 sin(W_0 x + b_0) + b_1), both linears `kernel_init`; under
    a `compute_dtype` each linear as in `SirenLayer`, the inner sin stored
    in compute_dtype, the sum taken in fp32 (x in compute_dtype promotes)
    and the output stored in compute_dtype. `linears.0/1` are the flax
    `TorchLinear_0/1`."""

    def __init__(self, hidden_dim: int, *, kernel_init: Init = frequency_init(25),
                 compute_dtype: torch.dtype | None = None, use_fast_sin: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.linears = nn.ModuleList([
            TorchLinear(hidden_dim, hidden_dim, kernel_init=kernel_init,
                        compute_dtype=compute_dtype, generator=generator)
            for _ in range(2)])
        self.compute_dtype = compute_dtype
        self.sin = fast_sin if use_fast_sin else torch.sin

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        net = self.sin(self.linears[0](x))
        if dt is not None:
            net = net.to(dt)
        y = self.sin(x + self.linears[1](net))
        return y if dt is None else y.to(dt)


class _MLPMapping(nn.Module):
    """z -> (frequencies, phase_shifts): `num_hidden` LeakyReLU(0.2) layers,
    kaiming-leaky init, last layer scaled by 0.25, output split in half
    (conditioned_nerf_gan_tpu/models/layers.py:282-298). `layers.i` is the
    flax `TorchLinear_i`. Applied to (..., z_dim): a latent per batch
    element or a feature per point."""

    num_hidden = 3

    def __init__(self, z_dim: int, hidden_dim: int, output_dim: int, *,
                 generator: torch.Generator | None = None):
        super().__init__()
        dims = [z_dim] + [hidden_dim] * self.num_hidden
        layers = [TorchLinear(i, o, kernel_init=kaiming_leaky_init(),
                              generator=generator)
                  for i, o in zip(dims[:-1], dims[1:])]
        layers.append(TorchLinear(hidden_dim, output_dim,
                                  kernel_init=kaiming_leaky_init(scale=0.25),
                                  generator=generator))
        self.layers = nn.ModuleList(layers)

    def forward(self, z):
        x = z
        for layer in self.layers[:-1]:
            x = F.leaky_relu(layer(x), negative_slope=0.2)
        freq, phase = self.layers[-1](x).chunk(2, dim=-1)
        return freq, phase


class CustomMappingNetwork(_MLPMapping):
    """3 hidden layers (layers.py:301-304)."""

    num_hidden = 3


class LongMappingNetwork(_MLPMapping):
    """5 hidden layers (layers.py:305-308)."""

    num_hidden = 5


class PointFeaturesMappingNetwork(_MLPMapping):
    """1 hidden layer, applied per point to the sampled features
    (layers.py:311-314)."""

    num_hidden = 1


class LinearMapping(nn.Module):
    """One torch-default linear layer, output split into (frequencies,
    phase_shifts): the FG variants' mapping from the U-Net's global
    feature. `layers.0` is the flax `TorchLinear_0`."""

    def __init__(self, in_features: int, output_dim: int, *,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.layers = nn.ModuleList([TorchLinear(in_features, output_dim,
                                                 generator=generator)])

    def forward(self, z):
        freq, phase = self.layers[0](z).chunk(2, dim=-1)
        return freq, phase
