"""Fused FiLM-SIREN forward and VJP: the CUDA kernels' wrappers and their
plain versions.

Port of conditioned_nerf_gan_tpu/ops/pallas/film_siren.py. The network, with
per-batch-element freq/phase:
    h_0 = sin(freq_0 * (x W_0 + b_0) + phase_0)
    h_l = sin(freq_l * (h_{l-1} W_l + b_l) + phase_l)
    out = h_{L-1} W_f + b_f                              (rgb + sigma, 4 ch)

Forward:
  * `film_siren_mlp_reference`: fp32, exact `torch.sin`; what the wrapper
    takes for CPU tensors (under plain autograd), as the JAX wrapper does
    off the TPU in both directions.
  * `film_siren_mlp_folded`: freq folded into the weights, operands rounded
    to `matmul_dtype` and multiplied in fp32, `sin7` — exactly the kernel's
    math, the comparator for the kernel on the card.
  * `film_siren_mlp`: the wrapper. On CUDA tensors it launches
    `csrc/film_siren_fwd.cu` (sm_90a) or raises; it never falls back. When
    an input needs grad it goes through `FilmSirenMLP`, whose backward
    launches `csrc/film_siren_bwd.cu`.

Gradient:
  * `film_siren_mlp_folded_vjp`: the plain version of the JAX
    `_backward_kernel` (the same roundings of h, cos7(pre), g and every
    dpre), the comparator for the backward kernel.
  * `film_siren_mlp_bwd`: the backward kernel's wrapper.
  * `unfold_film_grads`: folded-space grads back to (freq, phase, W, b);
    tiny plain torch that both of the above call.

The fold (`fold_film`) and its unwind are plain torch outside the kernels, as
they are outside `pallas_call` in the JAX package. Under a torch profiler
the CUDA branches record the spans `kern.film_fwd` and `kern.film_bwd`
(`utils/tracing.py`).
"""

from __future__ import annotations

import ctypes
import math

import torch

from ...utils import tracing

_TWO_PI = 2.0 * math.pi
_INV_TWO_PI = 1.0 / _TWO_PI

# odd degree-7 least-squares fit of sin on [-pi, pi] (the JAX kernel's
# _sin7): max abs error 2.6e-4 in fp32 after range reduction
_S1 = 9.9926289884e-01
_S3 = -1.6565644419e-01
_S5 = 7.9559223702e-03
_S7 = -1.4495299408e-04

# shapes the CUDA kernels are compiled for: csrc/film_siren_fwd.cu and
# csrc/film_siren_bwd.cu each have an instance for each input width (xyz
# points; sampled U-Net features; features and xyz, TALLSIREN_dgx; the
# features of a PyramidUNet3D's three levels) and take 2 to 8 layers
KERNEL_HIDDEN = 256
KERNEL_IN = 3
KERNEL_INS = (3, 32, 35, 224)
KERNEL_LAYERS = (2, 8)
KERNEL_OUT = 4
# csrc/film_siren_bwd.cu: points per sweep tile (the scratch is padded to a
# multiple of it), the fewest points per weight-grad segment, and the
# weight-grad work items to aim for (about three per SM of an H100)
BWD_TILE = 128
BWD_SEGMENT = 4096
BWD_ITEMS = 396


def bwd_xg_cols(din: int) -> int:
    """Columns of csrc/film_siren_bwd.cu's point/cotangent scratch: x, the
    cotangent's 4 columns, zeros to a whole number of 64-column blocks."""
    return -(-(din + KERNEL_OUT) // 64) * 64


def sin7(x: torch.Tensor) -> torch.Tensor:
    """Range-reduced degree-7 polynomial sin (the kernel's sin)."""
    x = x - torch.round(x * _INV_TWO_PI) * _TWO_PI
    x2 = x * x
    return x * (_S1 + x2 * (_S3 + x2 * (_S5 + x2 * _S7)))


def cos7(x: torch.Tensor) -> torch.Tensor:
    """d/dx sin7: the exact derivative of the kernel's forward (the range
    reduction is a constant shift almost everywhere; `torch.round` has no
    gradient)."""
    x = x - torch.round(x * _INV_TWO_PI) * _TWO_PI
    x2 = x * x
    return _S1 + x2 * (3.0 * _S3 + x2 * (5.0 * _S5 + x2 * (7.0 * _S7)))


def film_siren_mlp_reference(points, freq, phase, w0, b0, ws, bs, wf, bf):
    """fp32 reference. points (B, N, Din); freq/phase (B, L*H); w0 (Din, H);
    b0 (H); ws (L-1, H, H); bs (L-1, H); wf (H, 4); bf (4) -> (B, N, 4)."""
    L = 1 + ws.shape[0]
    H = w0.shape[1]
    h = torch.sin(freq[:, None, 0:H] * (points @ w0 + b0) + phase[:, None, 0:H])
    for l in range(L - 1):
        lo, hi = (l + 1) * H, (l + 2) * H
        h = torch.sin(freq[:, None, lo:hi] * (h @ ws[l] + bs[l])
                      + phase[:, None, lo:hi])
    return h @ wf + bf


def fold_film(freq, phase, w0, b0, ws, bs, matmul_dtype):
    """Fold freq into per-batch-element weights.

    sin(f*(xW+b)+p) = sin(x (W diag f) + (f*b+p)). Returns w0f (B, Din, H)
    and wsf (B, L-1, H, H) in matmul_dtype, c0 (B, H) and cs (B, L-1, H) fp32.
    """
    H = w0.shape[1]
    L = 1 + ws.shape[0]
    f = freq.reshape(freq.shape[0], L, H)
    p = phase.reshape(phase.shape[0], L, H)
    w0f = (w0[None] * f[:, 0][:, None, :]).to(matmul_dtype)
    c0 = f[:, 0] * b0 + p[:, 0]
    wsf = (ws[None] * f[:, 1:][:, :, None, :]).to(matmul_dtype)
    cs = f[:, 1:] * bs[None] + p[:, 1:]
    return w0f, c0, wsf, cs


def film_siren_mlp_folded(points, freq, phase, w0, b0, ws, bs, wf, bf,
                          matmul_dtype=torch.bfloat16, accum_dtype=torch.float32):
    """The kernel's math in plain torch: folded weights, `matmul_dtype`
    operands with `accum_dtype` accumulation (operands rounded, then
    multiplied in accum_dtype: a bf16 matmul would round its output too),
    `sin7`. Counterpart of the JAX `_folded_forward_jnp(sin_fn=_sin7)`.
    accum_dtype=float64 gives the same roundings of every operand with
    near-exact sums: the yardstick for how far fp32 summation order alone
    moves the result."""
    L = 1 + ws.shape[0]
    w0f, c0, wsf, cs = fold_film(freq, phase, w0, b0, ws, bs, matmul_dtype)

    def rnd(t):
        return t.to(matmul_dtype).to(accum_dtype)

    c0, cs = c0.to(accum_dtype), cs.to(accum_dtype)
    h = sin7(torch.bmm(rnd(points), w0f.to(accum_dtype)) + c0[:, None])
    for l in range(L - 1):
        h = sin7(torch.bmm(rnd(h), wsf[:, l].to(accum_dtype)) + cs[:, l][:, None])
    return (rnd(h) @ rnd(wf) + bf.to(accum_dtype)).float()


def unfold_film_grads(dw0f, dc0, dwsf, dcs, freq, w0, b0, ws, bs):
    """Folded-space grads -> (dfreq, dphase, dw0, db0, dws, dbs).

    With W_l^f = W_l diag(f_l) and c_l = f_l * b_l + phase_l (`fold_film`):
    dW_l = sum_b dW_l^f f_l, df_l = sum_k W_l dW_l^f + dc_l b_l,
    dphase_l = dc_l, db_l = sum_b dc_l f_l. The JAX `_backward_pallas`
    epilogue (film_siren.py:400-410). dw0f (B, Din, H), dc0 (B, H),
    dwsf (B, L-1, H, H), dcs (B, L-1, H); sums in their dtype.
    """
    B, L = freq.shape[0], 1 + ws.shape[0]
    H = w0.shape[1]
    f = freq.reshape(B, L, H).to(dw0f.dtype)
    w0, b0, ws, bs = (t.to(dw0f.dtype) for t in (w0, b0, ws, bs))
    dw0 = (dw0f * f[:, 0][:, None, :]).sum(0)
    dws = (dwsf * f[:, 1:][:, :, None, :]).sum(0)
    df0 = (dw0f * w0[None]).sum(1) + dc0 * b0[None]
    dfs = (dwsf * ws[None]).sum(2) + dcs * bs[None]
    dfreq = torch.cat([df0[:, None], dfs], dim=1).reshape(B, L * H)
    dphase = torch.cat([dc0[:, None], dcs], dim=1).reshape(B, L * H)
    db0 = (dc0 * f[:, 0]).sum(0)
    dbs = (dcs * f[:, 1:]).sum(0)
    return dfreq, dphase, dw0, db0, dws, dbs


def film_siren_folded_grads(points, freq, phase, w0, b0, ws, bs, wf, bf, g,
                            matmul_dtype=torch.bfloat16,
                            accum_dtype=torch.float32):
    """The JAX `_backward_kernel`'s math in plain torch, in folded space.

    Recompute: h_l and cos7(pre_l) rounded to `matmul_dtype`; backward: g
    and every dpre_l = dh_l * cos_l rounded to `matmul_dtype`; products of
    rounded operands summed in `accum_dtype`. The bias grads are the
    ones-row sums of dpre (film_siren.py:246-248). Returns, in accum_dtype,
    dpoints (B, N, Din), dw0f (B, Din, H), dc0 (B, H), dwsf (B, L-1, H, H),
    dcs (B, L-1, H), dwf_b (B, H, C), dbf_b (B, C) — the last two per batch
    element, as the kernel writes them. Every sum is over points, so
    callers may split N into chunks and add the results.
    """
    L = 1 + ws.shape[0]
    w0f, c0, wsf, cs = fold_film(freq, phase, w0, b0, ws, bs, matmul_dtype)

    def rnd(t):
        return t.to(matmul_dtype).to(accum_dtype)

    w0f, wsf = w0f.to(accum_dtype), wsf.to(accum_dtype)
    c0, cs = c0.to(accum_dtype), cs.to(accum_dtype)
    x = rnd(points)
    pre = torch.bmm(x, w0f) + c0[:, None]
    hs, coss = [rnd(sin7(pre))], [rnd(cos7(pre))]
    for l in range(L - 1):
        pre = torch.bmm(hs[-1], wsf[:, l]) + cs[:, l][:, None]
        hs.append(rnd(sin7(pre)))
        coss.append(rnd(cos7(pre)))

    gb = rnd(g)
    dwf_b = torch.bmm(hs[-1].transpose(1, 2), gb)
    dbf_b = gb.sum(1)
    dh = gb @ rnd(wf).t()
    dwsf, dcs = [None] * (L - 1), [None] * (L - 1)
    for l in range(L - 2, -1, -1):
        dpre = rnd(dh * coss[l + 1])
        dwsf[l] = torch.bmm(hs[l].transpose(1, 2), dpre)
        dcs[l] = dpre.sum(1)
        dh = torch.bmm(dpre, wsf[:, l].transpose(1, 2))
    dpre0 = rnd(dh * coss[0])
    dw0f = torch.bmm(x.transpose(1, 2), dpre0)
    dc0 = dpre0.sum(1)
    dpoints = torch.bmm(dpre0, w0f.transpose(1, 2))
    return (dpoints, dw0f, dc0, torch.stack(dwsf, 1), torch.stack(dcs, 1),
            dwf_b, dbf_b)


def film_siren_mlp_folded_vjp(points, freq, phase, w0, b0, ws, bs, wf, bf, g,
                              matmul_dtype=torch.bfloat16,
                              accum_dtype=torch.float32):
    """VJP of the kernel's forward math: the plain version of the JAX
    `_backward_kernel` plus its fold unwind. g (B, N, C) is the cotangent
    of the (B, N, C) output. Returns the nine fp32 grads (dpoints, dfreq,
    dphase, dw0, db0, dws, dbs, dwf, dbf). accum_dtype=float64 keeps every
    rounding and sums (and unwinds) near-exactly: the yardstick for
    summation-order noise."""
    dpoints, dw0f, dc0, dwsf, dcs, dwf_b, dbf_b = film_siren_folded_grads(
        points, freq, phase, w0, b0, ws, bs, wf, bf, g, matmul_dtype, accum_dtype)
    dfreq, dphase, dw0, db0, dws, dbs = unfold_film_grads(
        dw0f, dc0, dwsf, dcs, freq, w0, b0, ws, bs)
    grads = (dpoints, dfreq, dphase, dw0, db0, dws, dbs, dwf_b.sum(0), dbf_b.sum(0))
    return tuple(t.float() for t in grads)


def _check_kernel_inputs(points, freq, phase, w0, b0, ws, bs, wf, bf,
                        name="film_siren_mlp", widths=KERNEL_INS):
    args = dict(points=points, freq=freq, phase=phase, w0=w0, b0=b0, ws=ws,
                bs=bs, wf=wf, bf=bf)
    for arg, t in args.items():
        if t.device != points.device:
            raise ValueError(f"{name}: {arg} is on {t.device}, "
                             f"points on {points.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {arg} must be float32, got {t.dtype}")
    B, N, din = points.shape
    if din not in widths:
        raise ValueError(f"{name}: points have {din} features, the kernel takes "
                         f"{' or '.join(map(str, widths))}")
    L = 1 + ws.shape[0]
    H = w0.shape[1]
    expected = dict(points=(B, N, din), freq=(B, L * H), phase=(B, L * H),
                    w0=(din, KERNEL_HIDDEN), b0=(KERNEL_HIDDEN,),
                    ws=(L - 1, KERNEL_HIDDEN, KERNEL_HIDDEN),
                    bs=(L - 1, KERNEL_HIDDEN), wf=(KERNEL_HIDDEN, KERNEL_OUT),
                    bf=(KERNEL_OUT,))
    for arg, shape in expected.items():
        if tuple(args[arg].shape) != shape:
            raise ValueError(f"{name}: {arg} has shape "
                             f"{tuple(args[arg].shape)}, the kernel takes {shape}")
    lo, hi = KERNEL_LAYERS
    if not lo <= L <= hi:
        raise ValueError(f"{name}: L={L} layers, the kernel takes {lo} to {hi}")
    if not points.is_contiguous():
        raise ValueError(f"{name}: points must be contiguous")
    if B > 65535 or N >= 2 ** 31 - 128:
        raise ValueError(f"{name}: B={B}, N={N} exceed the launch grid")


def _fold_for_kernel(freq, phase, w0, b0, ws, bs):
    """The folded operands as the kernels read them: w0f (B, Din, H) and wsf
    (B, L-1, H, H) bf16, c (B, L, H) fp32 (c_0 then c_1..)."""
    w0f, c0, wsf, cs = fold_film(freq, phase, w0, b0, ws, bs, torch.bfloat16)
    c = torch.cat([c0[:, None], cs], dim=1).contiguous()
    return w0f.contiguous(), c, wsf.contiguous()


def _w0f_t(w0f: torch.Tensor) -> torch.Tensor:
    """W0f^T (B, H, Din) as the kernels' tensor map reads it: K-major, its
    rows zero-padded to a multiple of 8 columns (16 bytes, the TMA's row
    pitch; Din 35 -> 40, a copy of 20 KB a batch element)."""
    t = w0f.transpose(-1, -2)
    pad = -t.shape[-1] % 8
    return (torch.nn.functional.pad(t, (0, pad)) if pad else t).contiguous()


def _c_function(library, symbol, n_pointers, n_ints):
    from .build import load_library

    fn = getattr(load_library(library).lib, symbol)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * n_pointers + [ctypes.c_int] * n_ints
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _forward_kernel(points, freq, phase, w0, b0, ws, bs, wf, bf):
    """Launch K1 on checked inputs -> (B, N, 4) fp32."""
    fn = _c_function("film_siren_fwd", "film_siren_fwd", 7, 4)
    w0f, c, wsf = _fold_for_kernel(freq, phase, w0, b0, ws, bs)
    B, N, din = points.shape
    # wgmma's B operand is K-major: the trunk weights, and past Din 3 the
    # first layer's, go in transposed (B, .., H_out, H_in)
    wsf_t = wsf.transpose(-1, -2).contiguous()
    if din != KERNEL_IN:
        w0f = _w0f_t(w0f)
    wf16 = wf.to(torch.bfloat16).contiguous()
    bf = bf.contiguous()
    out = torch.empty(B, N, KERNEL_OUT, dtype=torch.float32, device=points.device)
    with torch.cuda.device(points.device):  # launch on the tensors' card
        stream = torch.cuda.current_stream(points.device).cuda_stream
        err = fn(points.data_ptr(), w0f.data_ptr(), c.data_ptr(), wsf_t.data_ptr(),
                 wf16.data_ptr(), bf.data_ptr(), out.data_ptr(), B, N, c.shape[1],
                 din, stream)
    if err != 0:
        raise RuntimeError(f"film_siren_fwd launch failed: cudaError {err}")
    film_siren_mlp.launches += 1
    return out


class FilmSirenMLP(torch.autograd.Function):
    """The kernels as one differentiable op: the forward launches K1 and
    saves only the nine inputs; the backward launches K2, which recomputes
    the forward inside the kernel (the JAX custom VJP's residuals)."""

    @staticmethod
    def forward(ctx, points, freq, phase, w0, b0, ws, bs, wf, bf):
        ctx.save_for_backward(points, freq, phase, w0, b0, ws, bs, wf, bf)
        return _forward_kernel(points, freq, phase, w0, b0, ws, bs, wf, bf)

    @staticmethod
    def backward(ctx, g):
        grads = film_siren_mlp_bwd(*ctx.saved_tensors, g)
        return tuple(d if need else None
                     for d, need in zip(grads, ctx.needs_input_grad))


def film_siren_mlp(points, freq, phase, w0, b0, ws, bs, wf, bf):
    """Fused FiLM-SIREN forward -> (B, N, 4) fp32.

    CUDA tensors go to the hand-written kernel (bf16 operands, fp32
    accumulation, sin7 — the math of `film_siren_mlp_folded`; points of 3,
    32, 35 or 224 features, 2 to 8 layers of 256), through
    `FilmSirenMLP` when an input needs grad; anything the kernel does not
    take raises. CPU tensors take the fp32 reference under plain autograd,
    as the JAX wrapper does off the TPU. `film_siren_mlp.launches` counts
    forward kernel launches.
    """
    if points.device.type == "cpu":
        return film_siren_mlp_reference(points, freq, phase, w0, b0, ws, bs, wf, bf)
    if points.device.type != "cuda":
        raise ValueError(f"film_siren_mlp: no kernel for device {points.device}")
    args = (points, freq, phase, w0, b0, ws, bs, wf, bf)
    with tracing.span("kern.film_fwd"):
        _check_kernel_inputs(*args)
        if torch.is_grad_enabled() and any(t.requires_grad for t in args):
            return FilmSirenMLP.apply(*args)
        return _forward_kernel(*args)


film_siren_mlp.launches = 0


def film_siren_mlp_bwd(points, freq, phase, w0, b0, ws, bs, wf, bf, g):
    """VJP of `film_siren_mlp`'s kernel math -> the nine fp32 grads
    (dpoints, dfreq, dphase, dw0, db0, dws, dbs, dwf, dbf).

    CUDA tensors go to the hand-written backward kernel
    (`csrc/film_siren_bwd.cu`): a recompute-and-sweep pass that writes dX
    and the bf16 h_l / dpre_l, then the folded weight grads summed over
    points in a fixed order (deterministic), then `unfold_film_grads`. The
    cotangent g (B, N, 4) may be any strided view; it is made contiguous
    here. Points of 3, 32, 35 or 224 features, 2 to 8 layers of 256. CPU
    tensors take
    `film_siren_mlp_folded_vjp`. `film_siren_mlp_bwd.launches` counts
    kernel launches.
    """
    args = (points, freq, phase, w0, b0, ws, bs, wf, bf)
    if points.device.type == "cpu":
        return film_siren_mlp_folded_vjp(*args, g)
    if points.device.type != "cuda":
        raise ValueError(f"film_siren_mlp_bwd: no kernel for device {points.device}")
    with tracing.span("kern.film_bwd"):
        return _backward_kernel(*args, g)


def _backward_kernel(points, freq, phase, w0, b0, ws, bs, wf, bf, g):
    """Launch K2 on CUDA tensors -> the nine fp32 grads."""
    args = (points, freq, phase, w0, b0, ws, bs, wf, bf)
    _check_kernel_inputs(*args, name="film_siren_mlp_bwd")
    B, N, din = points.shape
    if g.device != points.device or g.dtype != torch.float32:
        raise TypeError(f"film_siren_mlp_bwd: g must be float32 on {points.device}, "
                        f"got {g.dtype} on {g.device}")
    if tuple(g.shape) != (B, N, KERNEL_OUT):
        raise ValueError(f"film_siren_mlp_bwd: g has shape {tuple(g.shape)}, "
                         f"the kernel takes {(B, N, KERNEL_OUT)}")
    fn = _c_function("film_siren_bwd", "film_siren_bwd", 14, 5)
    w0f, c, wsf = _fold_for_kernel(freq, phase, w0, b0, ws, bs)
    # the recompute's K-major weights (past Din 3 layer 0's too); dX reads
    # W0f itself, at Din 35 zero-padded to 64 rows (the product's N)
    wsf_t = wsf.transpose(-1, -2).contiguous()
    w0f_t = _w0f_t(w0f) if din != KERNEL_IN else w0f
    if din == 35:
        w0f = torch.nn.functional.pad(w0f, (0, 0, 0, 64 - din)).contiguous()
    wf16 = wf.to(torch.bfloat16).contiguous()
    g = g.contiguous()
    L = c.shape[1]
    H, C = KERNEL_HIDDEN, KERNEL_OUT
    n_pad = -(-N // BWD_TILE) * BWD_TILE
    # weight-grad segments: >= BWD_SEGMENT points each, and enough of them
    # for BWD_ITEMS work items (2L per batch element and segment, one more
    # at Din 224: dW0f's second 128-row tile)
    items = 2 * (L - 1) + -(-din // 128) + 1
    n_seg = min(-(-n_pad // BWD_SEGMENT), -(-BWD_ITEMS // (items * B)))
    seg = -(-n_pad // (n_seg * BWD_TILE)) * BWD_TILE
    n_seg = -(-n_pad // seg)
    dev = points.device
    bf16 = dict(dtype=torch.bfloat16, device=dev)
    # scratch: bf16 h_l and dpre_l for every (padded) point, and the
    # bf16-rounded points and cotangent in one zero-padded row a point
    hbuf = torch.empty(B, L, n_pad, H, **bf16)
    pbuf = torch.empty(B, L, n_pad, H, **bf16)
    xg = torch.empty(B, n_pad, bwd_xg_cols(din), **bf16)
    dpoints = torch.empty(B, N, din, dtype=torch.float32, device=dev)
    # the folded grads of every batch element in one block, in the kernel's
    # order; with several segments, one partial block per segment
    shapes = ((B, L - 1, H, H), (B, L - 1, H), (B, din, H), (B, H), (B, H, C), (B, C))
    sizes = [math.prod(shape) for shape in shapes]
    grads = torch.empty(sum(sizes), dtype=torch.float32, device=dev)
    part = (grads if n_seg == 1 else
            torch.empty(n_seg, sum(sizes), dtype=torch.float32, device=dev))
    ptrs = (points, g, w0f, w0f_t, c, wsf, wsf_t, wf16, hbuf, pbuf, xg, dpoints, part,
            grads)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*(t.data_ptr() for t in ptrs), B, N, L, din, seg, stream)
    if err != 0:
        raise RuntimeError(f"film_siren_bwd launch failed: cudaError {err}")
    film_siren_mlp_bwd.launches += 1
    dwsf, dcs, dw0f, dc0, dwf_b, dbf_b = (
        t.view(shape) for t, shape in zip(grads.split(sizes), shapes))
    dfreq, dphase, dw0, db0, dws, dbs = unfold_film_grads(
        dw0f, dc0, dwsf, dcs, freq, w0, b0, ws, bs)
    return dpoints, dfreq, dphase, dw0, db0, dws, dbs, dwf_b.sum(0), dbf_b.sum(0)


film_siren_mlp_bwd.launches = 0
