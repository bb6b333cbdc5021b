"""Border-mode trilinear sampling: the CUDA kernels' launchers.

`csrc/trilinear_fwd.cu` (sm_90a) is the counterpart of the JAX package's
trilinear-gather kernel (scripts/bench_pallas_gather.py), the forward of
`ops/grid_sample.py::_border_trilerp` there; `csrc/trilinear_bwd.cu` is the
counterpart of that op's custom VJP (`_expanded_bwd`), a scatter that
pre-sums shared corner rows on chip and adds into a dV the caller owns,
where the TPU formed one-hot matmuls. Both share
`csrc/trilinear_common.cuh`. `trilinear_fwd` and `trilinear_bwd` check what
they are handed, launch and raise on anything the kernels do not take; they
never fall back. The caller, `ops.grid_sample`, holds the plain versions
(`border_trilerp_reference`, `border_trilerp_vjp_reference`), the autograd
Functions (one dV a render) and the forward's launch count;
`trilinear_bwd.launches` counts the backward's launches.
"""

from __future__ import annotations

import torch

from .film_siren import _c_function

def _check_kernel_inputs(volume: torch.Tensor, coords: torch.Tensor,
                         name: str = "trilinear_point_features", **others) -> None:
    for arg, t in (("volume", volume), ("coords", coords), *others.items()):
        if t.device.type != "cuda" or t.device != volume.device:
            raise ValueError(f"{name}: {arg} is on {t.device}, the kernel takes "
                             f"CUDA tensors on one card")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {arg} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
    if volume.ndim != 5:
        raise ValueError(f"{name}: volume has shape {tuple(volume.shape)}, the "
                         "kernel takes (B, D, H, W, C)")
    B, D, H, W, C = volume.shape
    if coords.ndim != 3 or coords.shape[0] != B or coords.shape[2] != 3:
        raise ValueError(f"{name}: coords have shape {tuple(coords.shape)}, the "
                         f"kernel takes ({B}, N, 3)")
    if C % 4 or min(D, H, W) < 1:
        raise ValueError(f"{name}: volume (B, D, H, W, C) = {tuple(volume.shape)}; "
                         "the kernel takes C % 4 == 0 and sides >= 1")
    if volume.data_ptr() % 16:
        raise ValueError(f"{name}: volume must be 16-byte aligned (float4 rows)")
    if B * coords.shape[1] * (C // 4) >= 256 * (2 ** 31 - 1):
        raise ValueError(f"{name}: B={B}, N={coords.shape[1]} exceed the launch grid")


def trilinear_fwd(volume: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Launch the forward kernel: volume (B, D, H, W, C) and normalized
    coords (B, N, 3), fp32 on one card -> (B, N, C) fp32. At C 32, with one
    volume under 2^31 floats, the kernel takes its short index path."""
    _check_kernel_inputs(volume, coords)
    fn = _c_function("trilinear_fwd", "trilinear_fwd", 3, 6)
    B, D, H, W, C = volume.shape
    N = coords.shape[1]
    out = torch.empty(B, N, C, dtype=torch.float32, device=volume.device)
    with torch.cuda.device(volume.device):  # launch on the tensors' card
        stream = torch.cuda.current_stream(volume.device).cuda_stream
        err = fn(volume.data_ptr(), coords.data_ptr(), out.data_ptr(), B, N, D, H, W,
                 C, stream)
    if err != 0:
        raise RuntimeError(f"trilinear_fwd launch failed: cudaError {err}")
    return out


def _check_dvol(volume: torch.Tensor, dvol: torch.Tensor) -> None:
    """The dV buffer a caller hands the backward: the volume's shape, fp32,
    on the volume's device, contiguous and 16-byte aligned (float4 rows)."""
    if tuple(dvol.shape) != tuple(volume.shape):
        raise ValueError(f"trilinear_bwd: dvol has shape {tuple(dvol.shape)}, the volume "
                         f"{tuple(volume.shape)}")
    if dvol.dtype != torch.float32:
        raise TypeError(f"trilinear_bwd: dvol must be float32, got {dvol.dtype}")
    if dvol.device != volume.device:
        raise ValueError(f"trilinear_bwd: dvol is on {dvol.device}, the volume on "
                         f"{volume.device}")
    if not dvol.is_contiguous():
        raise ValueError("trilinear_bwd: dvol must be contiguous")
    if dvol.data_ptr() % 16:
        raise ValueError("trilinear_bwd: dvol must be 16-byte aligned (float4 rows)")


def trilinear_bwd(volume: torch.Tensor, coords: torch.Tensor, g: torch.Tensor,
                  dvol: torch.Tensor | None = None, need_coords: bool = False):
    """VJP of the sampling: adds dvolume into `dvol` (a buffer the caller
    owns, shaped like the volume; None: dvolume not asked) and returns
    dcoords (B, N, 3) when `need_coords`, else None.

    CUDA tensors go to the backward kernel, which sums the contributions of
    neighbouring points that share a corner row on chip before its atomics
    reach dV; dcoords are the JAX fraction cotangents. The cotangent g (B,
    N, C) may be any strided view; it is made contiguous here. CPU tensors
    take `border_trilerp_vjp_reference` and add its dV into `dvol`.
    `trilinear_bwd.launches` counts kernel launches.
    """
    if dvol is not None:
        _check_dvol(volume, dvol)
    if volume.device.type == "cpu":
        from ..grid_sample import border_trilerp_vjp_reference

        dv, dcoords = border_trilerp_vjp_reference(volume, coords, g, need_coords)
        if dvol is not None:
            dvol.add_(dv)
        return dcoords
    g = g.contiguous()
    _check_kernel_inputs(volume, coords, name="trilinear_bwd", g=g)
    B, D, H, W, C = volume.shape
    N = coords.shape[1]
    if tuple(g.shape) != (B, N, C):
        raise ValueError(f"trilinear_bwd: g has shape {tuple(g.shape)}, the kernel "
                         f"takes {(B, N, C)}")
    quads = C // 4
    if need_coords and (quads > 32 or quads & (quads - 1)):
        raise ValueError(f"trilinear_bwd: dcoords need C / 4 a power of two <= 32, "
                         f"got C={C}")
    if dvol is not None and D * H * W >= 2 ** 31 - 1:
        raise ValueError(f"trilinear_bwd: dV of a volume of {D * H * W} voxels; the "
                         "kernel keys voxels in 31 bits")
    if dvol is None and not need_coords:
        return None
    dev = volume.device
    dcoords = torch.empty(B, N, 3, dtype=torch.float32, device=dev) if need_coords else None
    fn = _c_function("trilinear_bwd", "trilinear_bwd", 5, 6)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(volume.data_ptr(), coords.data_ptr(), g.data_ptr(),
                 None if dvol is None else dvol.data_ptr(),
                 None if dcoords is None else dcoords.data_ptr(),
                 B, N, D, H, W, C, stream)
    if err != 0:
        raise RuntimeError(f"trilinear_bwd launch failed: cudaError {err}")
    trilinear_bwd.launches += 1
    return dcoords


trilinear_bwd.launches = 0
