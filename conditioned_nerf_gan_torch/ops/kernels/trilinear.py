"""Border-mode trilinear sampling: the CUDA kernel's launcher.

`csrc/trilinear_fwd.cu` (sm_90a) is the counterpart of the JAX package's
trilinear-gather kernel (scripts/bench_pallas_gather.py), the forward of
`ops/grid_sample.py::_border_trilerp` there. `trilinear_fwd` checks what it
is handed, launches the kernel and raises on anything the kernel does not
take; it never falls back. The caller, `ops.grid_sample.
trilinear_point_features`, holds the plain version (`border_trilerp_reference`)
and counts launches.
"""

from __future__ import annotations

import torch

from .film_siren import _c_function


def _check_kernel_inputs(volume: torch.Tensor, coords: torch.Tensor) -> None:
    name = "trilinear_point_features"
    for arg, t in (("volume", volume), ("coords", coords)):
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
    if C % 4 or min(D, H, W) < 2:
        raise ValueError(f"{name}: volume (B, D, H, W, C) = {tuple(volume.shape)}; "
                         "the kernel takes C % 4 == 0 and sides >= 2")
    if volume.data_ptr() % 16:
        raise ValueError(f"{name}: volume must be 16-byte aligned (float4 rows)")
    if B * coords.shape[1] * (C // 4) >= 256 * (2 ** 31 - 1):
        raise ValueError(f"{name}: B={B}, N={coords.shape[1]} exceed the launch grid")


def trilinear_fwd(volume: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Launch the kernel: volume (B, D, H, W, C) and normalized coords
    (B, N, 3), fp32 on one card -> (B, N, C) fp32."""
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
