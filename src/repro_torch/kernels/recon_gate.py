"""Masked reconstruction-MSE gate score on Hopper: the wrapper of
``csrc/recon_gate.cu``.

Replaces ``repro.kernels.recon_gate.recon_gate_pallas``: y, x (G, R, P) and a
sample mask (G, R) -> (G,) masked mean per-sample MSE, without storing the
residual. The plain version is ``ref.recon_gate_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import CudaKernel

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = CudaKernel("recon_gate", "recon_gate_launch",
                    [_P, _P, _P, _P, _P, _I, _I, _I, ctypes.c_float, _I, _P])
MAX_GRID_Y = 65_535


def recon_gate_cuda(y: torch.Tensor, x: torch.Tensor, mask: torch.Tensor):
    """y, x: (G, R, P) float32; mask: (G, R) float32; all contiguous on one
    CUDA device -> (G,) float32."""
    dev = y.device
    if dev.type != "cuda" or x.device != dev or mask.device != dev:
        raise ValueError("recon_gate_cuda needs y, x and mask on one CUDA "
                         f"device; got {y.device}, {x.device}, {mask.device}")
    if (y.dtype, x.dtype, mask.dtype) != (torch.float32,) * 3:
        raise TypeError(f"recon_gate_cuda takes float32; got {y.dtype}, "
                        f"{x.dtype}, {mask.dtype}")
    if not (y.is_contiguous() and x.is_contiguous() and mask.is_contiguous()):
        raise ValueError("recon_gate_cuda needs contiguous inputs")
    if y.dim() != 3 or x.shape != y.shape or mask.shape != y.shape[:2]:
        raise ValueError(f"bad shapes: y {tuple(y.shape)}, x "
                         f"{tuple(x.shape)}, mask {tuple(mask.shape)}")
    g, r, p = y.shape
    if p < 1:
        raise ValueError("recon_gate_cuda needs at least one pixel")
    if g > MAX_GRID_Y:
        raise ValueError(f"{g} groups exceed the grid's y limit")
    out = torch.empty((g,), dtype=torch.float32, device=dev)
    if g:
        per = torch.empty((g, r), dtype=torch.float32, device=dev)
        vec4 = int(p % 4 == 0 and y.data_ptr() % 16 == 0
                   and x.data_ptr() % 16 == 0)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
        KERNEL.launch(y.data_ptr(), x.data_ptr(), mask.data_ptr(),
                      per.data_ptr(), out.data_ptr(), g, r, p, 1.0 / p, vec4,
                      stream)
    return out
