"""Fused K-means assignment on Hopper: the wrapper of ``csrc/kmeans_assign.cu``.

Replaces ``repro.kernels.kmeans_assign.kmeans_assign_pallas``. One launch
covers every client of a batched Lloyd step: x (N, n, d) against centroids
(N, k, d). The plain version is ``ref.kmeans_assign_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import CudaKernel

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = CudaKernel("kmeans_assign", "kmeans_assign_launch",
                    [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P])
MAX_SHARED_BYTES = 232_448     # a block's dynamic shared memory on sm_90
MAX_GRID_Y = 65_535


def kmeans_assign_cuda(x: torch.Tensor, centroids: torch.Tensor):
    """x: (N, n, d) or (n, d); centroids: (N, k, d) or (k, d), both float32,
    contiguous, on one CUDA device -> (assign int32, min_d2 float32) of
    shape x.shape[:-1]."""
    if x.device.type != "cuda" or centroids.device != x.device:
        raise ValueError("kmeans_assign_cuda needs x and centroids on one "
                         f"CUDA device; got {x.device} and {centroids.device}")
    if x.dtype != torch.float32 or centroids.dtype != torch.float32:
        raise TypeError(f"kmeans_assign_cuda takes float32; got {x.dtype} "
                        f"and {centroids.dtype}")
    if not (x.is_contiguous() and centroids.is_contiguous()):
        raise ValueError("kmeans_assign_cuda needs contiguous inputs")
    squeeze = x.dim() == 2
    if squeeze:
        x, centroids = x[None], centroids[None]
    if x.dim() != 3 or centroids.dim() != 3:
        raise ValueError(f"bad ranks: x {tuple(x.shape)}, centroids "
                         f"{tuple(centroids.shape)}")
    nb, n, d = x.shape
    nb_c, k, d_c = centroids.shape
    if nb_c != nb or d_c != d or k < 1 or d < 1:
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, centroids "
                         f"{tuple(centroids.shape)}")
    if 4 * (k * d + k) > MAX_SHARED_BYTES:
        raise ValueError(f"k*d = {k * d} centroid values exceed a block's "
                         "shared memory")
    if nb > MAX_GRID_Y:
        raise ValueError(f"{nb} clients exceed the grid's y limit")
    assign = torch.empty((nb, n), dtype=torch.int32, device=x.device)
    min_d2 = torch.empty((nb, n), dtype=torch.float32, device=x.device)
    if nb and n:
        vec4 = int(d % 4 == 0 and x.data_ptr() % 16 == 0)
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream().cuda_stream
        KERNEL.launch(x.data_ptr(), centroids.data_ptr(), assign.data_ptr(),
                      min_d2.data_ptr(), nb, n, d, k, vec4, stream)
    if squeeze:
        return assign[0], min_d2[0]
    return assign, min_d2
