"""Fused K-means assignment on Hopper: the wrapper of ``csrc/kmeans_assign.cu``.

Replaces ``repro.kernels.kmeans_assign.kmeans_assign_pallas``. One launch
covers every client of a batched Lloyd step: x (N, n, d) against centroids
(N, k, d), for any n, d and k. The plain version is ``ref.kmeans_assign_ref``.
The launch geometry is :func:`launch_plan`, a pure function of the shapes and
the card's SM count and occupancy.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels._build import CudaKernel

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = CudaKernel("kmeans_assign", "kmeans_assign_launch",
                    [_P] * 4 + [_I] * 13 + [_P])
THREADS = 256              # threads per block (kThreads in the source)
ROWS_PER_GROUP = 4         # rows a row group holds in registers (kRows)
CHUNK_BYTES = 32 * 1024    # shared memory for one chunk of centroids
MAX_GRID_X = 2**31 - 1


class LaunchPlan(NamedTuple):
    grid: int          # blocks: batch * parts
    block: int         # threads per block
    tpr: int           # threads per row
    kg: int            # centroids scored at once in registers
    simple: bool       # a row fits one slice and one chunk holds every
                       # centroid: the kernel's short path
    kc: int            # centroids per shared-memory chunk (a multiple of kg)
    dc: int            # columns per chunk (a multiple of 4 * tpr)
    shared_bytes: int  # 4 * (kc * dc + kc): the chunk and its norms
    parts: int         # blocks per client, each on a contiguous span of rows
    span: int          # rows per part (a multiple of the block's tile)


def threads_per_row(d: int) -> int:
    """A power of two near d / 4 (each lane holds four columns), at most 32."""
    return min(32, 1 << (-(-d // 4) - 1).bit_length())


def launch_plan(n: int, d: int, k: int, batch: int, n_sms: int,
                blocks_per_sm: int = 4) -> LaunchPlan:
    """Geometry of one launch over x (batch, n, d) and c (batch, k, d).

    A block's tile is THREADS / tpr row groups x ROWS_PER_GROUP rows. Each
    client's tiles are split into ``parts`` contiguous spans so that the
    grid fills the card's ``n_sms * blocks_per_sm`` resident slots about once
    (never more parts than tiles). Centroids are staged as whole rows, as
    many register groups of ``kg`` as CHUNK_BYTES holds; when even one group
    of whole rows does not fit, a chunk is one group by ``dc`` columns."""
    tpr = threads_per_row(d)
    kg = 4 if k <= 4 else 8
    width = 4 * tpr
    d_pad = -(-d // width) * width
    if 4 * kg * d_pad <= CHUNK_BYTES:
        dc = d_pad
        kc = min(-(-k // kg), CHUNK_BYTES // (4 * kg * d_pad)) * kg
    else:
        kc = kg
        dc = CHUNK_BYTES // (4 * kg) // width * width
    tile = THREADS // tpr * ROWS_PER_GROUP
    tiles = max(1, -(-n // tile))
    parts = max(1, min(tiles, -(-n_sms * blocks_per_sm // batch)))
    span = -(-tiles // parts) * tile
    parts = max(1, -(-n // span))
    simple = d <= width and kc >= k
    return LaunchPlan(batch * parts, THREADS, tpr, kg, simple, kc, dc,
                      4 * (kc * dc + kc), parts, span)


@functools.lru_cache(maxsize=None)
def _blocks_per_sm(device: int, tpr: int, vec4: int, kg: int, simple: int,
                   shared_bytes: int) -> int:
    out = ctypes.c_int(0)
    with torch.cuda.device(device):
        KERNEL.query("kmeans_assign_occupancy",
                     [_I] * 5 + [ctypes.POINTER(ctypes.c_int)],
                     tpr, vec4, kg, simple, shared_bytes, ctypes.byref(out))
    return out.value


@functools.lru_cache(maxsize=None)
def _plan(device: int, n: int, d: int, k: int, batch: int,
          vec4: int) -> LaunchPlan:
    n_sms = torch.cuda.get_device_properties(device).multi_processor_count
    shape = launch_plan(n, d, k, batch, n_sms)
    occupancy = _blocks_per_sm(device, shape.tpr, vec4, shape.kg,
                               int(shape.simple), shape.shared_bytes)
    return launch_plan(n, d, k, batch, n_sms, occupancy)


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
    assign = torch.empty((nb, n), dtype=torch.int32, device=x.device)
    min_d2 = torch.empty((nb, n), dtype=torch.float32, device=x.device)
    if nb and n:
        vec4 = int(d % 4 == 0 and x.data_ptr() % 16 == 0
                   and centroids.data_ptr() % 16 == 0)
        plan = _plan(x.device.index, n, d, k, nb, vec4)
        if plan.grid > MAX_GRID_X:
            raise ValueError(f"{nb} clients x {plan.parts} parts exceed the "
                             "grid's x limit")
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream().cuda_stream
        KERNEL.launch(x.data_ptr(), centroids.data_ptr(), assign.data_ptr(),
                      min_d2.data_ptr(), nb, n, d, k, plan.tpr, vec4, plan.kg,
                      int(plan.simple), plan.parts, plan.span, plan.kc,
                      plan.dc, plan.shared_bytes, stream)
    if squeeze:
        return assign[0], min_d2[0]
    return assign, min_d2
