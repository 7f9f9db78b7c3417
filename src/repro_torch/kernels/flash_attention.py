"""Flash attention on Hopper: the wrappers of its two CUDA kernels.

Both replace ``repro.kernels.flash_attention.flash_attention_pallas``:
online-softmax attention for q (B, S, H, hd) and k, v (B, L, Kv, hd) with a
causal mask, an optional sliding window, ``q_offset`` and GQA (query head h
reads KV head h // (H / Kv)). Each kernel reads the operands in this layout
through their strides and masks ragged S and L itself. :func:`route` picks
one from the operands' dtype, head_dim, alignment and strides:

  * ``"sm90"`` -> ``csrc/flash_attention_sm90.cu``: bf16, head_dim 64 or 128,
    TMA-addressable views; wgmma on the tensor cores.
  * ``"simt"`` -> ``csrc/flash_attention.cu``: everything else (float32,
    head_dim 32 or 256, misaligned views); f32 FMAs on the CUDA cores.

The plain version of both is ``ref.flash_attention_ref``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels._build import CudaKernel

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
KERNEL = CudaKernel("flash_attention", "flash_attention_launch",
                    [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I]
                    + [_L] * 9 + [_I, _I, _I, ctypes.c_float, _I, _P])
KERNEL_SM90 = CudaKernel("flash_attention_sm90", "flash_attention_sm90_launch",
                         [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I]
                         + [_L] * 9 + [_I, _I, _I, ctypes.c_float, _P])
HEAD_DIMS = (32, 64, 128, 256)
SM90_HEAD_DIMS = (64, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_GRID_YZ = 65_535


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: Optional[int] = None,
                         q_offset: int = 0) -> torch.Tensor:
    """q: (B, S, H, hd); k, v: (B, L, Kv, hd); one dtype (float32 or
    bfloat16), unit stride along hd, all on one CUDA device ->
    (B, S, H, hd) contiguous in q's dtype."""
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in DTYPES:
        raise TypeError("flash_attention_cuda takes float32 or bfloat16, one "
                        f"for all; got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"bad shapes: q {tuple(q.shape)}, k {tuple(k.shape)}"
                         f", v {tuple(v.shape)}")
    b, s, h, hd = q.shape
    _, lk, n_kv, _ = k.shape
    if k.shape[0] != b or k.shape[3] != hd or n_kv < 1 or h % n_kv:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k/v "
                         f"{tuple(k.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    if window is not None and window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if h > MAX_GRID_YZ or b > MAX_GRID_YZ:
        raise ValueError(f"{b} batch rows x {h} heads exceed the grid")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention_cuda needs unit stride along hd")
    dev = q.device
    if dev.type != "cuda" or k.device != dev or v.device != dev:
        raise ValueError("flash_attention_cuda needs q, k and v on one CUDA "
                         f"device; got {q.device}, {k.device}, {v.device}")
    out = torch.empty((b, s, h, hd), dtype=q.dtype, device=dev)
    if out.numel() == 0:
        return out
    per16 = 16 // q.element_size()
    vec = int(all(t.data_ptr() % 16 == 0
                  and all(st % per16 == 0 for st in t.stride()[:3])
                  for t in (q, k, v)))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
    KERNEL.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  DTYPES[q.dtype], hd, b, s, lk, h, n_kv,
                  *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                  int(causal), -1 if window is None else int(window),
                  int(q_offset), hd ** -0.5, vec, stream)
    return out


def _tma_addressable(t: torch.Tensor) -> bool:
    """16-byte aligned storage, unit stride along hd, and strides that are
    positive multiples of 16 bytes on every other dimension: what a TMA
    tensor map can describe."""
    return (t.data_ptr() % 16 == 0 and t.stride(-1) == 1
            and all(st > 0 and st * t.element_size() % 16 == 0
                    for st in t.stride()[:-1]))


def route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The flash kernel that takes these operands on the card: ``"sm90"``
    for bf16 with head_dim 64 or 128 whose three views TMA can address,
    ``"simt"`` otherwise. Depends on nothing but the operands' metadata, so
    it answers for CPU tensors too."""
    if (q.dtype == k.dtype == v.dtype == torch.bfloat16
            and q.dim() == k.dim() == v.dim() == 4
            and q.shape[-1] in SM90_HEAD_DIMS
            and all(_tma_addressable(t) for t in (q, k, v))):
        return "sm90"
    return "simt"


def flash_attention_sm90(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         window: Optional[int] = None,
                         q_offset: int = 0) -> torch.Tensor:
    """q: (B, S, H, hd); k, v: (B, L, Kv, hd); bfloat16 with head_dim 64 or
    128 on one CUDA device, views for which ``route`` says ``"sm90"`` ->
    (B, S, H, hd) contiguous bfloat16."""
    if route(q, k, v) != "sm90":
        raise ValueError("flash_attention_sm90 takes bf16 views with head_dim"
                         f" {SM90_HEAD_DIMS}, 16-byte aligned storage and "
                         "strides that are multiples of 16 bytes; got "
                         f"{q.dtype} {tuple(q.shape)} {q.stride()}, "
                         f"{k.dtype} {tuple(k.shape)} {k.stride()}, "
                         f"{v.dtype} {tuple(v.shape)} {v.stride()}")
    b, s, h, hd = q.shape
    _, lk, n_kv, _ = k.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != hd \
            or h % n_kv:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if window is not None and window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if h > MAX_GRID_YZ or b > MAX_GRID_YZ:
        raise ValueError(f"{b} batch rows x {h} heads exceed the grid")
    dev = q.device
    if dev.type != "cuda" or k.device != dev or v.device != dev:
        raise ValueError("flash_attention_sm90 needs q, k and v on one CUDA "
                         f"device; got {q.device}, {k.device}, {v.device}")
    out = torch.empty((b, s, h, hd), dtype=q.dtype, device=dev)
    if out.numel() == 0 or lk == 0:
        return out.zero_()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
    KERNEL_SM90.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       out.data_ptr(), hd, b, s, lk, h, n_kv,
                       *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                       int(causal), -1 if window is None else int(window),
                       int(q_offset), hd ** -0.5, stream)
    return out
