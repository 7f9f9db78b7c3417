"""Public wrappers around the port's kernels (mirrors ``repro.kernels.ops``).

Dispatch follows the tensor's device and nothing else:
  * CPU tensor  -> the plain PyTorch version (``ref.py``)
  * CUDA tensor -> the hand-written CUDA kernel; a kernel that cannot build or
    launch raises, it never falls back to the plain version or to another
    kernel. Flash attention has two kernels on the card, and
    ``flash_attention.route`` alone picks between them.

The kernels mask their own ragged edges, so no operand is padded here.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import kmeans_assign as _km
from repro_torch.kernels import recon_gate as _rg
from repro_torch.kernels import ref

# Every CUDA kernel of the port, by name (launch counters, builds).
KERNELS = {"kmeans_assign": _km.KERNEL, "recon_gate": _rg.KERNEL,
           "flash_attention": _fa.KERNEL,
           "flash_attention_sm90": _fa.KERNEL_SM90}


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {t.device}")


def kmeans_assign(x, centroids):
    """x: (..., n, d), centroids: (..., k, d) -> (assign (..., n) int32,
    min_d2 (..., n) f32). A (N, n, d) stack is one launch on the card."""
    if not _on_cuda(x):
        return ref.kmeans_assign_ref(x, centroids)
    return _km.kmeans_assign_cuda(x.to(torch.float32).contiguous(),
                                  centroids.to(torch.float32).contiguous())


def recon_gate_score(y, x, mask):
    """y, x: (..., R, P); mask: (..., R) -> (...,) masked mean MSE.

    Per-sample pixel-mean squared error averaged over each group's valid
    samples: the AE exchange gate's subset score."""
    if not _on_cuda(y):
        return ref.recon_gate_ref(y, x, mask)
    lead = y.shape[:-2]
    r, p = y.shape[-2:]
    yf = y.to(torch.float32).reshape(-1, r, p).contiguous()
    xf = x.to(torch.float32).reshape(-1, r, p).contiguous()
    mf = mask.to(torch.float32).reshape(-1, r).contiguous()
    return _rg.recon_gate_cuda(yf, xf, mf).reshape(lead)


def flash_attention(q, k, v, *, causal=True, window=None, q_offset=0):
    """q: (B,S,H,hd); k,v: (B,L,Kv,hd) -> (B,S,H,hd).

    On the card, ``flash_attention.route`` picks the kernel: the tensor-core
    one for TMA-addressable bf16 with head_dim 64 or 128, the CUDA-core one
    otherwise. Non-causal attention whose KV length is not a multiple of
    the JAX wrapper's KV block raises ``NotImplementedError``, as there: that
    wrapper pads KV and cannot mask the padding without the causal test."""
    if not _on_cuda(q):
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       q_offset=q_offset)
    lk = k.shape[1]
    block_k = min(512, max(8, 1 << (lk - 1).bit_length()))
    if not causal and lk % block_k:
        raise NotImplementedError("non-causal padded flash attention")
    kernel = (_fa.flash_attention_sm90 if _fa.route(q, k, v) == "sm90"
              else _fa.flash_attention_cuda)
    return kernel(q, k, v, causal=causal, window=window, q_offset=q_offset)
