"""Public wrappers around the port's kernels (mirrors ``repro.kernels.ops``).

Dispatch follows the tensor's device and nothing else:
  * CPU tensor  -> the plain PyTorch version (``ref.py``)
  * CUDA tensor -> the hand-written CUDA kernel; a kernel that cannot build or
    launch raises, it never falls back to the plain version or to another
    kernel. Flash attention has two kernels on the card, and
    ``flash_attention.route`` alone picks between them.
  * meta tensor, inside a dry run (``launch.dryrun``) only -> the flash
    kernel's work reported to the dry run's counter; outside one, an error
    as for any other device.

The kernels mask their own ragged edges, so no operand is padded here. A
``DTensor`` raises ``TypeError``: the sharded client plane hands each
kernel its rank's local shard, and gathering a stack here would hide the
plane's cost behind a dispatch.
"""
from __future__ import annotations

import torch

from repro_torch import roofline
from repro_torch.sharding import is_dtensor
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import kmeans_assign as _km
from repro_torch.kernels import recon_gate as _rg
from repro_torch.kernels import ref

# Every CUDA kernel of the port, by name (launch counters, builds).
KERNELS = {"kmeans_assign": _km.KERNEL, "recon_gate": _rg.KERNEL,
           "flash_attention": _fa.KERNEL,
           "flash_attention_sm90": _fa.KERNEL_SM90}

# The counters of open dry runs (``launch.dryrun``), innermost last. They
# count a step on meta tensors by watching the dispatcher, but the card's
# kernels launch through ctypes outside it, and the plain flash version
# computes every S x L score where a kernel visits only the keys each query
# sees. So on meta tensors the flash wrapper hands the innermost counter the
# kernel's own work, and the counter runs the plain version for its
# output's shape without counting it.
DRY_RUN_COUNTERS: list = []


def _local(*ts) -> None:
    for t in ts:
        if is_dtensor(t):
            raise TypeError("a kernel takes the local shard of a sharded "
                            "stack (DTensor.to_local()), not the DTensor")


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {t.device}")


def kmeans_assign(x, centroids):
    """x: (..., n, d), centroids: (..., k, d) -> (assign (..., n) int32,
    min_d2 (..., n) f32). A (N, n, d) stack is one launch on the card."""
    _local(x, centroids)
    if not _on_cuda(x):
        return ref.kmeans_assign_ref(x, centroids)
    return _km.kmeans_assign_cuda(x.to(torch.float32).contiguous(),
                                  centroids.to(torch.float32).contiguous())


def recon_gate_score(y, x, mask):
    """y, x: (..., R, P); mask: (..., R) -> (...,) masked mean MSE.

    Per-sample pixel-mean squared error averaged over each group's valid
    samples: the AE exchange gate's subset score."""
    _local(y, x, mask)
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
    one (``flash_attention_sm90``) for bf16 with head_dim 64, 128 or 256
    whose views TMA can address, the 3xTF32 one (``flash_attention``)
    for float32, bf16 at head_dim 32 and other views. Non-causal attention
    whose KV length is not a multiple of the JAX wrapper's KV block raises
    ``NotImplementedError``, as there: that wrapper pads KV and cannot mask
    the padding without the causal test.
    The kernels have no backward (nor has the Pallas kernel): an input that
    needs a gradient raises on the card rather than dropping it."""
    _local(q, k, v)
    if q.device.type == "meta" and DRY_RUN_COUNTERS:
        sm90 = _fa.route(q, k, v) == "sm90"
        work = roofline.flash_attention_work(
            q.shape[0], q.shape[1], k.shape[1], q.shape[2], k.shape[2],
            q.shape[3], causal=causal, window=window, q_offset=q_offset,
            itemsize=q.element_size())
        return DRY_RUN_COUNTERS[-1].kernel(
            _fa.KERNEL_SM90.name if sm90 else _fa.KERNEL.name,
            "bfloat16" if sm90 else "3xtf32", *work,
            lambda: ref.flash_attention_ref(q, k, v, causal=causal,
                                            window=window, q_offset=q_offset))
    if not _on_cuda(q):
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       q_offset=q_offset)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError("the flash kernels have no backward; "
                                  "train through the plain route")
    lk = k.shape[1]
    block_k = min(512, max(8, 1 << (lk - 1).bit_length()))
    if not causal and lk % block_k:
        raise NotImplementedError("non-causal padded flash attention")
    kernel = (_fa.flash_attention_sm90 if _fa.route(q, k, v) == "sm90"
              else _fa.flash_attention_cuda)
    return kernel(q, k, v, causal=causal, window=window, q_offset=q_offset)
