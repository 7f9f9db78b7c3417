"""Plain PyTorch versions of every kernel (mirrors ``repro.kernels.ref``).

They are what the kernel wrappers run on CPU tensors, what the CPU tests hold
against the JAX oracles, and what the kernels are held against on the card.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def kmeans_assign_ref(x, centroids):
    """x: (..., n, d), centroids: (..., k, d) -> (assign (..., n) int32,
    min_d2 (..., n) f32); leading dims are clients."""
    x = x.to(torch.float32)
    c = centroids.to(torch.float32)
    x2 = torch.sum(x * x, dim=-1, keepdim=True)                 # (..., n, 1)
    c2 = torch.sum(c * c, dim=-1)                                # (..., k)
    d2 = x2 - 2.0 * (x @ c.transpose(-1, -2)) + c2[..., None, :]
    assign = torch.argmin(d2, dim=-1).to(torch.int32)
    min_d2 = torch.clamp_min(torch.amin(d2, dim=-1), 0.0)
    return assign, min_d2


def recon_gate_ref(y, x, mask):
    """y, x: (..., R, P); mask: (..., R) -> (...,) masked mean MSE.

    Per-sample pixel-mean squared error, averaged over the valid (masked)
    samples of each group: the exchange gate's subset score."""
    d = (y - x).to(torch.float32)
    per = torch.mean(d * d, dim=-1)
    m = mask.to(torch.float32)
    return torch.sum(per * m, dim=-1) / torch.clamp_min(
        torch.sum(m, dim=-1), 1.0)


def flash_attention_ref(q, k, v, *, causal=True, window=None, q_offset=0):
    """q: (B,S,H,hd); k,v: (B,L,Kv,hd) -> (B,S,H,hd).

    Plain masked softmax attention with GQA head grouping."""
    b, s, h, d = q.shape
    n_kv = k.shape[2]
    qg = q.reshape(b, s, n_kv, h // n_kv, d)
    scores = torch.einsum("bskgd,blkd->bkgsl", qg.float(), k.float()) \
        * (d ** -0.5)
    qpos = torch.arange(s, device=q.device) + q_offset
    kpos = torch.arange(k.shape[1], device=q.device)
    mask = torch.ones((s, k.shape[1]), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos[:, None] >= kpos[None, :]
    if window is not None:
        mask &= (qpos[:, None] - kpos[None, :]) < window
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgsl,blkd->bskgd", probs, v)
    return out.reshape(b, s, h, d)
