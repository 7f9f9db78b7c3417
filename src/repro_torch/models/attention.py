"""Core attention math: GQA, causal / sliding-window, prefill + decode paths
(mirrors ``repro.models.attention``).

``use_flash=True`` routes through ``kernels.ops.flash_attention``: the
hand-written kernel on the card, its plain version on the host.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import ops, ref

NEG_INF = -1e30
CHUNKED_THRESHOLD = 2048  # beyond this KV length, use the online-softmax path


def _split_gqa(q, n_kv):
    b, s, h, d = q.shape
    return q.reshape(b, s, n_kv, h // n_kv, d)


def attention(q, k, v, *, causal: bool = True, window: int | None = None,
              use_flash: bool = False, q_offset: int = 0):
    """Full-sequence attention (prefill).

    q: (B,S,H,hd); k,v: (B,L,Kv,hd). ``window`` -> sliding-window mask.
    ``q_offset``: absolute position of q[0] relative to k[0].

    Dispatch: the flash kernel (``use_flash``) > chunked online softmax
    (long sequences) > plain masked softmax, which is the kernel's plain
    version ``ref.flash_attention_ref`` (the JAX package's two are the same
    code too).
    """
    if use_flash:
        return ops.flash_attention(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset)
    if k.shape[1] > CHUNKED_THRESHOLD:
        return chunked_attention(q, k, v, causal=causal, window=window,
                                 q_offset=q_offset)
    return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset)


def chunked_attention(q, k, v, *, causal=True, window=None, q_offset=0,
                      kv_chunk=1024):
    """Online-softmax attention over KV chunks, in float32.

    Memory: O(S * kv_chunk) scores + O(S * hd) accumulators. The last chunk
    may be short, which is what the JAX version's zero padding plus its
    ``kpos < L`` mask computes."""
    b, s, h, d = q.shape
    lk, n_kv = k.shape[1], k.shape[2]
    kv_chunk = min(kv_chunk, lk)
    g = h // n_kv
    qg = _split_gqa(q, n_kv).to(torch.float32) * (d ** -0.5)
    qpos = (torch.arange(s, device=q.device) + q_offset)[:, None]
    m = torch.full((b, n_kv, g, s), NEG_INF, device=q.device)
    l = torch.zeros((b, n_kv, g, s), device=q.device)
    acc = torch.zeros((b, n_kv, g, s, d), device=q.device)
    for ci in range(math.ceil(lk / kv_chunk)):
        kx = k[:, ci * kv_chunk:(ci + 1) * kv_chunk].to(torch.float32)
        vx = v[:, ci * kv_chunk:(ci + 1) * kv_chunk].to(torch.float32)
        scores = torch.einsum("bskgd,blkd->bkgsl", qg, kx)
        kpos = ci * kv_chunk + torch.arange(kx.shape[1], device=q.device)
        mask = torch.ones((s, kx.shape[1]), dtype=torch.bool, device=q.device)
        if causal:
            mask &= qpos >= kpos
        if window is not None:
            mask &= (qpos - kpos) < window
        scores = torch.where(mask, scores, NEG_INF)
        m_new = torch.maximum(m, scores.amax(dim=-1))
        p = torch.where(mask, torch.exp(scores - m_new[..., None]), 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bkgsl,blkd->bkgsd", p, vx)
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, d).to(q.dtype)


def decode_attention(q, k_cache, v_cache, slot_pos, *, pos: int):
    """One-token attention against a cache.

    q: (B,1,H,hd); k_cache/v_cache: (B,W,Kv,hd);
    slot_pos: (W,) absolute position held by each cache slot (-1 = empty);
    pos: current absolute position.
    """
    b, _, h, d = q.shape
    n_kv = k_cache.shape[2]
    qg = _split_gqa(q, n_kv)                                   # (B,1,Kv,G,hd)
    scores = torch.einsum("bskgd,blkd->bkgsl", qg.to(torch.float32),
                          k_cache.to(torch.float32)) * (d ** -0.5)
    valid = (slot_pos >= 0) & (slot_pos <= pos)
    scores = torch.where(valid, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v_cache.dtype)
    out = torch.einsum("bkgsl,blkd->bskgd", probs, v_cache)
    return out.reshape(b, 1, h, d)


def decode_attention_kv_seq(q, k_cache, v_cache, slot_pos, *, pos: int,
                            plane):
    """:func:`decode_attention` over a cache whose slots lie split over
    the model axis of ``plane`` (``sharding.ModelPlane``): this rank holds
    slots ``slot_pos`` (their absolute positions, -1 = empty) of every KV
    head and q (B,1,H,hd) holds every query head. The softmax's max and
    sum are all-reduced over "model"; each rank rounds its probabilities
    to ``v_cache.dtype`` where ``decode_attention`` rounds them and sums
    its slots' P V in float32; the partial sums are all-reduced in float32
    and rounded once. Returns (B,1,H,hd) on every rank."""
    b, _, h, d = q.shape
    n_kv = k_cache.shape[2]
    qg = _split_gqa(q, n_kv)                                   # (B,1,Kv,G,hd)
    scores = torch.einsum("bskgd,blkd->bkgsl", qg.to(torch.float32),
                          k_cache.to(torch.float32)) * (d ** -0.5)
    valid = (slot_pos >= 0) & (slot_pos <= pos)
    scores = torch.where(valid, scores, NEG_INF)
    top = plane.all_reduce(scores.amax(dim=-1, keepdim=True), "model", "max")
    e = torch.exp(scores - top)
    total = plane.all_reduce(e.sum(dim=-1, keepdim=True), "model")
    probs = (e / total).to(v_cache.dtype)
    part = torch.einsum("bkgsl,blkd->bskgd", probs.to(torch.float32),
                        v_cache.to(torch.float32))
    out = plane.all_reduce(part, "model").to(v_cache.dtype)
    return out.reshape(b, 1, h, d)


# ---------------------------------------------------------------------------
# KV cache helpers (rotating ring buffer for sliding window; linear otherwise)
# ---------------------------------------------------------------------------

def cache_slot(pos: int, cache_len: int) -> int:
    """Ring-buffer slot for absolute position ``pos``."""
    return pos % cache_len


def cache_write(k_cache, v_cache, k_new, v_new, pos: int, cache_len: int):
    """Write one token's K/V at the ring slot for ``pos``, in place (the JAX
    version returns updated copies). k_new/v_new: (B,1,Kv,hd)."""
    slot = cache_slot(pos, cache_len)
    k_cache[:, slot:slot + 1] = k_new.to(k_cache.dtype)
    v_cache[:, slot:slot + 1] = v_new.to(v_cache.dtype)
    return k_cache, v_cache


def cache_slot_positions(pos: int, cache_len: int, device=None):
    """Absolute position stored in each ring slot after writing ``pos``.

    Slot s holds the most recent position p <= pos with p % W == s,
    or -1 if no such p exists yet (p would be negative).
    """
    slots = torch.arange(cache_len, device=device)
    p = pos - ((pos - slots) % cache_len)
    return torch.where(p >= 0, p, -1)
