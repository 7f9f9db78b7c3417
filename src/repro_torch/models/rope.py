"""Rotary position embeddings: standard RoPE and Qwen2-VL M-RoPE (mirrors
``repro.models.rope``).

M-RoPE splits the head_dim//2 frequency bands into (t, h, w) sections, each
rotated by its own position stream. For text-only inputs the three streams
coincide (t = h = w = token index) and M-RoPE equals RoPE; the vision stub
feeds distinct h/w grids.
"""
from __future__ import annotations

import torch


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """1 / theta ** (i / half), i < half, in float32, rounded as the
    reference's jitted code rounds it: XLA multiplies i by the float32
    reciprocal of half and evaluates 1 / theta ** e as theta ** -e,
    correctly rounded (here in float64, rounded once). torch's float32 pow
    and divide are an ulp off in some bands, which a position of a few
    hundred turns into ~1e-5 of rotation."""
    half = head_dim // 2
    e = torch.arange(half, dtype=torch.float32, device=device) \
        * torch.tensor(1.0 / half, dtype=torch.float32)
    return (theta ** -e.double()).to(torch.float32)


def _rotate(x, pos, theta: float):
    """x (B, S, H, hd) rotated by the float32 angles pos (B, S, half) x
    freqs, computed in float32 and cast back to x's dtype."""
    ang = pos * rope_freqs(x.shape[-1], theta, x.device)    # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def apply_rope(x, positions, theta: float):
    """x: (B, S, H, hd); positions: (B, S) int."""
    return _rotate(x, positions[..., None].to(torch.float32), theta)


def apply_mrope(x, positions3, theta: float, sections):
    """Qwen2-VL multimodal RoPE.

    x: (B, S, H, hd); positions3: (B, S, 3) int (t, h, w); sections: split
    of the hd//2 bands, sum(sections) == hd // 2. Band j rotates by stream
    ``sec_id[j] % positions3.shape[-1]``, sec_id the section that holds it."""
    half = x.shape[-1] // 2
    assert sum(sections) == half, (sections, half)
    # which position stream drives each frequency band, (half,) in {0,1,2}
    sec_id = torch.repeat_interleave(torch.arange(len(sections)),
                                     torch.tensor(sections), output_size=half)
    sec_id = (sec_id % positions3.shape[-1]).to(positions3.device)
    return _rotate(x, positions3.to(torch.float32)[..., sec_id], theta)
