"""Rotary position embeddings (mirrors ``repro.models.rope``; Qwen2-VL's
M-RoPE comes with the vision family, ROADMAP Queue 1)."""
from __future__ import annotations

import torch


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x, positions, theta: float):
    """x: (B, S, H, hd); positions: (B, S) int. The rotation is computed in
    float32 and cast back to x's dtype."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)          # (half,)
    ang = positions[..., None].to(torch.float32) * freqs       # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)
