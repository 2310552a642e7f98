"""Rotary position embeddings: standard RoPE and Qwen2-VL M-RoPE.

Counterpart of ``repro/models/rope.py``, op for op: angles in fp32, the
interleaved-pair convention (x[2i], x[2i+1]) on query and key alike.
"""
from __future__ import annotations

from typing import Tuple

import torch


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies for the rotating half-dims: [head_dim // 2] fp32."""
    exp = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exp)


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float) -> torch.Tensor:
    """positions [..., S] -> angles [..., S, head_dim // 2] (fp32)."""
    inv = rope_frequencies(head_dim, theta, device=positions.device)
    return positions.float()[..., None] * inv


def apply_rope(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Rotate pairs (x[2i], x[2i+1]). x [..., S, D], angles [..., S, D//2];
    angles broadcast over a head axis when x is [..., H, S, D]."""
    x32 = x.float()
    x1, x2 = x32[..., 0::2], x32[..., 1::2]
    cos, sin = torch.cos(angles), torch.sin(angles)
    if x1.dim() == angles.dim() + 1:
        cos, sin = cos[..., None, :, :], sin[..., None, :, :]
    r1 = x1 * cos - x2 * sin
    r2 = x1 * sin + x2 * cos
    return torch.stack([r1, r2], dim=-1).reshape(x.shape).to(x.dtype)


def mrope_angles(positions: torch.Tensor, head_dim: int, theta: float,
                 sections: Tuple[int, int, int]) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE: positions [3, ..., S] (temporal, height,
    width) drive three sections of the head_dim // 2 frequency slots
    (``sections`` in half-dim units, summing to head_dim // 2). Returns
    angles [..., S, head_dim // 2]."""
    if sum(sections) != head_dim // 2:
        raise ValueError(f"M-RoPE sections {sections} must sum to {head_dim // 2}")
    ang = positions.float()[..., None] * rope_frequencies(head_dim, theta,
                                                          device=positions.device)
    parts, start = [], 0
    for i, sec in enumerate(sections):
        parts.append(ang[i, ..., start:start + sec])
        start += sec
    return torch.cat(parts, dim=-1)


def text_positions(batch: int, seq: int, *, offset: int = 0, device=None) -> torch.Tensor:
    return (torch.arange(seq, dtype=torch.int32, device=device) + offset).expand(batch, seq)


def text_mrope_positions(batch: int, seq: int, *, offset: int = 0, device=None) -> torch.Tensor:
    """For pure text, all three M-RoPE position streams coincide."""
    return text_positions(batch, seq, offset=offset, device=device).expand(3, batch, seq)
