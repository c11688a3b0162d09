"""Rotary position embeddings (RoPE), Llama-3 style with NTK frequency
scaling. Port of ray_tpu/ops/rope.py: plain tensor code in f32, cast back.
"""

from __future__ import annotations

import math

import torch


def rope_frequencies(head_dim: int, theta: float = 500000.0,
                     scaling: dict | None = None,
                     device: torch.device | str = "cpu") -> torch.Tensor:
    """Inverse frequencies [head_dim/2] (f32). ``scaling`` follows Llama-3:
    {"factor", "low_freq_factor", "high_freq_factor", "original_max_position"}.
    """
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    inv = 1.0 / (theta ** exps)
    if scaling:
        factor = scaling["factor"]
        low = scaling.get("low_freq_factor", 1.0)
        high = scaling.get("high_freq_factor", 4.0)
        orig = scaling.get("original_max_position", 8192)
        wavelen = 2 * math.pi / inv
        ratio = orig / wavelen
        smooth = torch.clamp((ratio - low) / (high - low), 0.0, 1.0)
        inv = torch.where(
            wavelen > orig / low,  # low-frequency: fully scale
            inv / factor,
            torch.where(
                wavelen < orig / high,  # high-frequency: keep
                inv,
                (1 - smooth) * inv / factor + smooth * inv,
            ),
        )
    return inv


def rope_cos_sin(positions: torch.Tensor, inv_freq: torch.Tensor):
    """cos/sin tables [B, 1, S, D/2] for positions [S] or [B, S]. Every
    layer of one forward shares them, so callers compute them once."""
    if positions.dim() == 1:
        positions = positions[None, :]
    angles = positions[:, :, None].float() * inv_freq[None, None, :]
    return torch.cos(angles)[:, None], torch.sin(angles)[:, None]


def apply_rope_cs(x: torch.Tensor, cos: torch.Tensor,
                  sin: torch.Tensor) -> torch.Tensor:
    """Rotate pairs of x [B, H, S, D] by precomputed tables."""
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               inv_freq: torch.Tensor) -> torch.Tensor:
    """Rotate pairs. x: [B, H, S, D]; positions: [S] or [B, S] absolute."""
    cos, sin = rope_cos_sin(positions, inv_freq)
    return apply_rope_cs(x, cos, sin)
