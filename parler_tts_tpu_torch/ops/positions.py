"""Positional embeddings (port of `parler_tts_tpu/ops/positions.py`).

Sinusoidal `[cos | sin]` table, and llama-style rotary embeddings with cos/sin
computed in fp32.
"""

from __future__ import annotations

import numpy as np
import torch


def sinusoidal_table(
    num_positions: int, dim: int, dtype=torch.float32, device=None
) -> torch.Tensor:
    """(num_positions, dim) table: emb[p, :half] = cos(p w), emb[p, half:] = sin(p w),
    w_i = exp(-i ln(10000) / (half - 1)); computed in float64 on the host."""
    half = dim // 2
    freq = np.exp(np.arange(half, dtype=np.float64) * -(np.log(10000.0) / (half - 1)))
    ang = np.arange(num_positions, dtype=np.float64)[:, None] * freq[None, :]
    table = np.concatenate([np.cos(ang), np.sin(ang)], axis=1)
    if dim % 2 == 1:
        table = np.concatenate([table, np.zeros((num_positions, 1))], axis=1)
    return torch.as_tensor(table.astype(np.float32), device=device).to(dtype)


def sinusoidal_embed(table: torch.Tensor, position_ids: torch.Tensor) -> torch.Tensor:
    """position_ids (..., T) -> (..., T, D)."""
    return table[position_ids]


def rope_cos_sin(position_ids: torch.Tensor, head_dim: int, theta: float = 10000.0,
                 dtype=torch.float32):
    """position_ids (B, T) -> cos, sin each (B, T, head_dim), computed in fp32."""
    device = position_ids.device
    inv_freq = 1.0 / (
        theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim)
    )
    freqs = position_ids.to(torch.float32)[..., None] * inv_freq[None, None, :]
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos().to(dtype), emb.sin().to(dtype)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (B, T, H, Dh); cos/sin (B, T, Dh), broadcast over the head axis."""
    cos = cos[:, :, None, :]
    sin = sin[:, :, None, :]
    return x * cos + rotate_half(x) * sin
