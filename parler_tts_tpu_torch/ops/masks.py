"""Additive attention biases over a static KV cache, and the training path's
dense causal bias (port of `parler_tts_tpu/ops/masks.py`)."""

from __future__ import annotations

from typing import Optional

import torch

# Half of fp32 min, not finfo.min: the bias is added to scores, and a fully
# masked row must stay finite (softmax then degrades to uniform, not NaN).
NEG_INF = torch.finfo(torch.float32).min / 2


def causal_self_attention_bias(
    q_positions: torch.Tensor,
    kv_valid: torch.Tensor,
    sliding_window: Optional[int] = None,
) -> torch.Tensor:
    """q_positions (B, T) absolute cache positions; kv_valid (B, S) bool.
    Returns the (B, 1, T, S) fp32 bias (0 = attend, NEG_INF = masked)."""
    s = kv_valid.shape[-1]
    kv_pos = torch.arange(s, device=kv_valid.device)[None, None, :]
    causal = kv_pos <= q_positions[:, :, None]
    ok = causal & kv_valid[:, None, :]
    if sliding_window is not None:
        ok = ok & (kv_pos > q_positions[:, :, None] - sliding_window)
    zero = torch.zeros((), dtype=torch.float32, device=kv_valid.device)
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=kv_valid.device)
    return torch.where(ok, zero, neg)[:, None, :, :]


def padding_cross_attention_bias(
    encoder_mask: Optional[torch.Tensor], t: int
) -> Optional[torch.Tensor]:
    """(B, S_enc) 0/1 padding mask -> (B, 1, T, S_enc) bias, or None."""
    if encoder_mask is None:
        return None
    zero = torch.zeros((), dtype=torch.float32, device=encoder_mask.device)
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=encoder_mask.device)
    bias = torch.where(encoder_mask.to(torch.bool), zero, neg)
    return bias[:, None, None, :].expand(bias.shape[0], 1, t, bias.shape[-1])


def dense_self_attention_bias(attention_mask: torch.Tensor) -> torch.Tensor:
    """Training-path bias: causal + padding over the whole decoder sequence
    (prompt prefix included). attention_mask (B, T) 0/1 -> (B, 1, T, T)."""
    t = attention_mask.shape[-1]
    positions = torch.arange(t, device=attention_mask.device)
    causal = positions[None, :, None] >= positions[None, None, :]
    ok = causal & attention_mask.to(torch.bool)[:, None, :]
    zero = torch.zeros((), dtype=torch.float32, device=attention_mask.device)
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=attention_mask.device)
    return torch.where(ok, zero, neg)[:, None, :, :]
