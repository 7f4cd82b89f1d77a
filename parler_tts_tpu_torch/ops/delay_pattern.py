"""Delay-pattern codebook scheduling (port of `parler_tts_tpu/ops/delay_pattern.py`).

Codebook k is offset by k steps, BOS fills the lower-triangular head and PAD
the upper-triangular tail. Arrays use the (batch, codebook, time) layout.
"""

from __future__ import annotations

import torch


def unflatten_codebooks(ids: torch.Tensor, num_codebooks: int) -> torch.Tensor:
    """(B*K, T) -> (B, K, T)."""
    return ids.reshape(-1, num_codebooks, ids.shape[-1])


def flatten_codebooks(ids: torch.Tensor) -> torch.Tensor:
    """(B, K, T) -> (B*K, T)."""
    return ids.reshape(-1, ids.shape[-1])


def build_delay_pattern_mask(
    input_ids: torch.Tensor,
    bos_token_id: int,
    pad_token_id: int,
    max_length: int,
):
    """Build the delayed pattern mask.

    input_ids: (B, K, S) decoder-prompt ids (usually S == 1, all BOS).
    Returns (first_start_ids (B, K, S'), pattern (B, K, L)) where S' =
    min(S, L - K + 1) and the pattern holds BOS in the lower triangle
    (col <= k), PAD in the upper triangle (col >= L - K + 1 + k), the shifted
    input ids where they land, and -1 where the model must predict.
    """
    b, k, seq_len = input_ids.shape
    device = input_ids.device

    if max_length < 2 * k - 1:
        pattern = torch.full((b, k, max_length), -1, dtype=input_ids.dtype, device=device)
        return input_ids, pattern

    cols = torch.arange(max_length, device=device)[None, :]  # (1, L)
    rows = torch.arange(k, device=device)[:, None]           # (K, 1)

    src = cols - rows                                         # (K, L)
    in_range = (src >= 0) & (src < seq_len)
    index = src.clamp(0, seq_len - 1)[None].expand(b, k, max_length)
    gathered = torch.gather(input_ids, -1, index)
    minus_one = torch.full_like(gathered, -1)
    shifted = torch.where(in_range[None], gathered, minus_one)

    bos_region = cols <= rows
    pad_region = cols >= (max_length - k + 1 + rows)

    pattern = torch.where(bos_region[None], torch.full_like(shifted, bos_token_id), shifted)
    pattern = torch.where(pad_region[None], torch.full_like(shifted, pad_token_id), pattern)

    first_start = min(seq_len, max_length - k + 1)
    return pattern[..., :first_start], pattern


def apply_delay_pattern_mask(input_ids: torch.Tensor, pattern: torch.Tensor) -> torch.Tensor:
    """Override ids with the pattern wherever the pattern is not -1.

    input_ids: (B, K, T); pattern: (B, K, L) with L >= T.
    """
    p = pattern[..., : input_ids.shape[-1]]
    return torch.where(p == -1, input_ids, p)


def undelay_pattern(delayed_ids: torch.Tensor, num_codebooks: int) -> torch.Tensor:
    """Strip the delay: codes[b, k, t] = delayed[b, k, t + k + 1]. Output (B, K, L - K)."""
    b, k, length = delayed_ids.shape
    out_t = length - num_codebooks
    device = delayed_ids.device
    t_idx = torch.arange(out_t, device=device)[None, :]
    k_idx = torch.arange(num_codebooks, device=device)[:, None]
    gather = (t_idx + k_idx + 1)[None].expand(b, num_codebooks, out_t)
    return torch.gather(delayed_ids, -1, gather)


def valid_frame_lengths(codes: torch.Tensor, codebook_size: int) -> torch.Tensor:
    """Per-sample count of leading frames where every codebook id is a real
    code (< codebook_size). codes: (B, K, T) -> lengths (B,) int32."""
    frame_ok = (codes < codebook_size).all(dim=1)  # (B, T)
    leading_ok = torch.cumprod(frame_ok.to(torch.int32), dim=-1)
    return leading_ok.sum(dim=-1).to(torch.int32)
