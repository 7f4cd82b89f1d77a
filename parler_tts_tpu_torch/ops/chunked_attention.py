"""Memory-efficient chunked attention: an online softmax over key chunks
(port of `parler_tts_tpu/ops/chunked_attention.py`, plain PyTorch as the
JAX package's is plain XLA).

The query axis is cut into chunks; each query chunk scans the key chunks
with running max, denominator and accumulator in fp32, and every scan step
runs under `torch.utils.checkpoint`, so the backward recomputes a step's
scores from its inputs instead of keeping (B, H, T, T) probabilities.
Query rows with no valid key return 0.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

NEG_INF = torch.finfo(torch.float32).min


def _pad_to(x: torch.Tensor, dim: int, multiple: int) -> torch.Tensor:
    pad = (-x.shape[dim]) % multiple
    if pad == 0:
        return x
    widths = [0, 0] * (x.dim() - dim - 1) + [0, pad]
    return F.pad(x, widths)


def _kv_step(m_prev, l_prev, acc, q_blk, k_blk, v_blk, ok):
    """One key chunk of the online softmax. q_blk (B, Cq, H_kv, G, Dh) fp32,
    k/v_blk (B, Ck, H_kv, Dh), ok (B, 1, 1, Cq, Ck) or broadcastable."""
    s = torch.einsum("bqkgd,bskd->bkgqs", q_blk, k_blk.float())
    s = s.masked_fill(~ok, NEG_INF)
    m_new = torch.maximum(m_prev, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None]).masked_fill(~ok, 0.0)
    alpha = torch.exp(m_prev - m_new)
    l_new = l_prev * alpha + p.sum(dim=-1)
    pv = torch.einsum("bkgqs,bskd->bqkgd", p, v_blk.float())
    return m_new, l_new, acc * alpha.permute(0, 3, 1, 2)[..., None] + pv


def chunked_attention(
    q: torch.Tensor,                      # (B, Tq, H, Dh), pre-scaled
    k: torch.Tensor,                      # (B, Tk, H_kv, Dh)
    v: torch.Tensor,                      # (B, Tk, H_kv, Dh)
    mask: Optional[torch.Tensor] = None,  # (B, Tk) key validity
    causal: bool = True,
    q_offset: int = 0,                    # absolute position of q[0] against k[0]
    chunk_q: int = 512,
    chunk_k: int = 512,
) -> torch.Tensor:
    """Returns (B, Tq, H, Dh) in q's dtype; equal to dense masked attention
    on the rows that have a valid key."""
    b, tq0, h, dh = q.shape
    tk0, h_kv = k.shape[1], k.shape[2]
    g = h // h_kv
    device = q.device
    if mask is None:
        mask = torch.ones((b, tk0), dtype=torch.bool, device=device)
    q, k, v = _pad_to(q, 1, chunk_q), _pad_to(k, 1, chunk_k), _pad_to(v, 1, chunk_k)
    mask = _pad_to(mask.to(torch.bool), 1, chunk_k)
    nq, nk = q.shape[1] // chunk_q, k.shape[1] // chunk_k
    qc = q.reshape(b, nq, chunk_q, h_kv, g, dh)
    q_pos = torch.arange(chunk_q, device=device) + q_offset
    k_pos = torch.arange(chunk_k, device=device)
    outs = []
    for qi in range(nq):
        q_blk = qc[:, qi].float()
        m = torch.full((b, h_kv, g, chunk_q), NEG_INF, device=device)
        l = torch.zeros((b, h_kv, g, chunk_q), device=device)
        acc = torch.zeros((b, chunk_q, h_kv, g, dh), device=device)
        for ki in range(nk):
            sl = slice(ki * chunk_k, (ki + 1) * chunk_k)
            ok = mask[:, None, None, None, sl]
            if causal:
                live = (k_pos[None, :] + ki * chunk_k) <= (q_pos + qi * chunk_q)[:, None]
                ok = ok & live
            args = (m, l, acc, q_blk, k[:, sl], v[:, sl], ok)
            if torch.is_grad_enabled():
                m, l, acc = checkpoint(_kv_step, *args, use_reentrant=False)
            else:
                m, l, acc = _kv_step(*args)
        denom = l.clamp_min(1e-30).permute(0, 3, 1, 2)[..., None]
        outs.append(acc / denom)
    out = torch.cat(outs, dim=1).reshape(b, nq * chunk_q, h, dh)
    return out[:, :tq0].to(q.dtype)
