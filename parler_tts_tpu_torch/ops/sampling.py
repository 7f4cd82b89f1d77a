"""Sampling and logits constraints for the delayed-codebook decode loop
(port of `parler_tts_tpu/ops/sampling.py`).

Pure functions over (B, K, V) logits with the EOS-ordering state carried
explicitly: `eos_seen` (B, K) and `first_unfinished` (B,).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..parallel.rows import draw_sliced

NEG_INF = torch.finfo(torch.float32).min


class EosState(NamedTuple):
    """Carried EOS-ordering state for the delay-pattern constraint."""

    eos_seen: torch.Tensor          # (B, K) bool
    first_unfinished: torch.Tensor  # (B,) int32


def init_eos_state(batch_size: int, num_codebooks: int, device=None) -> EosState:
    return EosState(
        eos_seen=torch.zeros((batch_size, num_codebooks), dtype=torch.bool, device=device),
        first_unfinished=torch.zeros((batch_size,), dtype=torch.int32, device=device),
    )


def advance_eos_state(state: EosState, num_codebooks: int) -> EosState:
    """Advance `first_unfinished` by one if its codebook has seen EOS (at most
    one codebook per step, never past K-1)."""
    current_seen = torch.gather(
        state.eos_seen, 1, state.first_unfinished[:, None].long()
    )[:, 0]
    bumped = torch.where(
        current_seen & (state.first_unfinished < num_codebooks - 1),
        state.first_unfinished + 1,
        state.first_unfinished,
    )
    return EosState(eos_seen=state.eos_seen, first_unfinished=bumped)


def _eos_column(v: int, eos_token_id: int, device) -> torch.Tensor:
    return torch.arange(v, device=device) == eos_token_id


def mask_eos_ordering(logits: torch.Tensor, state: EosState, eos_token_id: int) -> torch.Tensor:
    """Forbid EOS for every codebook strictly above the first unfinished one."""
    b, k, v = logits.shape
    cb = torch.arange(k, device=logits.device)[None, :]
    forbid = cb > state.first_unfinished[:, None]
    eos_col = _eos_column(v, eos_token_id, logits.device)
    return logits.masked_fill(forbid[:, :, None] & eos_col[None, None, :], NEG_INF)


def record_sampled(state: EosState, sampled: torch.Tensor, eos_token_id: int) -> EosState:
    """Update eos_seen from the ids actually written this step."""
    return EosState(
        eos_seen=state.eos_seen | (sampled == eos_token_id),
        first_unfinished=state.first_unfinished,
    )


def suppress_eos_before_min_length(
    logits: torch.Tensor, cur_length: int, min_length: int, eos_token_id: int
) -> torch.Tensor:
    """No EOS anywhere before `min_length` tokens."""
    if cur_length >= min_length:
        return logits
    eos_col = _eos_column(logits.shape[-1], eos_token_id, logits.device)
    return logits.masked_fill(eos_col[None, None, :], NEG_INF)


def apply_temperature(logits: torch.Tensor, temperature: float) -> torch.Tensor:
    return logits / temperature


def apply_top_k(logits: torch.Tensor, top_k: int) -> torch.Tensor:
    """Keep only the top-k logits."""
    if top_k <= 0:
        return logits
    kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
    return logits.masked_fill(logits < kth, NEG_INF)


def apply_top_p(logits: torch.Tensor, top_p: float) -> torch.Tensor:
    """Nucleus filtering: keep the smallest set of tokens with cumprob >= top_p."""
    if top_p >= 1.0:
        return logits
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep_sorted = (cum - probs) < top_p
    inf = torch.full_like(sorted_logits, float("inf"))
    thresh = torch.where(keep_sorted, sorted_logits, inf).amin(dim=-1, keepdim=True)
    return logits.masked_fill(logits < thresh, NEG_INF)


def process_logits(
    logits: torch.Tensor, *, temperature: float = 1.0, top_k: int = 0, top_p: float = 1.0
) -> torch.Tensor:
    """The warpers of `sample_tokens` in order: fp32, temperature, top-k, top-p."""
    x = logits.to(torch.float32)
    if temperature != 1.0:
        x = apply_temperature(x, temperature)
    x = apply_top_k(x, top_k)
    return apply_top_p(x, top_p)


def sample_tokens(
    logits: torch.Tensor,
    *,
    do_sample: bool,
    temperature: float = 1.0,
    top_k: int = 0,
    top_p: float = 1.0,
    generator: Optional[torch.Generator] = None,
    gumbel: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Greedy or filtered-categorical sampling over (B, K, V) -> (B, K) int64.

    The categorical draw is Gumbel-argmax with noise from `generator` (Philox
    on the card), or the given `gumbel` noise of the logits' shape: it
    follows the same distribution as the JAX package's threefry draw, not
    the same bits.
    """
    if not do_sample:
        return torch.argmax(logits, dim=-1)
    x = process_logits(logits, temperature=temperature, top_k=top_k, top_p=top_p)
    if gumbel is None:
        gumbel = gumbel_noise(generator, x.shape, x.device)
    return torch.argmax(x + gumbel, dim=-1)


def gumbel_noise(generator: Optional[torch.Generator], shape, device,
                 batch_dim: Optional[int] = 0) -> torch.Tensor:
    """Gumbel(0, 1) fp32 noise of `shape` from `generator`: -log(-log(u)).
    Under data parallelism the rank's rows (on `batch_dim`) of the global
    draw (`parallel/rows.py`)."""
    u = draw_sliced(lambda s: torch.rand(s, generator=generator, device=device,
                                         dtype=torch.float32), shape, batch_dim)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))


def speculative_accept(
    p: torch.Tensor,
    q: torch.Tensor,
    cand: torch.Tensor,
    u: torch.Tensor,
    gumbel: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The speculative-sampling rejection step: accept `cand` (...,) drawn
    from the proposal q (..., V) with probability min(1, p/q), i.e. where
    u * q_c < p_c for the uniforms `u` (...,); otherwise draw from the
    residual (p - q)^+ by Gumbel-argmax over log(residual + 1e-30) with the
    `gumbel` noise (..., V), falling back to p where the residual sums to at
    most 1e-9. The token is distributed exactly as p when cand ~ q and the
    noise is independent of it. Returns (tokens, accepted)."""
    p_c = torch.gather(p, -1, cand[..., None])[..., 0]
    q_c = torch.gather(q, -1, cand[..., None])[..., 0]
    accepted = u * q_c < p_c
    residual = (p - q).clamp_min(0.0)
    empty = residual.sum(dim=-1, keepdim=True) <= 1e-9
    residual = torch.where(empty, p, residual)
    alt = torch.argmax(torch.log(residual + 1e-30) + gumbel, dim=-1)
    return torch.where(accepted, cand, alt), accepted
