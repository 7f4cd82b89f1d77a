"""Per-codebook masked cross-entropy (port of `parler_tts_tpu/ops/losses.py`).

  - labels equal to -100 or to BOS are ignored;
  - positions whose *input* token is EOS are dropped (only the first EOS of
    a codebook counts);
  - the loss is a sum over valid tokens (`weighted_sum_loss`) with its token
    count (`num_items`), so a caller can divide by a count gathered over
    micro-batches or devices, as the training step does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

Losses = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _token_mask(labels, decoder_input_ids, bos_token_id, eos_token_id, vocab):
    """(valid (B, K, T) bool, labels clipped into the vocab (B, K, T))."""
    labels_kt = labels.transpose(1, 2)
    ignore = (labels_kt == -100) | (labels_kt == bos_token_id)
    mask = (decoder_input_ids != eos_token_id) & ~ignore
    return mask, labels_kt.clamp(0, vocab - 1).long()


def _reduce(per_cb_sum, per_cb_count, codebook_weights) -> Losses:
    k = per_cb_sum.shape[0]
    per_cb_mean = per_cb_sum / per_cb_count.clamp_min(1.0)
    if codebook_weights is not None:
        w = torch.tensor(codebook_weights, dtype=torch.float32, device=per_cb_sum.device)
        weighted_sum = (per_cb_sum * w).sum() / w.sum() * k
    else:
        weighted_sum = per_cb_sum.sum()
    return weighted_sum, per_cb_count.sum(), per_cb_mean, per_cb_count


def per_codebook_cross_entropy(
    logits: torch.Tensor,
    labels: torch.Tensor,
    decoder_input_ids: torch.Tensor,
    *,
    bos_token_id: int,
    eos_token_id: int,
    codebook_weights: Optional[Tuple[float, ...]] = None,
) -> Losses:
    """logits (B, K, T, V), labels (B, T, K) (-100 = ignore), the shifted
    inputs (B, K, T) that produced the logits. Returns (weighted_sum_loss,
    num_items, per_codebook_mean (K,), per_codebook_count (K,)), fp32."""
    mask, safe = _token_mask(labels, decoder_input_ids, bos_token_id, eos_token_id,
                             logits.shape[-1])
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    nll = torch.where(mask, nll, torch.zeros((), device=nll.device))
    return _reduce(nll.sum(dim=(0, 2)), mask.sum(dim=(0, 2)).float(), codebook_weights)


def _chunk_sums(hidden, heads, labels, mask):
    logits = torch.einsum("btd,kdv->bktv", hidden.float(), heads)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels[..., None])[..., 0]
    return torch.where(mask, nll, torch.zeros((), device=nll.device)).sum(dim=(0, 2))


def chunked_per_codebook_cross_entropy(
    hidden: torch.Tensor,
    lm_heads: torch.Tensor,
    labels: torch.Tensor,
    decoder_input_ids: torch.Tensor,
    *,
    bos_token_id: int,
    eos_token_id: int,
    codebook_weights: Optional[Tuple[float, ...]] = None,
    chunk_size: int = 256,
    head_dtype=None,
) -> Losses:
    """`per_codebook_cross_entropy` fused with the LM heads, chunked over T:
    each chunk's head product, log-softmax and gather run under
    `torch.utils.checkpoint`, so at most one (B, K, chunk, V) block of
    logits is alive and the backward recomputes it. `hidden` (B, T, D) are
    the pre-head states, `lm_heads` (K, D, V), rounded to `head_dtype` as
    `ParlerForCausalLM.logits` rounds them; products summed in fp32."""
    t = hidden.shape[1]
    vocab = lm_heads.shape[-1]
    mask, safe = _token_mask(labels, decoder_input_ids, bos_token_id, eos_token_id, vocab)
    heads = (lm_heads.to(head_dtype) if head_dtype is not None else lm_heads).float()
    sums = []
    for lo in range(0, t, chunk_size):
        hi = min(lo + chunk_size, t)
        args = (hidden[:, lo:hi], heads, safe[:, :, lo:hi], mask[:, :, lo:hi])
        if torch.is_grad_enabled():
            sums.append(checkpoint(_chunk_sums, *args, use_reentrant=False))
        else:
            sums.append(_chunk_sums(*args))
    per_cb_sum = torch.stack(sums).sum(dim=0)
    return _reduce(per_cb_sum, mask.sum(dim=(0, 2)).float(), codebook_weights)


def mean_loss_reference_style(
    logits: torch.Tensor,
    labels: torch.Tensor,
    decoder_input_ids: torch.Tensor,
    *,
    bos_token_id: int,
    eos_token_id: int,
    codebook_weights: Optional[Tuple[float, ...]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """`loss_reduction="mean"`: the mean (or codebook_weights-weighted mean)
    of the per-codebook mean CEs. Returns (loss, per_codebook_mean)."""
    _, _, per_cb_mean, _ = per_codebook_cross_entropy(
        logits, labels, decoder_input_ids, bos_token_id=bos_token_id,
        eos_token_id=eos_token_id,
    )
    if codebook_weights is not None:
        w = torch.tensor(codebook_weights, dtype=torch.float32, device=per_cb_mean.device)
        return (per_cb_mean * w).sum() / w.sum(), per_cb_mean
    return per_cb_mean.mean(), per_cb_mean


def shift_tokens_right(labels: torch.Tensor, pad_token_id: int,
                       decoder_start_token_id: int,
                       first_column: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, T, K) labels -> (B, K, T) decoder input ids: shifted right along T,
    the start token first (or `first_column` (B, 1, K), the label column
    before these under sequence parallelism), -100 replaced by pad."""
    shifted = torch.roll(labels, 1, dims=1)
    if first_column is None:
        shifted[:, 0, :] = decoder_start_token_id
    else:
        shifted[:, :1, :] = first_column
    shifted = shifted.masked_fill(shifted == -100, pad_token_id)
    return shifted.transpose(1, 2)
