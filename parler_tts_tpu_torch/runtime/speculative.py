"""Speculative multi-column decoding (port of
`parler_tts_tpu/runtime/speculative.py`, the JAX package's default B=1
serving mode).

Each forward runs the decoder over a window of W candidate columns at once
(kernel K1 with W query columns and per-column causal limits, and every
projection at M = B * W rows) and finalizes the longest prefix the model
confirms:

  - greedy: candidates equal to the argmax of their verified context are
    accepted, so the tokens are the AR loop's;
  - sampling: per-codebook speculative rejection (`speculative_accept`), so
    each column is distributed as the AR loop's, and the first rejected
    column is still finalized by the residual draw: >= 1 column a forward;
  - the next window's candidates are this forward's own proposals (Jacobi
    self-drafts), or, with `lookup_ngram=g`, the continuation of the latest
    earlier occurrence of the last g finalized columns
    (`history_lookup_window`).

With `per_row=True` each batch row advances by its own accepted prefix: the
column pointer `t`, K1's limits and the cache's write offsets are (B,)
tensors. Otherwise the batch shares the shortest prefix.

The pointer, the limits and the cache offsets stay on the device: a forward
makes no host read. The loop learns of its end through `_ExitPoll`, a
non-blocking copy of one flag to the host that it polls each forward; the
forwards it runs past the end (on the card, the ones in flight when the copy
lands) are frozen: every row that is done advances 0 columns, so the result
is unchanged. `SpecStats.frozen` counts them.

The offline loop (`generate_tokens_speculative`) and the stream chunks
(`make_stream_functions_speculative`) run one step body in the same order,
so a stream's tokens are the offline ones. Every random draw goes through
`draw_noise`, so a test can replay another sampler's draws.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..config import GenerationConfig
from ..models.decoder import DecoderCache
from ..models.parler import ParlerTTS
from ..parallel.rows import draw_sliced
from ..ops.delay_pattern import apply_delay_pattern_mask, undelay_pattern, valid_frame_lengths
from ..ops.masks import causal_self_attention_bias, padding_cross_attention_bias
from ..ops.sampling import (
    NEG_INF,
    EosState,
    advance_eos_state,
    apply_top_k,
    apply_top_p,
    gumbel_noise,
    init_eos_state,
    mask_eos_ordering,
    speculative_accept,
)
from .generate import (
    GenerateOutput,
    Prefilled,
    _decoder_only_side,
    _encoder_side,
    _prefill_decoder,
    _sample_column,
    data_parallel,
)


class SpecStats(NamedTuple):
    """Speculation accounting beside the tokens: `forwards` the window
    forwards that advanced some row (the JAX package's count), `columns` the
    columns they finalized (summed over rows when per-row), `frozen` the
    forwards run past the end, which changed nothing."""

    forwards: int
    columns: int
    frozen: int


@dataclass
class SpecState:
    """The carried state of the speculative loop, offline and streaming,
    updated in place by a step. The ids span L + 2W columns (columns past L
    forced to PAD), the cache s_p + L + W slots; `t` (the next column to
    finalize) and the cache's write index are () int64 device tensors, (B,)
    when per-row."""

    out_ids: torch.Tensor            # (B, K, L + 2W) stored (pattern-overridden) ids
    cand_toks: torch.Tensor          # (W, B, K) candidates for columns [t, t + W)
    cand_q: Optional[torch.Tensor]   # (W, B, K, V) their proposal distributions (sampling)
    cache: DecoderCache
    eos: EosState                    # the EOS state through column t - 1
    generator: Optional[torch.Generator]
    t: torch.Tensor
    n_fwd: torch.Tensor              # () int64: forwards that advanced some row
    pattern: torch.Tensor            # (B, K, L + 2W) delay pattern, PAD past L
    kv_valid: torch.Tensor           # (B, S_cache)
    enc_mask: Optional[torch.Tensor]
    flash_starts: torch.Tensor       # (B,) int32: K1's first valid slot of each row
    s_p: int
    prompt_cols: int                 # decoder-prompt columns (min_new_tokens counts from there)
    t0: int                          # the first column the loop finalizes
    runs: int = 0                    # forwards run, frozen ones included (host count)


def draw_noise(generator: Optional[torch.Generator], kind: str, shape, device) -> torch.Tensor:
    """Every random draw of the speculative path, fp32 from `generator`:
    "uniform" in [0, 1) or "gumbel" Gumbel(0, 1). In order: the first
    column's Gumbels (B, K, V) and the first window's (B, K, W, V); then
    per forward the acceptance uniforms (W, B, K), the residual Gumbels and
    the proposal Gumbels (W, B, K, V) each. The shape is the global batch's:
    under data parallelism `_draw` keeps the rank's rows."""
    if kind == "uniform":
        return torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
    return gumbel_noise(generator, shape, device, batch_dim=None)


def _draw(generator, kind: str, shape, device, batch_dim: int) -> torch.Tensor:
    """`draw_noise` of the global shape, the rank's rows of it
    (`parallel/rows.py`)."""
    return draw_sliced(lambda s: draw_noise(generator, kind, s, device), shape, batch_dim)


def _base_logits(logits: torch.Tensor, col_idx, gen: GenerationConfig, prompt_cols: int):
    """The EOS-state-independent processors (`_process_column`'s order):
    codebook guard, then min-length EOS suppression. `col_idx` is an int for
    (B, K, V) logits, or a (W,) or per-row (B, W) tensor of column indices
    for (B, K, W, V) logits."""
    x = logits.to(torch.float32)
    ids = torch.arange(x.shape[-1], device=x.device)
    if gen.codebook_guard is not None:
        x = x.masked_fill((ids >= gen.codebook_guard) & (ids != gen.eos_token_id), NEG_INF)
    if gen.min_new_tokens > 0:
        active = torch.as_tensor(col_idx, device=x.device) < gen.min_new_tokens + prompt_cols
        if active.dim() == 1:      # (W,) columns of (B, K, W, V)
            active = active[:, None]
        elif active.dim() == 2:    # per-row (B, W)
            active = active[:, None, :, None]
        x = x.masked_fill(active & (ids == gen.eos_token_id), NEG_INF)
    return x


def history_lookup_window(out_ids, stored_f, t, n, fallback, *, g_n: int, w: int,
                          return_found: bool = False):
    """History-lookup draft (prompt lookup): the continuation of the latest
    earlier position whose last `g_n` columns (all K codebooks) equal the
    current suffix, where there is one, else `fallback`.

    out_ids (B, K, L) stored ids; stored_f (W, B, K) this forward's
    finalized window, written at t first so that columns [t, t + n) are
    final; t and n () or (B,) tensors (the entry pointer and the accepted
    count); fallback (W, B, K). Returns (W, B, K), and with `return_found`
    the (B,) bools of the rows that matched. Slices clamp as JAX's
    `dynamic_slice` does."""
    b, k_cb, length = out_ids.shape
    device = out_ids.device
    t_b, n_b = t.expand(b), n.expand(b)

    def columns(start, width):  # (B, K, width) gather index of [start_b, start_b + width)
        idx = start[:, None] + torch.arange(width, device=device)[None, :]
        return idx[:, None, :].expand(b, k_cb, width)

    hist = out_ids.scatter(2, columns(t_b.clamp(max=length - w), w), stored_f.permute(1, 2, 0))
    t_new = t_b + n_b
    tgt = hist.gather(2, columns((t_new - g_n).clamp(0, length - g_n), g_n))   # (B, K, g)
    eq = (hist[:, :, :, None] == tgt[:, :, None, :]).all(dim=1)                # (B, L, g)
    n_pos = length - g_n + 1
    score = sum(eq[:, j:n_pos + j, j].long() for j in range(g_n))              # (B, P)
    pos = torch.arange(n_pos, device=device) + g_n                            # start column p
    # p < t_new: no trivial self-match; early columns cannot match at all
    sc = torch.where(pos[None, :] <= t_new[:, None] - 1, score, torch.full_like(score, -1))
    best = torch.argmax(sc * (length + 1) + pos[None, :], dim=1)               # latest match
    found = sc.gather(1, best[:, None])[:, 0] == g_n
    cont = hist.gather(2, columns(pos[best].clamp(max=length - w), w)).permute(2, 0, 1)
    blended = torch.where(found[None, :, None], cont, fallback)
    return (blended, found) if return_found else blended


def _make_spec_step(model: ParlerTTS, gen: GenerationConfig, window: int,
                    per_row: bool = False, lookup_ngram: int = 0):
    """The one-forward body, `spec_step(state)`, which advances a SpecState
    in place: one decoder forward over columns t - 1 .. t + W - 2, the
    vectorised verify of the W columns, the next window's candidates, and
    the write of finals and candidates in one 2W-wide block. Rows that are
    done (EOS on every codebook, or t at max_length) advance 0."""
    dcfg = model.config.decoder
    k_cb, max_len, w, v = dcfg.num_codebooks, gen.max_length, window, dcfg.vocab_size
    eos_id, pad_id = gen.eos_token_id, gen.pad_token_id
    greedy = not gen.do_sample
    hoist = gen.top_k <= 0 and gen.top_p >= 1.0
    # the window forward attends through K1 with per-column limits; K1's
    # [start, limit) bounds cannot express a sliding window, which keeps the
    # dense bias path (as in the JAX package)
    win_cfg = dcfg.sliding_window if gen.cache_implementation == "sliding_window" else None
    g_n = lookup_ngram

    def verify_window(logits, state: SpecState, uniforms, res_g):
        """Accept the W window columns, vectorised across the window: the
        only sequential dependency, the EOS trajectory of the candidates, is
        a cumulative OR and an at-most-+1 bump recurrence over W (B,)-sized
        steps; every V-sized op runs once over (W, B, K, V). On the accepted
        prefix the finals equal the candidates, so the candidate trajectory
        is exact there; the first rejected column is re-recorded below."""
        device = logits.device
        b = logits.shape[0]
        ar_w = torch.arange(w, device=device)
        col_idx = state.t[:, None] + ar_w[None, :] if per_row else state.t + ar_w
        xw = _base_logits(logits, col_idx, gen, state.prompt_cols).permute(2, 0, 1, 3)
        cand = state.cand_toks                                        # (W, B, K)
        e0 = state.eos.eos_seen                                       # (B, K)
        es_after = e0[None] | (torch.cumsum((cand == eos_id).long(), dim=0) > 0)
        es = torch.cat([e0[None], es_after[:-1]], dim=0)              # eos_seen before column i
        fu, fus = state.eos.first_unfinished.long(), []
        for i in range(w):
            fu = fu + (es[i].gather(1, fu[:, None])[:, 0] & (fu < k_cb - 1))
            fus.append(fu)
        fu_w = torch.stack(fus)                                       # (W, B)
        cb_idx = torch.arange(k_cb, device=device)
        forbid = cb_idx[None, None, :] > fu_w[:, :, None]             # (W, B, K)
        eos_oh = torch.arange(v, device=device) == eos_id

        if greedy:
            final = torch.argmax(xw.masked_fill(forbid[..., None] & eos_oh, NEG_INF), dim=-1)
            final = final.masked_fill(es, pad_id)
            q_vecs = None
        else:
            if hoist:
                xt = xw / gen.temperature if gen.temperature != 1.0 else xw
                q_vecs = torch.softmax(xt, dim=-1)
                # the EOS-masked distribution by renormalisation: drop the
                # EOS entry of forbidden codebooks and rescale
                scale = torch.where(
                    forbid, 1.0 / (1.0 - q_vecs[..., eos_id]).clamp_min(1e-9),
                    torch.ones((), device=device))
                p = (q_vecs * scale[..., None]).masked_fill(forbid[..., None] & eos_oh, 0.0)
            else:
                xm = xw.masked_fill(forbid[..., None] & eos_oh, NEG_INF)
                xt = xm / gen.temperature if gen.temperature != 1.0 else xm
                p = torch.softmax(apply_top_p(apply_top_k(xt, gen.top_k), gen.top_p), dim=-1)
                q_vecs = p                 # proposals drawn before the PAD forcing
            # finished entries emit PAD (the AR loop's fill)
            pad_oh = (torch.arange(v, device=device) == pad_id).float()
            p = torch.where(es[..., None], pad_oh, p)
            final, _ = speculative_accept(p, state.cand_q, cand, uniforms, res_g)

        # accept horizon: column i is final when every earlier one matched
        # (the first column always is); done rows advance 0
        if per_row:
            match = (final == cand).all(dim=2)                                   # (W, B)
            m = match & ~es_after.all(dim=2) & (col_idx.T + 1 < max_len)
            done = e0.all(dim=1) | (state.t >= max_len)                          # (B,)
        else:
            match = (final == cand).all(dim=2).all(dim=1)                        # (W,)
            m = match & ~es_after.all(dim=2).all(dim=1) & (col_idx + 1 < max_len)
            done = e0.all() | (state.t >= max_len)                               # ()
        finalized = torch.cat([torch.ones_like(m[:1]),
                               torch.cumprod(m[:-1].long(), dim=0) > 0], dim=0)
        n_acc = torch.where(done, 0, finalized.long().sum(dim=0))                 # () or (B,)

        # the EOS state after the last finalized column, from its final tokens
        i_last = (n_acc - 1).clamp(0, w - 1).expand(b)
        pick = i_last[None, :, None].expand(1, b, k_cb)
        fin_last = final.gather(0, pick)[0]
        es_last = es.gather(0, pick)[0]
        fu_last = fu_w.gather(0, i_last[None, :])[0]
        done_b = done.expand(b)
        eos_new = EosState(
            eos_seen=torch.where(done_b[:, None], e0, es_last | (fin_last == eos_id)),
            first_unfinished=torch.where(done_b, state.eos.first_unfinished,
                                         fu_last.to(torch.int32)),
        )
        pat_w = state.pattern.gather(2, _cols(state.t, 0, w, b, k_cb)).permute(2, 0, 1)
        stored = torch.where(pat_w == -1, final, pat_w)
        return final, stored, q_vecs, n_acc, eos_new, done

    def spec_step(state: SpecState) -> None:
        b = state.out_ids.shape[0]
        device = state.out_ids.device
        uniforms = res_g = None
        if not greedy:
            uniforms = _draw(state.generator, "uniform", (w, b, k_cb), device, 1)
            res_g = _draw(state.generator, "gumbel", (w, b, k_cb, v), device, 1)

        # ---- one forward over the window: inputs are columns t-1 .. t+W-2
        in_cols = _cols(state.t, -1, w, b, k_cb)                                 # (B, K, W)
        q_pos = state.s_p + in_cols[:, 0, :]                                     # (B, W)
        emb = model.decoder.embed_ids(state.out_ids.gather(2, in_cols))
        if win_cfg is None:
            # column i of the window sees slots [start, s_p + t + i)
            limit = (state.s_p + state.t.expand(b)).to(torch.int32).contiguous()
            bias, lengths = None, (state.flash_starts, limit)
        else:
            bias = causal_self_attention_bias(q_pos, state.kv_valid, win_cfg)
            lengths = None
        logits = model.decoder(
            emb, q_pos, self_attn_bias=bias,
            cross_attn_bias=padding_cross_attention_bias(state.enc_mask, w),
            cache=state.cache, decode_lengths=lengths,
        )                                                                        # (B, K, W, V)
        finals, stored_f, q_vecs, n, eos_new, done = verify_window(logits, state, uniforms,
                                                                   res_g)

        # ---- next window for columns [t+n, t+n+W-1]: slot j draws from this
        # forward's distribution at column min(n + j, W - 1)
        ar_w = torch.arange(w, device=device)
        if per_row:
            src = (n[None, :] + ar_w[:, None]).clamp(max=w - 1)                   # (W, B)

            def take_src(a):
                return a.gather(0, src.reshape(src.shape + (1,) * (a.dim() - 2)).expand_as(a))
        else:
            src = (n + ar_w).clamp(max=w - 1)                                    # (W,)

            def take_src(a):
                return a.index_select(0, src)
        # the (B, K) entries that have finished emit PAD at every later column
        es_next = advance_eos_state(eos_new, k_cb).eos_seen
        if greedy:
            new_cand = take_src(finals)                                          # (W, B, K)
            if g_n:
                new_cand = history_lookup_window(state.out_ids, stored_f, state.t, n, new_cand,
                                                 g_n=g_n, w=w).masked_fill(es_next[None], pad_id)
            new_q = None
        else:
            new_q = take_src(q_vecs)                                             # (W, B, K, V)
            if g_n:
                # a matched lookup proposes its continuation with a delta
                # proposal q = one_hot(token): still exact, it accepts with
                # probability p(token) and the residual excludes it
                lk_cand, lk_found = history_lookup_window(
                    state.out_ids, stored_f, state.t, n, torch.zeros_like(finals),
                    g_n=g_n, w=w, return_found=True)
                new_q = torch.where(lk_found[None, :, None, None],
                                    F.one_hot(lk_cand, v).float(), new_q)
            gp = _draw(state.generator, "gumbel", (w, b, k_cb, v), device, 1)
            log_q = torch.where(new_q > 0.0, torch.log(new_q),
                                torch.full((), float("-inf"), device=device))
            new_cand = torch.argmax(log_q + gp, dim=-1)
            # finished entries propose PAD with q = delta_PAD, which the
            # forced-PAD final then accepts
            new_cand = new_cand.masked_fill(es_next[None], pad_id)
            pad_oh = (torch.arange(v, device=device) == pad_id).float()
            new_q = torch.where(es_next[None, :, :, None], pad_oh, new_q)
        t_next = state.t + n
        pat_next = state.pattern.gather(2, _cols(t_next, 0, w, b, k_cb)).permute(2, 0, 1)
        new_stored = torch.where(pat_next == -1, new_cand, pat_next)

        # ---- finals, then the next candidates, in one 2W-wide block at t
        i_idx = torch.arange(2 * w, device=device)
        fin_sel = stored_f.index_select(0, i_idx.clamp(max=w - 1))              # (2W, B, K)
        blk_cols = _cols(state.t, 0, 2 * w, b, k_cb)                             # (B, K, 2W)
        cur = state.out_ids.gather(2, blk_cols).permute(2, 0, 1)
        n_b = n.expand(b)
        rel = i_idx[:, None] - n_b[None, :]                                      # (2W, B)
        cand_sel = new_stored.gather(0, rel.clamp(0, w - 1)[:, :, None].expand(2 * w, b, k_cb))
        blk = torch.where((rel < 0)[:, :, None], fin_sel,
                          torch.where((rel < w)[:, :, None], cand_sel, cur))
        state.out_ids.scatter_(2, blk_cols, blk.permute(1, 2, 0))

        # the write index back to s_p + t + n - 1: the K/V rows of rejected
        # columns are rewritten by the next forward before any query sees them
        state.cache.index = state.cache.index - w + n
        state.cand_toks, state.cand_q, state.eos = new_cand, new_q, eos_new
        state.t = t_next
        state.n_fwd = state.n_fwd + (~done).any().long()
        state.runs += 1

    return spec_step


def _cols(t: torch.Tensor, offset: int, width: int, b: int, k_cb: int) -> torch.Tensor:
    """(B, K, width) gather index of the columns [t_b + offset, t_b + offset
    + width) of each row; t () or (B,)."""
    idx = t.expand(b)[:, None] + offset + torch.arange(width, device=t.device)[None, :]
    return idx[:, None, :].expand(b, k_cb, width)


def _prefill_and_window(model, gen: GenerationConfig, pre: Prefilled, generator, w: int,
                        per_row: bool = False) -> SpecState:
    """The first sampled column (index s0) and the first candidate window
    for columns [s0 + 1, s0 + W], proposed from the prefill's distribution.
    Shared by the composite and the decoder-only entry points."""
    dcfg = model.config.decoder
    k_cb, v = dcfg.num_codebooks, dcfg.vocab_size
    eos_id, pad_id = gen.eos_token_id, gen.pad_token_id
    b, device, s0 = pre.out_ids.shape[0], pre.out_ids.device, pre.s0
    out_ids, pattern = pre.out_ids, pre.pattern

    eos_state = init_eos_state(b, k_cb, device)
    g1 = _draw(generator, "gumbel", (b, k_cb, v), device, 0) if gen.do_sample else None
    col, eos_state = _sample_column(pre.logits, s0, eos_state, pattern, gen, k_cb,
                                    prompt_cols=s0, generator=generator, gumbel=g1)
    out_ids[:, :, s0] = col

    x1 = _base_logits(pre.logits, s0, gen, s0)
    adv0 = advance_eos_state(eos_state, k_cb)
    cand_q = None
    if not gen.do_sample:
        raw = torch.argmax(mask_eos_ordering(x1, adv0, eos_id), dim=-1)
        cand = raw.masked_fill(adv0.eos_seen, pad_id)[None].expand(w, b, k_cb)
    else:
        if gen.top_k <= 0 and gen.top_p >= 1.0:
            xw = x1
        else:
            xw = mask_eos_ordering(x1, adv0, eos_id)
        xw = xw / gen.temperature if gen.temperature != 1.0 else xw
        xw = apply_top_p(apply_top_k(xw, gen.top_k), gen.top_p)
        q0 = torch.softmax(xw, dim=-1)
        g = _draw(generator, "gumbel", (b, k_cb, w, v), device, 0)
        cand = torch.argmax(xw[:, :, None, :] + g, dim=-1).permute(2, 0, 1)     # (W, B, K)
        # finished entries propose PAD with q = delta_PAD
        es0 = adv0.eos_seen
        pad_oh = (torch.arange(v, device=device) == pad_id).float()
        cand = cand.masked_fill(es0[None], pad_id)
        cand_q = torch.where(es0[None, :, :, None], pad_oh, q0[None].expand(w, b, k_cb, v))
    cand = cand.contiguous()
    t0 = s0 + 1
    pat0 = pattern[:, :, t0:t0 + w]
    out_ids[:, :, t0:t0 + w] = torch.where(pat0 == -1, cand.permute(1, 2, 0), pat0)

    shape = (b,) if per_row else ()
    cache = pre.cache
    cache.index = torch.full(shape, cache.index, dtype=torch.int64, device=device)
    return SpecState(
        out_ids=out_ids, cand_toks=cand, cand_q=cand_q, cache=cache, eos=eos_state,
        generator=generator, t=torch.full(shape, t0, dtype=torch.int64, device=device),
        n_fwd=torch.zeros((), dtype=torch.int64, device=device), pattern=pattern,
        kv_valid=pre.kv_valid, enc_mask=pre.enc_mask, flash_starts=pre.flash_starts,
        s_p=pre.s_p, prompt_cols=s0, t0=t0,
    )


def _init_spec_state(model, gen, desc_ids, desc_mask, prompt_ids, prompt_mask, generator,
                     decoder_prompt_codes, cache_dtype, window: int,
                     per_row: bool = False) -> SpecState:
    """Encoder, prefill of a cache s_p + max_length + W slots long (the
    window forward writes K/V up to column t + W - 2), the first column and
    the first window."""
    side = _encoder_side(model, gen, desc_ids, desc_mask, prompt_ids, prompt_mask,
                         decoder_prompt_codes)
    pre = _prefill_decoder(model, gen, *side, cache_dtype, extra=window)
    return _prefill_and_window(model, gen, pre, generator, window, per_row)


class _ExitPoll:
    """The loop's exit test without a host wait. On the card each call
    starts a copy of the device flag `running` into pinned host memory when
    none is in flight, and reports the end once a copy that has landed shows
    it false; the forwards run meanwhile are frozen ones. On the CPU the
    flag is read at once. With `sync` (tensor parallelism: the ranks of a
    model group must run the same forwards, since each forward all-reduces)
    a call waits for the copy the previous call started, so the loop ends
    one forward after the flag falls on every rank alike."""

    def __init__(self, device: torch.device, sync: bool = False):
        self.cuda = device.type == "cuda"
        self.sync = sync
        self.host = torch.zeros((), dtype=torch.bool, pin_memory=self.cuda)
        self.event = None

    def ended(self, running: torch.Tensor) -> bool:
        if not self.cuda:
            return not bool(running)
        if self.event is not None:
            if self.sync:
                self.event.synchronize()
            elif not self.event.query():
                return False
            self.event = None
            if not bool(self.host):
                return True
        self.host.copy_(running, non_blocking=True)
        self.event = torch.cuda.Event()
        self.event.record()
        return False


def _running(state: SpecState, target, per_row: bool) -> torch.Tensor:
    """() bool on the device: some row is below `target` and not finished."""
    if per_row:
        return ((state.t < target) & ~state.eos.eos_seen.all(dim=1)).any()
    return (state.t < target) & ~state.eos.eos_seen.all()


def _drive(step, state: SpecState, target, per_row: bool, max_forwards: int,
           sync: bool = False) -> None:
    """Run forwards until no row is below `target` and unfinished. Each
    forward finalizes >= 1 column of every such row, so `max_forwards` =
    the largest distance to the target bounds the loop without a read.
    `sync`: the exit poll of a tensor-parallel model (`_ExitPoll`)."""
    poll = _ExitPoll(state.out_ids.device, sync)
    for _ in range(max_forwards):
        if poll.ended(_running(state, target, per_row)):
            break
        step(state)


def _finalize_spec_output(state: SpecState, gen: GenerationConfig, k_cb: int,
                          frame_pad_id: int):
    """Columns >= t were never finalized: restore the pattern's tail there,
    re-apply the delay mask, un-delay. Returns (GenerateOutput, SpecStats),
    with the loop's one read of the device."""
    max_len = gen.max_length
    pattern = state.pattern[:, :, :max_len]
    cols = torch.arange(max_len, device=pattern.device)[None, None, :]
    tail = torch.where(pattern == -1, torch.full_like(pattern, gen.pad_token_id), pattern)
    thr = state.t[:, None, None] if state.t.dim() else state.t
    out = torch.where(cols >= thr, tail, state.out_ids[:, :, :max_len])
    delayed = apply_delay_pattern_mask(out, pattern)
    codes = undelay_pattern(delayed, k_cb)
    lengths = valid_frame_lengths(codes, frame_pad_id)
    t = torch.atleast_1d(state.t).tolist()
    n_fwd = int(state.n_fwd)
    stats = SpecStats(forwards=n_fwd, columns=sum(x - state.t0 for x in t),
                      frozen=state.runs - n_fwd)
    return GenerateOutput(delayed, codes, lengths, max(t)), stats


@torch.inference_mode()
def generate_tokens_speculative(
    model: ParlerTTS,
    gen: GenerationConfig,
    desc_ids: torch.Tensor,
    desc_mask: Optional[torch.Tensor],
    prompt_ids: torch.Tensor,
    prompt_mask: Optional[torch.Tensor],
    generator: Optional[torch.Generator] = None,
    decoder_prompt_codes: Optional[torch.Tensor] = None,
    cache_dtype=torch.bfloat16,
    window: int = 8,
    per_row: bool = False,
    lookup_ngram: int = 3,
):
    """Speculative generation on the device of `desc_ids`: the contract of
    `generate_tokens`, plus SpecStats. Greedy tokens are the AR loop's;
    sampled columns follow the AR sampling distribution but draw other
    noise. `per_row=True` advances each row by its own accepted prefix;
    otherwise the batch shares the shortest. `lookup_ngram=g` (0 disables)
    adds the history-lookup draft."""
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    state = _init_spec_state(model, gen, desc_ids, desc_mask, prompt_ids, prompt_mask,
                             generator, decoder_prompt_codes, cache_dtype, window, per_row)
    return _run_spec(model, gen, state, window, per_row, lookup_ngram)


def _run_spec(model, gen, state: SpecState, window: int, per_row: bool, lookup_ngram: int):
    dcfg = model.config.decoder
    step = _make_spec_step(model, gen, window, per_row=per_row, lookup_ngram=lookup_ngram)
    _drive(step, state, gen.max_length, per_row, gen.max_length - state.t0,
           model.model_shards > 1)
    return _finalize_spec_output(state, gen, dcfg.num_codebooks, dcfg.pad_token_id)


def make_generate_speculative(model: ParlerTTS, gen: GenerationConfig, window: int = 8,
                              cache_dtype=torch.bfloat16, per_row: bool = False,
                              lookup_ngram: int = 3, mesh=None):
    """`generate_tokens_speculative` with its settings bound:
    fn(desc_ids, desc_mask, prompt_ids, prompt_mask, generator=None,
    decoder_prompt_codes=None) -> (GenerateOutput, SpecStats). With `mesh`,
    as `generate.make_generate(mesh=)`: each `data` rank runs its rows (the
    SpecStats are the rank's), tensor parallelism inside its `model` group,
    and every rank returns the global GenerateOutput."""

    def fn(desc_ids, desc_mask, prompt_ids, prompt_mask, generator=None,
           decoder_prompt_codes=None):
        return generate_tokens_speculative(
            model, gen, desc_ids, desc_mask, prompt_ids, prompt_mask, generator,
            decoder_prompt_codes=decoder_prompt_codes, cache_dtype=cache_dtype, window=window,
            per_row=per_row, lookup_ngram=lookup_ngram,
        )

    return fn if mesh is None else data_parallel(fn, model, mesh)


def make_stream_functions_speculative(model: ParlerTTS, gen: GenerationConfig,
                                      window: int = 8, cache_dtype=torch.bfloat16,
                                      per_row: bool = False, lookup_ngram: int = 3):
    """(prefill_fn, step_chunk_fn) for speculative streaming, the contract
    of `generate.make_stream_functions` (the state has `t`, `eos`,
    `out_ids`; columns below t are final), over the offline loop's step:

      prefill_fn(desc_ids, desc_mask, prompt_ids, prompt_mask, generator=None,
                 decoder_prompt_codes=None) -> SpecState;
      step_chunk_fn(state, n_steps) -> state, every unfinished row at least
                 `n_steps` columns further (or at max_length).

    A chunk may overshoot by W - 1 columns and more: the exit poll lets it
    run on while its flag travels to the host (the tokens are the offline
    ones all the same). Per-row, `t` is (B,) and each row's columns past its
    own t hold unverified candidates."""
    max_len = gen.max_length
    step = _make_spec_step(model, gen, window, per_row=per_row, lookup_ngram=lookup_ngram)

    @torch.inference_mode()
    def prefill_fn(desc_ids, desc_mask, prompt_ids, prompt_mask, generator=None,
                   decoder_prompt_codes=None) -> SpecState:
        return _init_spec_state(model, gen, desc_ids, desc_mask, prompt_ids, prompt_mask,
                                generator, decoder_prompt_codes, cache_dtype, window, per_row)

    @torch.inference_mode()
    def step_chunk_fn(state: SpecState, n_steps: int) -> SpecState:
        target = (state.t + n_steps).clamp(max=max_len)
        _drive(step, state, target, per_row, n_steps, model.model_shards > 1)
        return state

    return prefill_fn, step_chunk_fn


@torch.inference_mode()
def generate_tokens_decoder_only_speculative(
    model: ParlerTTS,
    gen: GenerationConfig,
    batch_size: int,
    encoder_hidden_states: Optional[torch.Tensor] = None,
    encoder_mask: Optional[torch.Tensor] = None,
    decoder_prompt_codes: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    cache_dtype=torch.bfloat16,
    window: int = 8,
    lookup_ngram: int = 3,
    device=None,
):
    """Decoder-only speculative generation: `generate_tokens_decoder_only`'s
    inputs through the window machinery of `generate_tokens_speculative`,
    the batch sharing its accept horizon. Returns (GenerateOutput,
    SpecStats)."""
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    side = _decoder_only_side(model, gen, batch_size, encoder_hidden_states, encoder_mask,
                              decoder_prompt_codes, device)
    pre = _prefill_decoder(model, gen, *side, cache_dtype, extra=window)
    state = _prefill_and_window(model, gen, pre, generator, window)
    return _run_spec(model, gen, state, window, False, lookup_ngram)
