"""Token generation over the static KV cache (port of the static-cache path
of `parler_tts_tpu/runtime/generate.py`).

Prefill, then a one-column decode loop: each step embeds the previous
column, runs the decoder with kernel K1 over the cache (with
`cache_implementation="sliding_window"`, through the dense bias path with
the window in the mask, as the JAX package does: K1's [start, limit) bounds
cannot express a query-relative window), applies the
processors in the reference order (codebook guard -> min-length -> EOS
ordering -> warpers), forces PAD on finished codebooks and overrides with the
delay pattern. The loop runs on the host in Python with no host sync inside a
step: the step index is a Python int, and the all-EOS early exit is checked
on the host only every `EOS_CHECK_EVERY` steps. Steps run past the exit
rewrite the values the output already holds (finished rows emit PAD, which
the pattern keeps), and `steps` is recovered exactly from the per-step
all-EOS record, so the results equal a loop that checks every step.

`generate_tokens_fused` (port of `generate_tokens_fused`) is the B=1 serving
mode whose decode step is kernel K3 (`ops/fused_decode_step.py`): the whole
layer stack of one token in one launch with int8 weights, the final LN and
the stacked heads in fp32 after it. Prefill and sampling are shared with
`generate_tokens`.

`make_stream_functions` (port of the JAX package's) cuts the same loop into
chunks of columns for streaming: a prefill that returns a `StreamState`,
and a chunk step that advances it. The offline loop and the chunks call one
decode step (`_advance`), so a stream's greedy tokens are the offline ones.

`make_generate(model, gen, cache_dtype, mesh)` binds `generate_tokens`; with
a mesh (`parallel/mesh.py`) each `data` rank generates its rows of the
global request, tensor parallelism runs inside its `model` group, and the
outputs are all-gathered over `data` (`data_parallel`), so every rank
returns the global result. Noise is drawn for the global batch and each
rank keeps its rows (`parallel/rows.py`): a sampled run over a mesh equals
the single-process run at the same seed.

`generate_tokens_decoder_only` runs the same prefill and loop without the
text encoder (`_decoder_only_side` in place of `_encoder_side`); the
speculative loop (`runtime/speculative.py`) shares the prefill
(`_prefill_decoder`) with a cache and ids wider by its window.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from ..config import GenerationConfig, ParlerTTSConfig
from ..models.decoder import DecoderCache
from ..models.parler import ParlerTTS
from ..ops.delay_pattern import (
    apply_delay_pattern_mask,
    build_delay_pattern_mask,
    undelay_pattern,
    valid_frame_lengths,
)
from ..ops.fused_decode_step import FusedParams, check_fused_config, fused_decode_layers
from ..ops.masks import causal_self_attention_bias, padding_cross_attention_bias
from ..ops.positions import sinusoidal_table
from ..parallel.collectives import all_gather_dim, all_max
from ..parallel.distributed import local_batch_slice
from ..parallel.rows import row_share
from ..ops.sampling import (
    NEG_INF,
    EosState,
    advance_eos_state,
    init_eos_state,
    mask_eos_ordering,
    record_sampled,
    sample_tokens,
    suppress_eos_before_min_length,
)

# decode steps between host checks of the all-EOS early exit
EOS_CHECK_EVERY = 32


class GenerateOutput(NamedTuple):
    delayed_ids: torch.Tensor  # (B, K, L)
    codes: torch.Tensor        # (B, K, L - K) un-delayed
    lengths: torch.Tensor      # (B,) valid frame counts
    steps: int                 # columns actually sampled (early exit aware)


def _process_column(
    logits: torch.Tensor,
    t: int,
    eos_state: EosState,
    gen: GenerationConfig,
    num_codebooks: int,
    prompt_cols: int = 1,
) -> Tuple[torch.Tensor, EosState]:
    """The logits processors of one sampling event, in the reference order:
    codebook guard, min-length, EOS ordering. Returns the fp32 logits the
    sampler sees and the advanced EOS state."""
    x = logits.to(torch.float32)
    if gen.codebook_guard is not None:
        ids = torch.arange(x.shape[-1], device=x.device)
        blocked = (ids >= gen.codebook_guard) & (ids != gen.eos_token_id)
        x = x.masked_fill(blocked[None, None, :], NEG_INF)
    if gen.min_new_tokens > 0:
        x = suppress_eos_before_min_length(
            x, t, gen.min_new_tokens + prompt_cols, gen.eos_token_id
        )
    eos_state = advance_eos_state(eos_state, num_codebooks)
    return mask_eos_ordering(x, eos_state, gen.eos_token_id), eos_state


def _sample_column(
    logits: torch.Tensor,  # (B, K, V)
    t: int,
    eos_state: EosState,
    pattern: torch.Tensor,
    gen: GenerationConfig,
    num_codebooks: int,
    prompt_cols: int = 1,
    generator: Optional[torch.Generator] = None,
    gumbel: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, EosState]:
    """One sampling event: processors, sampling, finished-row PAD forcing,
    delay-pattern override. `prompt_cols` = decoder-prompt column count
    (min_new_tokens counts from there); `gumbel` (B, K, V), when given, is
    the sampler's noise in place of a draw from `generator`."""
    x, eos_state = _process_column(logits, t, eos_state, gen, num_codebooks, prompt_cols)
    toks = sample_tokens(
        x, do_sample=gen.do_sample, temperature=gen.temperature,
        top_k=gen.top_k, top_p=gen.top_p, generator=generator, gumbel=gumbel,
    )
    toks = toks.masked_fill(eos_state.eos_seen, gen.pad_token_id)
    eos_state = record_sampled(eos_state, toks, gen.eos_token_id)
    pat_col = pattern[:, :, t]
    return torch.where(pat_col == -1, toks, pat_col), eos_state


def generate_tokens(
    model: ParlerTTS,
    gen: GenerationConfig,
    desc_ids: torch.Tensor,
    desc_mask: Optional[torch.Tensor],
    prompt_ids: torch.Tensor,
    prompt_mask: Optional[torch.Tensor],
    generator: Optional[torch.Generator] = None,
    decoder_prompt_codes: Optional[torch.Tensor] = None,
    cache_dtype=torch.bfloat16,
) -> GenerateOutput:
    """Full token generation on the device of `desc_ids`.

    `decoder_prompt_codes` (B, K, T0) steers the voice: codec tokens of a
    reference clip are the decoder prompt after the BOS column.
    """
    return _generate(model, gen, desc_ids, desc_mask, prompt_ids, prompt_mask, generator,
                     decoder_prompt_codes, cache_dtype, fused=None)


def generate_tokens_fused(
    model: ParlerTTS,
    gen: GenerationConfig,
    fused: FusedParams,
    desc_ids: torch.Tensor,
    desc_mask: Optional[torch.Tensor],
    prompt_ids: torch.Tensor,
    prompt_mask: Optional[torch.Tensor],
    generator: Optional[torch.Generator] = None,
    decoder_prompt_codes: Optional[torch.Tensor] = None,
) -> GenerateOutput:
    """B=1 generation whose decode step is kernel K3 over `fused`
    (`prepare_fused_params` of the model's float decoder). The KV cache is
    bf16 whatever the model's dtype, as in the JAX package."""
    dcfg = model.config.decoder
    if desc_ids.shape[0] != 1:
        raise ValueError(f"the fused decode path serves B=1, got B={desc_ids.shape[0]}")
    check_fused_config(dcfg)
    if model.model_shards > 1:
        raise NotImplementedError("the fused decode step runs the whole model on one "
                                  "device: it takes no mesh, as the JAX package's fused "
                                  "path (make_generate_fused) takes none")
    if gen.cache_implementation == "sliding_window":
        raise ValueError("the fused decode step uses [start, n_rows) bounds; "
                         "sliding_window needs the eager path")
    return _generate(model, gen, desc_ids, desc_mask, prompt_ids, prompt_mask, generator,
                     decoder_prompt_codes, torch.bfloat16, fused=fused)


@dataclass
class StreamState:
    """The carried state of the host-driven decode loop (port of the JAX
    package's `StreamState`): the delayed ids written so far, the cache, the
    EOS state, the sampler's generator and the next column `t` (a host int).
    `prompt_cols` is the decoder prompt's column count (1 for BOS only, 1 + T0
    under voice steering): min_new_tokens counts from there, as offline.
    `step(t)` runs the decoder over column t - 1 and returns column t's
    logits (B, K, V); it writes the cache in place and holds the masks the
    JAX state carries (kv_valid, enc_mask). The state is updated in place
    and returned by the functions that advance it."""

    out_ids: torch.Tensor   # (B, K, L)
    cache: DecoderCache
    eos: EosState
    generator: Optional[torch.Generator]
    t: int
    pattern: torch.Tensor   # (B, K, L)
    s_p: int
    prompt_cols: int
    step: Callable[[int], torch.Tensor]


def _encoder_side(model, gen, desc_ids, desc_mask, prompt_ids, prompt_mask,
                  decoder_prompt_codes):
    """The text side of a request: (prefix, prefix_mask, enc_states, enc_mask,
    start): the decoder's prompt prefix (B, s_p, D) and its (B, s_p) mask
    (empty when the prompt goes through cross-attention), the encoder states
    and mask, and the decoder prompt's columns (B, K, s0): BOS, then any
    voice-prompt codes."""
    cfg: ParlerTTSConfig = model.config
    b, device = desc_ids.shape[0], desc_ids.device
    if desc_mask is None:
        desc_mask = torch.ones_like(desc_ids)
    if prompt_mask is None:
        prompt_mask = torch.ones_like(prompt_ids)
    enc = model.encode_description(desc_ids, desc_mask)
    prompt = model.prompt_hidden(prompt_ids)
    pca = cfg.prompt_cross_attention
    enc_states, enc_mask = model.build_encoder_states(
        enc, desc_mask, prompt if pca else None, prompt_mask if pca else None
    )
    if pca:
        prefix = prompt.new_zeros((b, 0, cfg.decoder.hidden_size))
        prefix_mask = torch.zeros((b, 0), dtype=torch.int32, device=device)
    else:
        prefix, prefix_mask = prompt, prompt_mask.to(torch.int32)
    return prefix, prefix_mask, enc_states, enc_mask, _start_columns(
        gen, model.config.decoder.num_codebooks, b, device, decoder_prompt_codes)


def _start_columns(gen, k_cb, b, device, decoder_prompt_codes) -> torch.Tensor:
    """The decoder prompt (B, K, s0): the BOS column, then any voice-prompt
    codes."""
    start = torch.full((b, k_cb, 1), gen.bos_token_id, dtype=torch.int64, device=device)
    if decoder_prompt_codes is not None:
        start = torch.cat([start, decoder_prompt_codes.to(device, torch.int64)], dim=-1)
    return start


@dataclass
class Prefilled:
    """The decoder after its prefill: the delay pattern and the delayed ids,
    (B, K, L + 2 * extra) each with columns past L forced to PAD, the
    cache of s_p + L + extra slots, its (B, S) validity, K1's starts (the
    first valid slot of each row), the positions (B, S), and the prefill's
    last logits (B, K, V). `s0` is the decoder prompt's column count."""

    pattern: torch.Tensor
    out_ids: torch.Tensor
    cache: DecoderCache
    kv_valid: torch.Tensor
    flash_starts: torch.Tensor
    positions: torch.Tensor
    logits: torch.Tensor
    enc_mask: Optional[torch.Tensor]
    s_p: int
    s0: int


def _prefill_decoder(model, gen, prefix, prefix_mask, enc_states, enc_mask, start,
                     cache_dtype, extra: int = 0) -> Prefilled:
    """Delay pattern, cache and the prefill forward over [prompt prefix,
    decoder prompt]. `extra` columns beyond max_length (the speculative
    window) widen the ids by 2 * extra and the cache by extra slots."""
    dcfg = model.config.decoder
    k_cb, max_len = dcfg.num_codebooks, gen.max_length
    b, s_p, device = start.shape[0], prefix.shape[1], start.device
    if gen.cache_implementation not in ("static", "sliding_window"):
        raise ValueError(f"cache_implementation must be 'static' or 'sliding_window', "
                         f"got {gen.cache_implementation!r}")
    # the sliding-window option bounds self-attention to the last
    # `sliding_window` positions of the static cache
    window = dcfg.sliding_window if gen.cache_implementation == "sliding_window" else None
    if s_p + max_len + extra > dcfg.max_position_embeddings:
        raise ValueError(
            f"prompt ({s_p}) + max_length ({max_len}) + window ({extra}) exceeds "
            f"max_position_embeddings={dcfg.max_position_embeddings}"
        )
    first_ids, pattern = build_delay_pattern_mask(
        start, gen.bos_token_id, gen.pad_token_id, max_len
    )
    pad = torch.full((b, k_cb, 2 * extra), gen.pad_token_id, dtype=pattern.dtype, device=device)
    pattern_ext = torch.cat([pattern, pad], dim=-1)
    out_ids = torch.where(pattern_ext == -1, torch.full_like(pattern_ext, gen.pad_token_id),
                          pattern_ext)

    s_cache = s_p + max_len + extra
    cache = DecoderCache.zeros(dcfg, b, s_cache, enc_states.shape[1], cache_dtype, device,
                               model.model_shards)
    cache.cross_k, cache.cross_v = model.decoder.precompute_cross_kv(enc_states)
    kv_valid = torch.cat(
        [prefix_mask.to(torch.bool),
         torch.ones((b, s_cache - s_p), dtype=torch.bool, device=device)], dim=1)
    # left-padded prompts: first valid cache slot of each row, K1's `starts`
    flash_starts = (s_p - prefix_mask.sum(dim=1)).to(torch.int32).contiguous()
    positions = torch.arange(s_cache, device=device)[None, :].expand(b, s_cache)

    s0 = first_ids.shape[-1]
    emb0 = model.decoder.embed_ids(first_ids)
    pre_embeds = torch.cat([prefix.to(emb0.dtype), emb0], dim=1)
    abs_pos = positions[:, : s_p + s0]
    logits_pre = model.decoder(
        pre_embeds, abs_pos,
        self_attn_bias=causal_self_attention_bias(abs_pos, kv_valid, window),
        cross_attn_bias=padding_cross_attention_bias(enc_mask, s_p + s0),
        cache=cache,
    )
    return Prefilled(pattern_ext, out_ids, cache, kv_valid, flash_starts, positions,
                     logits_pre[:, :, -1, :], enc_mask, s_p, s0)


@torch.inference_mode()
def _prefill(model, gen, desc_ids, desc_mask, prompt_ids, prompt_mask, generator,
             decoder_prompt_codes, cache_dtype, fused) -> StreamState:
    """Encoder, prefill and the first sampled column (index s0); the decode
    step over K1 (the dense bias path with a sliding window) or, with
    `fused`, over K3."""
    side = _encoder_side(model, gen, desc_ids, desc_mask, prompt_ids, prompt_mask,
                         decoder_prompt_codes)
    return _ar_state(model, gen, _prefill_decoder(model, gen, *side, cache_dtype), generator,
                     fused)


def _ar_state(model, gen, pre: Prefilled, generator, fused) -> StreamState:
    """The first sampled column (index s0) and the one-column decode step."""
    dcfg = model.config.decoder
    k_cb = dcfg.num_codebooks
    b, s_p, s0, out_ids = pre.out_ids.shape[0], pre.s_p, pre.s0, pre.out_ids
    window = dcfg.sliding_window if gen.cache_implementation == "sliding_window" else None
    eos_state = init_eos_state(b, k_cb, out_ids.device)
    col, eos_state = _sample_column(
        pre.logits, s0, eos_state, pre.pattern, gen, k_cb, prompt_cols=s0, generator=generator,
    )
    out_ids[:, :, s0] = col
    cache, positions, kv_valid = pre.cache, pre.positions, pre.kv_valid

    if fused is None:
        cross_bias = padding_cross_attention_bias(pre.enc_mask, 1)

        def decode_step(t: int) -> torch.Tensor:
            emb = model.decoder.embed_ids(out_ids[:, :, t - 1: t])
            q_pos = positions[:, s_p + t - 1: s_p + t]
            if window is None:
                bias, lengths = None, (pre.flash_starts, s_p + t)
            else:
                bias, lengths = causal_self_attention_bias(q_pos, kv_valid, window), None
            return model.decoder(
                emb, q_pos, self_attn_bias=bias, cross_attn_bias=cross_bias, cache=cache,
                decode_lengths=lengths,
            )[:, :, -1, :]
    else:
        decode_step = _fused_step(model, fused, cache, pre.enc_mask, out_ids, s_p, s0,
                                  pre.flash_starts[0])
    return StreamState(out_ids, cache, eos_state, generator, s0 + 1, pre.pattern, s_p, s0,
                       decode_step)


def _advance(state: StreamState, gen: GenerationConfig, num_codebooks: int) -> None:
    """Sample column `state.t` and move on to the next: the one decode step
    that the offline loop and the stream chunks share."""
    col, state.eos = _sample_column(
        state.step(state.t), state.t, state.eos, state.pattern, gen, num_codebooks,
        prompt_cols=state.prompt_cols, generator=state.generator,
    )
    state.out_ids[:, :, state.t] = col
    state.t += 1


@torch.inference_mode()
def _generate(model, gen, desc_ids, desc_mask, prompt_ids, prompt_mask, generator,
              decoder_prompt_codes, cache_dtype, fused) -> GenerateOutput:
    return _run(model, gen, _prefill(model, gen, desc_ids, desc_mask, prompt_ids, prompt_mask,
                                     generator, decoder_prompt_codes, cache_dtype, fused))


def _run(model, gen, state: StreamState) -> GenerateOutput:
    """The decode loop from a prefilled state to max_length or the all-EOS
    exit."""
    k_cb, max_len = model.config.decoder.num_codebooks, gen.max_length
    s0 = state.prompt_cols
    # all_done[t]: every codebook of every row had emitted EOS before column t
    all_done = torch.zeros((max_len + 2,), dtype=torch.bool, device=state.out_ids.device)
    while state.t < max_len:
        all_done[state.t] = state.eos.eos_seen.all()
        if (state.t - s0 - 1) % EOS_CHECK_EVERY == 0 and bool(all_done[state.t]):
            break
        _advance(state, gen, k_cb)
    t = state.t
    all_done[t] = state.eos.eos_seen.all()
    done_at = torch.nonzero(all_done[s0 + 1: t + 1])
    steps = s0 + 1 + int(done_at[0, 0]) if done_at.numel() else t
    delayed = apply_delay_pattern_mask(state.out_ids, state.pattern)
    codes = undelay_pattern(delayed, k_cb)
    pad = model.config.decoder.pad_token_id  # pad == eos == codebook_size
    return GenerateOutput(delayed, codes, valid_frame_lengths(codes, pad), steps)


def make_generate(model: ParlerTTS, gen: GenerationConfig, cache_dtype=torch.bfloat16,
                  mesh=None):
    """`generate_tokens` with its settings bound (port of the JAX package's
    `make_generate`): fn(desc_ids, desc_mask, prompt_ids, prompt_mask,
    generator=None, decoder_prompt_codes=None) -> GenerateOutput. With
    `mesh`, every rank is given the global request and returns the global
    result (`data_parallel`); `model` is sharded on that mesh
    (`parallel.mesh.shard_params`), or whole when the mesh has no model
    axis."""

    def fn(desc_ids, desc_mask, prompt_ids, prompt_mask, generator=None,
           decoder_prompt_codes=None):
        return generate_tokens(model, gen, desc_ids, desc_mask, prompt_ids, prompt_mask,
                               generator, decoder_prompt_codes, cache_dtype)

    return fn if mesh is None else data_parallel(fn, model, mesh)


def data_parallel(fn, model: ParlerTTS, mesh):
    """`fn(desc_ids, desc_mask, prompt_ids, prompt_mask, generator,
    decoder_prompt_codes)` over a mesh: this rank's `data` share of the
    rows, under the row share of its draws, then the outputs all-gathered
    over `data` (`steps` the largest). `fn` returns a GenerateOutput, or a
    tuple whose first item is one (the rest, such as SpecStats, stay the
    rank's own)."""
    if model.model_shards != mesh.model.size:
        raise ValueError(f"the model is sharded {model.model_shards} ways over the model "
                         f"axis, the mesh has {mesh.model.size}: shard_params(model, mesh)")

    def run(desc_ids, desc_mask, prompt_ids, prompt_mask, generator=None,
            decoder_prompt_codes=None):
        b = desc_ids.shape[0]
        rows = local_batch_slice(b, mesh.data.rank, mesh.data.size)

        def mine(x):
            return None if x is None else x[rows]

        with row_share(b, rows.start):
            res = fn(mine(desc_ids), mine(desc_mask), mine(prompt_ids), mine(prompt_mask),
                     generator, mine(decoder_prompt_codes))
        out, rest = (res, None) if isinstance(res, GenerateOutput) else (res[0], res[1:])
        steps = all_max(torch.tensor([out.steps], device=out.delayed_ids.device), mesh.data)
        out = GenerateOutput(*(all_gather_dim(x, 0, mesh.data) for x in out[:3]),
                             int(steps[0]))
        return out if rest is None else (out, *rest)

    return run


def resolve_device(device=None) -> torch.device:
    """`cuda` unless the caller names a device; raises when CUDA is asked for
    and absent (the port has no silent CPU fallback)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: parler_tts_tpu_torch runs on the GPU; pass device='cpu' "
            "to run on the CPU"
        )
    return dev


def _decoder_only_side(model, gen, batch_size, encoder_hidden_states, encoder_mask,
                       decoder_prompt_codes, device):
    """`_encoder_side` without a text encoder: no prompt prefix, the given
    encoder states (B, S_enc, D) or one zero state that cross-attention
    masks out, and the decoder prompt."""
    dcfg = model.config.decoder
    given = next((x for x in (encoder_hidden_states, decoder_prompt_codes) if x is not None),
                 None)
    device = given.device if given is not None else resolve_device(device)
    b = batch_size
    if encoder_hidden_states is None:
        encoder_hidden_states = torch.zeros((b, 1, dcfg.hidden_size), device=device)
        encoder_mask = torch.zeros((b, 1), dtype=torch.int32, device=device)
    prefix = torch.zeros((b, 0, dcfg.hidden_size), device=device)
    prefix_mask = torch.zeros((b, 0), dtype=torch.int32, device=device)
    start = _start_columns(gen, dcfg.num_codebooks, b, device, decoder_prompt_codes)
    return prefix, prefix_mask, encoder_hidden_states.to(device), encoder_mask, start


@torch.inference_mode()
def generate_tokens_decoder_only(
    model: ParlerTTS,
    gen: GenerationConfig,
    batch_size: int,
    encoder_hidden_states: Optional[torch.Tensor] = None,
    encoder_mask: Optional[torch.Tensor] = None,
    decoder_prompt_codes: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    cache_dtype=torch.bfloat16,
    device=None,
) -> GenerateOutput:
    """Decoder-only generation (port of the JAX package's
    `generate_tokens_decoder_only`): no text encoder and no prompt prefix;
    cross-attention reads the precomputed `encoder_hidden_states` (B, S_enc,
    D) under `encoder_mask` (B, S_enc), or one zero state it masks out; the
    decoder prompt is BOS and any `decoder_prompt_codes` (B, K, T0). The
    decode steps run over K1 as in `generate_tokens`. It runs on the device
    of the given tensors, else on `device` (`cuda` unless named)."""
    side = _decoder_only_side(model, gen, batch_size, encoder_hidden_states, encoder_mask,
                              decoder_prompt_codes, device)
    pre = _prefill_decoder(model, gen, *side, cache_dtype)
    return _run(model, gen, _ar_state(model, gen, pre, generator, None))


def make_stream_functions(model: ParlerTTS, gen: GenerationConfig,
                          cache_dtype=torch.bfloat16):
    """(prefill_fn, step_chunk_fn) for streaming generation (port of the JAX
    package's `make_stream_functions`), over the offline loop's decode step:

      prefill_fn(desc_ids, desc_mask, prompt_ids, prompt_mask, generator=None,
                 decoder_prompt_codes=None) -> StreamState, at t = s0 + 1;
      step_chunk_fn(state, n_steps) -> state, `n_steps` columns further.

    Once `t >= max_length` or every codebook of every row has seen EOS, the
    state stops changing: `t`, `out_ids`, the cache and the EOS state keep
    the values they had when that first held (the JAX package's freeze). A
    chunk reads the device once, at its end: steps run past the freeze are
    undone there (their columns get back the pattern's fill, their cache
    rows their zeros, the EOS state its value at the freeze), so the host
    does not wait on the device between steps. The stream never takes the
    fused K3 step, as in the JAX package."""
    k_cb, max_len = model.config.decoder.num_codebooks, gen.max_length

    def prefill_fn(desc_ids, desc_mask, prompt_ids, prompt_mask, generator=None,
                   decoder_prompt_codes=None) -> StreamState:
        return _prefill(model, gen, desc_ids, desc_mask, prompt_ids, prompt_mask, generator,
                        decoder_prompt_codes, cache_dtype, fused=None)

    @torch.inference_mode()
    def step_chunk_fn(state: StreamState, n_steps: int) -> StreamState:
        t0 = state.t
        eos = [state.eos]
        done = [state.eos.eos_seen.all()]  # done[i]: frozen before step i
        for _ in range(n_steps):
            if state.t >= max_len:
                break
            _advance(state, gen, k_cb)
            eos.append(state.eos)
            done.append(state.eos.eos_seen.all())
        frozen = torch.stack(done).nonzero()
        if frozen.numel():  # the one read of the device in a chunk
            t_f = t0 + int(frozen[0, 0])
            if t_f < state.t:
                fill = state.pattern[:, :, t_f:state.t]
                state.out_ids[:, :, t_f:state.t] = torch.where(
                    fill == -1, torch.full_like(fill, gen.pad_token_id), fill)
                lo, hi = state.s_p + t_f - 1, state.s_p + state.t - 1
                state.cache.self_k[:, :, lo:hi] = 0
                state.cache.self_v[:, :, lo:hi] = 0
                state.cache.index = lo
                state.eos = eos[t_f - t0]
                state.t = t_f
        return state

    return prefill_fn, step_chunk_fn


def _fused_step(model: ParlerTTS, fp: FusedParams, cache: DecoderCache, enc_mask, out_ids,
                s_p: int, s0: int, start: torch.Tensor):
    """The B=1 decode step over K3: column t -> logits (1, K, V) in fp32, for
    t = s0 + 1, s0 + 2, ... in turn. The kernel returns the new k/v rows,
    written here into the cache at n_rows. `start` (the first valid cache
    row, a () int32 tensor) and n_rows stay on the device: n_rows starts at
    s_p + s0, the prefill's length, and each step advances it there."""
    dcfg = model.config.decoder
    n_layers, d = dcfg.num_hidden_layers, dcfg.hidden_size
    lm = model.decoder
    device = out_ids.device
    table = sinusoidal_table(dcfg.max_position_embeddings, d, torch.float32, device)
    self_k, self_v = cache.self_k[:, 0], cache.self_v[:, 0]  # (L, S, D) views
    s_enc = cache.cross_k.shape[2]
    cross_k = cache.cross_k[:, 0].reshape(n_layers, s_enc, d).to(torch.bfloat16).contiguous()
    cross_v = cache.cross_v[:, 0].reshape(n_layers, s_enc, d).to(torch.bfloat16).contiguous()
    enc_bias = torch.zeros((1, s_enc), dtype=torch.float32, device=device)
    if enc_mask is not None:
        enc_bias = enc_bias.masked_fill(~enc_mask.to(torch.bool), torch.finfo(torch.float32).min)
    ln = lm.decoder.layer_norm
    ln_scale, ln_bias = ln.scale.float(), ln.bias.float()
    heads = lm.heads_fp32()
    n_rows = torch.full((), s_p + s0, dtype=torch.int32, device=device)

    def step(t: int) -> torch.Tensor:
        row = n_rows.long().view(1)
        emb = lm.embed_ids(out_ids[:, :, t - 1: t]).float()[0] + table.index_select(0, row)
        hidden, new_k, new_v = fused_decode_layers(
            dcfg, fp, emb.to(torch.bfloat16), self_k, self_v, cross_k, cross_v, enc_bias,
            start, n_rows,
        )
        self_k.index_copy_(1, row, new_k)
        self_v.index_copy_(1, row, new_v)
        n_rows.add_(1)
        hf = torch.nn.functional.layer_norm(hidden.float(), (d,), ln_scale, ln_bias, 1e-5)
        return torch.einsum("td,kdv->tkv", hf, heads)

    return step
