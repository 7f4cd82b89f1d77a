"""Autoregressive codec-token decoder (port of `parler_tts_tpu/models/decoder.py`).

  - the K per-codebook embedding tables live in one stacked (K, vocab+1, D)
    parameter, gathered and summed in one lookup;
  - attention is GQA in the (B, T, H, Dh) layout with fp32 softmax, serving
    self- and cross-attention; with RoPE the cross-attention query is rotated
    and the encoder keys are not (the reference's quirk, kept);
  - the KV cache is a static buffer written in place: prefill (T > 1) attends
    through an additive bias, and the one-token decode step attends through
    kernel K1 (`ops/flash_decode.py`) over the flat (L, B, S, H_kv*Dh) cache,
    read in place at the layer's index;
  - the LM heads are one stacked (K, D, V) parameter applied as one einsum
    whose products are summed in fp32 and returned in fp32 (bf16 x bf16
    products are exact in fp32, so an fp32 product of the compute-dtype
    operands is the JAX einsum with preferred_element_type=float32); serving
    under `torch.inference_mode` keeps one fp32 copy of the heads;
  - with no cache the decoder runs the training route: cross k/v projected
    per layer from the encoder states, self-attention through a dense bias,
    the online-softmax scan (`ops/chunked_attention.py`) or kernel K4
    (`ops/flash_attention.py`) when `use_chunked_attention` is True/int or
    "pallas" and a (B, T) key mask is given; dropout after the embedding,
    after each sub-block and on the MLP activation; LayerDrop as a select;
    `remat_layers` recomputes each layer in the backward
    (`torch.utils.checkpoint`, the JAX package's `remat_policy=None`);
    `remat_policy="dots"` keeps the outputs of the layer's matrix products
    that have no batch dimension (`aten.mm`/`aten.addmm`: the projections
    and the MLP, `jax.checkpoint_policies.dots_with_no_batch_dims_saveable`)
    and recomputes the rest: the batched attention products, kernel K4's
    launches and the elementwise work;
  - `weight_quant=True` (int8 serving) makes every layer's attention
    projections and MLP a `QuantDense` over kernel K2 (`ops/quant_matmul.py`):
    int8 `w_q` (in, out) and fp32 per-output-channel `scale` (out,), the
    flax names; embeddings, layer norms and heads stay in the float dtype.
    `weight_quant="xla"` holds the same parameters and computes the JAX
    package's `impl="xla"` form as a plain matmul;
  - `fused_qkv=True` (serving) gives each layer's self-attention one
    `qkv_proj` kernel, q|k|v concatenated along the output axis
    (`models/parler.py:fuse_qkv_params`); cross-attention keeps its separate
    projections;
  - under tensor parallelism (`parallel/mesh.py:shard_params` sets `tp`,
    the `model` group) a rank holds H/n heads: q/k/v_proj are
    column-parallel over heads, out_proj and fc2 row-parallel (their outputs
    all-reduced), fc1 column-parallel over F, the LM heads sharded over V
    (their logits all-gathered), and the self and cross KV caches hold the
    rank's heads (`DecoderCache.zeros(model_shards=n)`). Int8 projections
    are split as their float ones (`w_q` as the kernel; a column-parallel
    `scale` by its columns, a row-parallel one whole, its partial products
    summed by the all-reduce), and a fused `qkv_proj` holds the rank's q, k
    and v heads side by side. `embed_tokens` (K, vocab+1, D) is sharded over
    its rows where n divides vocab+1 (as the JAX rule does; no Parler config
    has such a vocabulary): each codebook's lookup is vocab-parallel,
    summed over the group;
  - under sequence parallelism (the training route given a `SeqShare`,
    `parallel/collectives.py`) a rank holds its rows of the sequence at
    their absolute positions: it projects q, k and v for its rows, gathers
    k and v over `seq` (the gradient reduce-scattered back), and attends its
    rows at `q_offset` = their first position on every route; its dropout
    masks are its rows of the global masks.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from ..config import DecoderConfig
from ..ops.chunked_attention import chunked_attention
from ..ops.flash_attention import flash_attention
from ..ops.flash_decode import flash_decode_attention
from ..ops.positions import apply_rope, rope_cos_sin, sinusoidal_embed, sinusoidal_table
from ..ops.quant_matmul import quant_matmul
from ..parallel.collectives import (
    SeqShare,
    copy_to,
    gather_last,
    gather_seq,
    reduce_from,
    vocab_embedding,
)
from ..utils.quantize import quantize_kernel_torch
from .layers import Dense, LayerNorm, bernoulli, dropout, fold_in, new_param

ACT_FNS = {
    "gelu": F.gelu,
    "gelu_new": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
    "silu": F.silu,
}


@dataclass
class DecoderCache:
    """Static-shape KV cache of the whole decoder stack, updated in place.

    self_k/self_v: (L, B, S_max, H_kv*Dh), the flat layout K1 reads in place
    cross_k/cross_v: (L, B, S_enc, H_ckv, Dh), filled once per generate
    index: next self-attention write position: an int, or an int device
    tensor, () for every row or (B,) for each row's own position (the
    speculative window forward, whose offsets stay on the device)
    """

    self_k: torch.Tensor
    self_v: torch.Tensor
    cross_k: torch.Tensor
    cross_v: torch.Tensor
    index: Union[int, torch.Tensor] = 0

    @classmethod
    def zeros(cls, config: DecoderConfig, batch_size: int, max_length: int,
              encoder_length: int, dtype=torch.float32, device=None,
              model_shards: int = 1) -> "DecoderCache":
        """An empty cache; `model_shards` = n holds a tensor-parallel rank's
        H_kv/n heads."""
        n, dh = config.num_hidden_layers, config.head_dim
        self_shape = (n, batch_size, max_length,
                      config.num_key_value_heads // model_shards * dh)
        cross_shape = (n, batch_size, encoder_length,
                       config.num_cross_attention_key_value_heads // model_shards, dh)
        return cls(
            self_k=torch.zeros(self_shape, dtype=dtype, device=device),
            self_v=torch.zeros(self_shape, dtype=dtype, device=device),
            cross_k=torch.zeros(cross_shape, dtype=dtype, device=device),
            cross_v=torch.zeros(cross_shape, dtype=dtype, device=device),
        )


def _gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   bias: Optional[torch.Tensor]) -> torch.Tensor:
    """q (B, T, H, Dh) pre-scaled; k/v (B, S, H_kv, Dh); bias (B, 1, T, S).
    fp32 scores and softmax; returns (B, T, H, Dh) in q's dtype."""
    b, t, h, dh = q.shape
    h_kv = k.shape[2]
    qg = q.reshape(b, t, h_kv, h // h_kv, dh)
    scores = torch.einsum("btkgd,bskd->bkgts", qg.float(), k.float())
    if bias is not None:
        scores = scores + bias[:, :, None, :, :]
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgts,bskd->btkgd", probs, v.to(q.dtype))
    return out.reshape(b, t, h, dh)


class QuantDense(nn.Module):
    """Weight-only int8 linear: y = (x @ w_q) * scale in the module's dtype,
    x cast to the module's dtype first, as flax's `QuantDense` does. With
    `xla=False` the product runs through kernel K2 (bf16(x) @ w_q, fp32
    sums); with `xla=True` it is the JAX package's `impl="xla"` form, a plain
    matmul of the dtype-valued x and w_q summed in fp32 (both are exact in
    fp32, so it runs as an fp32 matmul), times `scale`, cast to the dtype.

    `reset_parameters` draws the float kernel a `Dense` of the same shape and
    dtype would draw, on the parameters' device, and quantizes it there
    (`utils.quantize.quantize_kernel_torch`): from one seed, a quantized model
    holds the quantization of the float model's weights."""

    def __init__(self, in_features: int, out_features: int, std: float, device=None,
                 dtype=torch.float32, xla: bool = False):
        super().__init__()
        self.w_q = new_param(in_features, out_features, device=device, dtype=torch.int8)
        self.scale = new_param(out_features, device=device, dtype=torch.float32)
        self.std = std
        self.dtype = dtype
        self.xla = xla

    def reset_parameters(self, generator: torch.Generator) -> None:
        w = torch.empty(self.w_q.shape, dtype=self.dtype, device=self.w_q.device)
        w_q, scale = quantize_kernel_torch(w.normal_(0.0, self.std, generator=generator))
        self.w_q.copy_(w_q)
        self.scale.copy_(scale)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = x.shape
        x2 = x.reshape(-1, shape[-1]).to(self.dtype)
        if self.xla:
            y = ((x2.float() @ self.w_q.float()) * self.scale).to(self.dtype)
        else:
            y = quant_matmul(x2.contiguous(), self.w_q, self.scale)
        return y.reshape(*shape[:-1], y.shape[-1])


def make_dense(in_features: int, out_features: int, std: float, device, dtype,
               weight_quant: Any, param_dtype=None) -> nn.Module:
    """The bias-free linear layer of a `weight_quant` setting: `Dense`
    (False), `QuantDense` over K2 (True) or its plain-matmul form ("xla")."""
    if weight_quant is True or weight_quant == "xla":
        return QuantDense(in_features, out_features, std, device, dtype,
                          xla=weight_quant == "xla")
    if weight_quant is False:
        return Dense(in_features, out_features, std=std, device=device, dtype=dtype,
                     param_dtype=param_dtype)
    raise ValueError(f'weight_quant must be False, True or "xla", got {weight_quant!r}')


class Attention(nn.Module):
    """Bias-free multi-head attention with GQA/MQA. `use_chunked_attention`
    picks the training route of self-attention: False (dense bias), True or
    an int (online-softmax scan, chunk 512 or that int) or "pallas" (K4).
    `fused_qkv=True` holds one `qkv_proj` in place of q/k/v_proj; only a
    self-attention takes it (`project_kv`, the cross-attention k/v, reads
    `k_proj` and `v_proj`). Head counts are read from the projections'
    widths, so a tensor-parallel rank (`tp` set) runs its own heads."""

    tp = None

    def __init__(self, config: DecoderConfig, num_kv_heads: int, device=None,
                 dtype=torch.float32, weight_quant: Any = False, param_dtype=None,
                 use_chunked_attention: Any = False, fused_qkv: bool = False):
        super().__init__()
        self.config = config
        self.num_kv_heads = num_kv_heads
        self.use_chunked_attention = use_chunked_attention
        self.fused_qkv = fused_qkv
        d, dh, std = config.hidden_size, config.head_dim, config.initializer_factor
        kw = dict(std=std, device=device, dtype=dtype, weight_quant=weight_quant,
                  param_dtype=param_dtype)
        if fused_qkv:
            self.qkv_proj = make_dense(d, d + 2 * num_kv_heads * dh, **kw)
        else:
            self.q_proj = make_dense(d, d, **kw)
            self.k_proj = make_dense(d, num_kv_heads * dh, **kw)
            self.v_proj = make_dense(d, num_kv_heads * dh, **kw)
        self.out_proj = make_dense(d, d, **kw)

    def _split(self, x: torch.Tensor) -> torch.Tensor:
        return x.reshape(x.shape[0], x.shape[1], -1, self.config.head_dim)

    def _in(self, x: torch.Tensor) -> torch.Tensor:
        """The input of the column-parallel projections."""
        return x if self.tp is None else copy_to(x, self.tp)

    def _out(self, x: torch.Tensor) -> torch.Tensor:
        """out_proj, summed over the model group when it is row-parallel."""
        y = self.out_proj(x)
        return y if self.tp is None else reduce_from(y, self.tp)

    def project_kv(self, states: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """k/v of (encoder) states, (B, S, H_kv, Dh) each."""
        states = self._in(states)
        return self._split(self.k_proj(states)), self._split(self.v_proj(states))

    def _scaled_query(self, q_raw, cos, sin):
        # scaled before RoPE like the reference (the rotation commutes with it)
        q = self._split(q_raw)
        q = q * (self.config.head_dim ** -0.5)
        if cos is not None:
            q = apply_rope(q, cos, sin)
        return q

    def _qkv(self, x):
        """Raw q, k and v projections under either layout (a fused kernel
        holds the rank's q, k and v heads side by side under `tp`)."""
        x = self._in(x)
        if self.fused_qkv:
            n = 1 if self.tp is None else self.tp.size
            q, kv = self.config.hidden_size // n, self.num_kv_heads * self.config.head_dim // n
            return self.qkv_proj(x).split([q, kv, kv], dim=-1)
        return self.q_proj(x), self.k_proj(x), self.v_proj(x)

    def self_attention(self, x, bias, cos, sin, cache: Optional[DecoderCache], layer_idx: int,
                       decode_lengths: Optional[Tuple[torch.Tensor, int]] = None,
                       mask_1d: Optional[torch.Tensor] = None,
                       seq: Optional[SeqShare] = None):
        """With a cache: writes this step's k/v into it at `cache.index`
        (each row at its own offset when that is a (B,) tensor), then attends through K1 when `decode_lengths` = (starts, limit) is
        given, else densely over the layer's cache with the additive `bias`.
        Without one (training): attends over this call's k/v, through the
        route `use_chunked_attention` picks when `mask_1d` (B, T) is given,
        else densely with `bias`. With `seq` (training only) `x` is this
        rank's rows of the sequence: k and v are gathered over `seq`, the
        rows attend at their first position, and `mask_1d` (B, T) and `bias`
        (B, 1, rows, T) cover the whole sequence's keys."""
        b, t, _ = x.shape
        q_raw, k_raw, v_raw = self._qkv(x)
        q = self._scaled_query(q_raw, cos, sin)
        k, v = self._split(k_raw), self._split(v_raw)
        if cos is not None:
            k = apply_rope(k, cos, sin)
        if cache is None:
            k, v = k.to(q.dtype), v.to(q.dtype)
            offset = 0
            if seq is not None:
                k, v, offset = gather_seq(k, seq), gather_seq(v, seq), seq.first
            route = self.use_chunked_attention
            if route == "pallas" and mask_1d is not None:
                out = flash_attention(q, k, v, mask_1d, causal=True, q_offset=offset)
            elif route and mask_1d is not None:
                chunk = 512 if route is True else int(route)
                out = chunked_attention(q, k, v, mask_1d, causal=True, q_offset=offset,
                                        chunk_q=chunk, chunk_k=chunk)
            else:
                out = _gqa_attention(q, k, v, bias)
            return self._out(out.reshape(b, t, -1))
        i = cache.index
        ck, cv = cache.self_k, cache.self_v
        if isinstance(i, torch.Tensor):
            # rows [i_b, i_b + t) of each row b, one index scatter per layer
            s = ck.shape[2]
            rows = (torch.arange(b, device=i.device)[:, None] * s + i.expand(b)[:, None]
                    + torch.arange(t, device=i.device)[None, :]).reshape(-1)
            ck[layer_idx].view(b * s, -1).index_copy_(0, rows, k.reshape(b * t, -1).to(ck.dtype))
            cv[layer_idx].view(b * s, -1).index_copy_(0, rows, v.reshape(b * t, -1).to(cv.dtype))
        else:
            ck[layer_idx, :, i:i + t] = k.reshape(b, t, -1)
            cv[layer_idx, :, i:i + t] = v.reshape(b, t, -1)
        if decode_lengths is not None:
            starts, limit = decode_lengths
            out = flash_decode_attention(q[:, 0] if t == 1 else q, ck, cv, starts, limit,
                                         layer=layer_idx)
            out = out.to(q.dtype)
            if t == 1:
                out = out[:, None]
        else:
            s = ck.shape[2]
            dh = self.config.head_dim
            k_l = ck[layer_idx].reshape(b, s, -1, dh)
            v_l = cv[layer_idx].reshape(b, s, -1, dh)
            out = _gqa_attention(q, k_l, v_l, bias)
        return self._out(out.reshape(b, t, -1))

    def cross_attention(self, x, k, v, bias, cos, sin):
        q = self._scaled_query(self.q_proj(self._in(x)), cos, sin)
        out = _gqa_attention(q, k, v, bias)
        return self._out(out.reshape(out.shape[0], out.shape[1], -1))


class DecoderLayer(nn.Module):
    """Pre-LN block: self-attn -> cross-attn -> MLP, with dropout after each
    sub-block and on the MLP activation when given a dropout key. With `tp`
    the MLP is fc1 column- and fc2 row-parallel over F."""

    tp = None

    def __init__(self, config: DecoderConfig, device=None, dtype=torch.float32,
                 weight_quant: Any = False, param_dtype=None,
                 use_chunked_attention: Any = False, fused_qkv: bool = False):
        super().__init__()
        self.config = config
        d, std = config.hidden_size, config.initializer_factor
        ln = dict(device=device, dtype=dtype, param_dtype=param_dtype)
        self.self_attn = Attention(config, config.num_key_value_heads, device, dtype,
                                   weight_quant, param_dtype, use_chunked_attention,
                                   fused_qkv)
        self.self_attn_layer_norm = LayerNorm(d, **ln)
        self.encoder_attn = Attention(config, config.num_cross_attention_key_value_heads,
                                      device, dtype, weight_quant, param_dtype)
        self.encoder_attn_layer_norm = LayerNorm(d, **ln)
        kw = dict(std=std, device=device, dtype=dtype, weight_quant=weight_quant,
                  param_dtype=param_dtype)
        self.fc1 = make_dense(d, config.ffn_dim, **kw)
        self.fc2 = make_dense(config.ffn_dim, d, **kw)
        self.final_layer_norm = LayerNorm(d, **ln)
        self.act = ACT_FNS[config.activation_function]

    def forward(self, x, *, self_attn_bias, cross_k, cross_v, cross_attn_bias, cos, sin,
                cache: Optional[DecoderCache], layer_idx: int, decode_lengths=None,
                mask_1d=None, key: Optional[int] = None, seq: Optional[SeqShare] = None):
        cfg = self.config
        times = None if seq is None else (seq.total, seq.first)
        h = self.self_attn.self_attention(
            self.self_attn_layer_norm(x), self_attn_bias, cos, sin, cache, layer_idx,
            decode_lengths, mask_1d, seq,
        )
        x = x + dropout(h, cfg.dropout, fold_in(key, "self_attn"), times=times)
        if cross_k is not None:
            h = self.encoder_attn.cross_attention(
                self.encoder_attn_layer_norm(x), cross_k, cross_v, cross_attn_bias, cos, sin
            )
            x = x + dropout(h, cfg.dropout, fold_in(key, "encoder_attn"), times=times)
        h = self.final_layer_norm(x)
        cols = None
        if self.tp is not None:
            h = copy_to(h, self.tp)
            cols = (cfg.ffn_dim, self.tp.span(cfg.ffn_dim).start)
        h = self.act(self.fc1(h))
        h = self.fc2(dropout(h, cfg.activation_dropout, fold_in(key, "activation"), cols, times))
        if self.tp is not None:
            h = reduce_from(h, self.tp)
        return x + dropout(h, cfg.dropout, fold_in(key, "fc2"), times=times)


# the matrix products with no batch dimension, whose outputs remat_policy="dots" keeps
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


REMAT_POLICIES = {None: {}, "dots": dict(
    context_fn=functools.partial(create_selective_checkpoint_contexts, _save_dots))}


class ParlerDecoder(nn.Module):
    """The decoder stack, over a static cache (serving) or without one
    (training). `remat_layers` recomputes each layer of the training route in
    the backward instead of keeping its activations; `remat_policy` (None or
    "dots") says what the recompute may keep. With `tp` the rank holds its
    rows of each codebook's embedding table."""

    tp = None

    def __init__(self, config: DecoderConfig, device=None, dtype=torch.float32,
                 weight_quant: Any = False, param_dtype=None,
                 use_chunked_attention: Any = False, remat_layers: bool = False,
                 fused_qkv: bool = False, remat_policy: Optional[str] = None):
        super().__init__()
        if remat_policy not in REMAT_POLICIES:
            raise ValueError(f"unknown remat_policy {remat_policy!r} (expected None or 'dots')")
        self.config = config
        self.dtype = dtype
        self.remat_layers = remat_layers
        self.remat_policy = remat_policy
        self.embed_tokens = new_param(config.num_codebooks, config.embed_rows,
                                      config.hidden_size, device=device,
                                      dtype=param_dtype or dtype)
        self.layers = nn.ModuleList(
            DecoderLayer(config, device, dtype, weight_quant, param_dtype,
                         use_chunked_attention, fused_qkv)
            for _ in range(config.num_hidden_layers)
        )
        self.layer_norm = LayerNorm(config.hidden_size, device=device, dtype=dtype,
                                    param_dtype=param_dtype)
        if not config.rope_embeddings:
            table = sinusoidal_table(config.max_position_embeddings, config.hidden_size,
                                     dtype, device)
            self.register_buffer("positions", table, persistent=False)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.embed_tokens.normal_(0.0, self.config.initializer_factor, generator=generator)

    def embed_ids(self, input_ids: torch.Tensor) -> torch.Tensor:
        """Sum of the K codebook embeddings: (B, K, T) -> (B, T, D), one
        gather (vocab-parallel under `tp`: each codebook's rows summed over
        the group before the codebooks are summed)."""
        cfg = self.config
        rows = self.embed_tokens.shape[1]
        flat = self.embed_tokens.reshape(-1, cfg.hidden_size)
        offsets = (torch.arange(cfg.num_codebooks, device=input_ids.device)
                   * rows)[None, :, None]
        if self.tp is None:
            out = F.embedding(input_ids + offsets, flat)
        else:
            out = vocab_embedding(input_ids, flat, self.tp, rows=rows, offsets=offsets)
        out = out.to(self.dtype).sum(dim=1)
        return out * cfg.hidden_size ** 0.5 if cfg.scale_embedding else out

    def precompute_cross_kv(self, encoder_hidden_states: torch.Tensor):
        """Per-layer cross-attention k/v, stacked (L, B, S_enc, H_ckv, Dh)."""
        x = encoder_hidden_states.to(self.dtype)
        kvs = [layer.encoder_attn.project_kv(x) for layer in self.layers]
        return torch.stack([k for k, _ in kvs]), torch.stack([v for _, v in kvs])

    def forward(self, inputs_embeds: torch.Tensor, position_ids: torch.Tensor, *,
                self_attn_bias: Optional[torch.Tensor],
                cross_attn_bias: Optional[torch.Tensor],
                cache: Optional[DecoderCache] = None,
                decode_lengths: Optional[Tuple[torch.Tensor, int]] = None,
                encoder_hidden_states: Optional[torch.Tensor] = None,
                mask_1d: Optional[torch.Tensor] = None,
                dropout_key: Optional[int] = None,
                seq: Optional[SeqShare] = None) -> torch.Tensor:
        """(B, T, D) embeds at absolute positions (B, T) -> hidden (B, T, D).
        With a cache: advances `cache.index` by T. Without one: the training
        route, cross-attending to `encoder_hidden_states` (B, S_enc, D), with
        dropout and LayerDrop when `dropout_key` is given; with `seq` the
        embeds are this rank's rows of the sequence (`Attention.self_attention`)."""
        cfg = self.config
        x = inputs_embeds.to(self.dtype)
        cos = sin = None
        if cfg.rope_embeddings:
            cos, sin = rope_cos_sin(position_ids, cfg.head_dim, cfg.rope_theta, x.dtype)
        else:
            x = x + sinusoidal_embed(self.positions, position_ids)
        times = None if seq is None else (seq.total, seq.first)
        x = dropout(x, cfg.dropout, fold_in(dropout_key, "embed"), times=times)
        layerdrop = dropout_key is not None and cfg.layerdrop > 0.0 and cache is None
        enc = None if encoder_hidden_states is None else encoder_hidden_states.to(self.dtype)
        for i, layer in enumerate(self.layers):
            key = fold_in(dropout_key, "layer", i)
            if cache is not None:
                x = layer(
                    x, self_attn_bias=self_attn_bias, cross_k=cache.cross_k[i],
                    cross_v=cache.cross_v[i], cross_attn_bias=cross_attn_bias, cos=cos,
                    sin=sin, cache=cache, layer_idx=i, decode_lengths=decode_lengths, key=key,
                )
                continue
            cross_k = cross_v = None
            if enc is not None:
                cross_k, cross_v = layer.encoder_attn.project_kv(enc)
            kw = dict(self_attn_bias=self_attn_bias, cross_k=cross_k, cross_v=cross_v,
                      cross_attn_bias=cross_attn_bias, cos=cos, sin=sin, cache=None,
                      layer_idx=i, mask_1d=mask_1d, key=key, seq=seq)
            if self.remat_layers and torch.is_grad_enabled():
                # the layer's dropout masks come from `key` (and its rows from
                # `seq`), so the recompute draws the same ones without restoring
                # any generator state; it gathers k and v over `seq` again
                out = checkpoint(layer, x, use_reentrant=False, preserve_rng_state=False,
                                 **REMAT_POLICIES[self.remat_policy], **kw)
            else:
                out = layer(x, **kw)
            if layerdrop:  # a select of one scalar draw: every seq rank runs the layer
                dropped = bernoulli(cfg.layerdrop, fold_in(dropout_key, "layerdrop", i),
                                    x.device)
                out = torch.where(dropped, x, out)
            x = out
        if cache is not None:
            cache.index = cache.index + inputs_embeds.shape[1]
        return self.layer_norm(x)


class ParlerForCausalLM(nn.Module):
    """Decoder + stacked LM heads (never quantized, as in the JAX package).
    With `tp` the rank holds V/n columns of each head, and the logits are
    all-gathered over the model group."""

    tp = None

    def __init__(self, config: DecoderConfig, device=None, dtype=torch.float32,
                 weight_quant: Any = False, param_dtype=None,
                 use_chunked_attention: Any = False, remat_layers: bool = False,
                 fused_qkv: bool = False, remat_policy: Optional[str] = None):
        super().__init__()
        self.config = config
        self.dtype = dtype
        self.decoder = ParlerDecoder(config, device, dtype, weight_quant, param_dtype,
                                     use_chunked_attention, remat_layers, fused_qkv,
                                     remat_policy)
        self.lm_heads = new_param(config.num_codebooks, config.hidden_size, config.vocab_size,
                                  device=device, dtype=param_dtype or dtype)
        self._serving_heads: Optional[Tuple[Any, torch.Tensor]] = None

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.lm_heads.normal_(0.0, self.config.initializer_factor, generator=generator)

    def heads_fp32(self) -> torch.Tensor:
        """The heads rounded to the compute dtype, as fp32. Under
        `torch.inference_mode` one copy is kept until the heads change;
        otherwise the cast is part of the graph, so the gradient reaches
        `lm_heads`."""
        if not torch.is_inference_mode_enabled():
            return self.lm_heads.to(self.dtype).float()
        tag = (self.lm_heads.data_ptr(), self.lm_heads._version)
        if self._serving_heads is None or self._serving_heads[0] != tag:
            self._serving_heads = (tag, self.lm_heads.to(self.dtype).float())
        return self._serving_heads[1]

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """(B, T, D) -> (B, K, T, V) fp32, summed in fp32 from the
        compute-dtype hidden states and heads."""
        if self.tp is None:
            return torch.einsum("btd,kdv->bktv", hidden.to(self.dtype).float(),
                                self.heads_fp32())
        h = copy_to(hidden.to(self.dtype).float(), self.tp)
        return gather_last(torch.einsum("btd,kdv->bktv", h, self.heads_fp32()), self.tp)

    def full_heads(self) -> torch.Tensor:
        """The (K, D, V) heads: all-gathered over the model group under
        tensor parallelism (the gradient reaches the rank's columns)."""
        return self.lm_heads if self.tp is None else gather_last(self.lm_heads, self.tp)

    def forward(self, inputs_embeds, position_ids, *, self_attn_bias, cross_attn_bias,
                cache: Optional[DecoderCache] = None, decode_lengths=None,
                encoder_hidden_states=None, mask_1d=None, dropout_key=None) -> torch.Tensor:
        hidden = self.decoder(inputs_embeds, position_ids, self_attn_bias=self_attn_bias,
                              cross_attn_bias=cross_attn_bias, cache=cache,
                              decode_lengths=decode_lengths,
                              encoder_hidden_states=encoder_hidden_states, mask_1d=mask_1d,
                              dropout_key=dropout_key)
        return self.logits(hidden)

    def embed_ids(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self.decoder.embed_ids(input_ids)

    def precompute_cross_kv(self, encoder_hidden_states: torch.Tensor):
        return self.decoder.precompute_cross_kv(encoder_hidden_states)
