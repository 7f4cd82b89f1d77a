"""Encoder-only T5, the Flan-T5 description encoder (port of
`parler_tts_tpu/models/t5_encoder.py`).

T5 specifics: RMS layer norm (no mean, no bias, eps 1e-6), no 1/sqrt(d)
score scaling, one relative-position-bias table shared by all layers
(bidirectional buckets), gated-gelu MLPs for flan variants.

Dropout (`dropout_rate`) runs at the JAX package's five sites: after the
embedding, after each block's attention, on the gated MLP's hidden state,
after each block's MLP, and after the final norm. It is off unless
`forward` gets a dropout key (`models/layers.py:dropout`).

Under tensor parallelism (`tp`, set by `parallel/mesh.py:shard_params`) a
rank runs H/n heads: q/k/v column-parallel and o row-parallel, wi_0/wi_1
column- and wo row-parallel over d_ff, the shared embedding vocab-parallel
where n divides its rows; the relative-position table stays whole and each
rank takes its heads' columns of it.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config import T5Config
from ..parallel.collectives import copy_to, reduce_from, vocab_embedding
from .layers import Dense, dropout, fold_in, new_param

_ACTS = {
    "gelu": lambda y: F.gelu(y, approximate="tanh"),  # HF t5 "gelu_new"
    "gelu_new": lambda y: F.gelu(y, approximate="tanh"),
    "relu": F.relu,
    "silu": F.silu,
}


def relative_position_bucket(
    relative_position: torch.Tensor, num_buckets: int = 32, max_distance: int = 128
) -> torch.Tensor:
    """Bidirectional T5 relative-position bucketing (encoder form)."""
    num_buckets = num_buckets // 2
    ret = (relative_position > 0).to(torch.int64) * num_buckets
    n = relative_position.abs()
    max_exact = num_buckets // 2
    is_small = n < max_exact
    val_if_large = max_exact + (
        torch.log(n.to(torch.float32) / max_exact)
        / np.log(max_distance / max_exact)
        * (num_buckets - max_exact)
    ).to(torch.int64)
    val_if_large = val_if_large.clamp_max(num_buckets - 1)
    return ret + torch.where(is_small, n, val_if_large)


class T5LayerNorm(nn.Module):
    def __init__(self, features: int, device=None, dtype=torch.float32, param_dtype=None):
        super().__init__()
        self.weight = new_param(features, device=device, dtype=param_dtype or dtype)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.weight.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.float32)
        var = xf.square().mean(dim=-1, keepdim=True)
        return (self.weight.float() * (xf * torch.rsqrt(var + 1e-6))).to(x.dtype)


class T5SelfAttention(nn.Module):
    tp = None

    def __init__(self, cfg: T5Config, device=None, dtype=torch.float32, param_dtype=None):
        super().__init__()
        inner = cfg.num_heads * cfg.d_kv
        self.cfg = cfg
        kw = dict(device=device, dtype=dtype, param_dtype=param_dtype)
        self.q = Dense(cfg.d_model, inner, **kw)
        self.k = Dense(cfg.d_model, inner, **kw)
        self.v = Dense(cfg.d_model, inner, **kw)
        self.o = Dense(inner, cfg.d_model, **kw)

    def forward(self, x, position_bias, mask_bias):
        cfg = self.cfg
        b, t, _ = x.shape
        if self.tp is not None:
            x = copy_to(x, self.tp)
        q = self.q(x).reshape(b, t, -1, cfg.d_kv)
        k = self.k(x).reshape(b, t, -1, cfg.d_kv)
        v = self.v(x).reshape(b, t, -1, cfg.d_kv)
        scores = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) + position_bias
        if mask_bias is not None:
            scores = scores + mask_bias
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        out = torch.einsum("bhts,bshd->bthd", probs, v).reshape(b, t, -1)
        return self.o(out) if self.tp is None else reduce_from(self.o(out), self.tp)


class T5FeedForward(nn.Module):
    tp = None

    def __init__(self, cfg: T5Config, device=None, dtype=torch.float32, param_dtype=None):
        super().__init__()
        self.gated = cfg.is_gated_act
        self.act = _ACTS[cfg.dense_act_fn]
        self.rate = cfg.dropout_rate
        self.d_ff = cfg.d_ff
        kw = dict(device=device, dtype=dtype, param_dtype=param_dtype)
        if self.gated:
            self.wi_0 = Dense(cfg.d_model, cfg.d_ff, **kw)
            self.wi_1 = Dense(cfg.d_model, cfg.d_ff, **kw)
        else:
            self.wi = Dense(cfg.d_model, cfg.d_ff, **kw)
        self.wo = Dense(cfg.d_ff, cfg.d_model, **kw)

    def forward(self, x, key: Optional[int] = None):
        cols = None
        if self.tp is not None:
            x = copy_to(x, self.tp)
            cols = (self.d_ff, self.tp.span(self.d_ff).start)
        if self.gated:
            h = self.act(self.wi_0(x)) * self.wi_1(x)
        else:
            h = self.act(self.wi(x))
        y = self.wo(dropout(h, self.rate, key, cols))
        return y if self.tp is None else reduce_from(y, self.tp)


class T5Block(nn.Module):
    def __init__(self, cfg: T5Config, device=None, dtype=torch.float32, param_dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, param_dtype=param_dtype)
        self.ln_attn = T5LayerNorm(cfg.d_model, **kw)
        self.attention = T5SelfAttention(cfg, **kw)
        self.ln_ff = T5LayerNorm(cfg.d_model, **kw)
        self.ff = T5FeedForward(cfg, **kw)
        self.rate = cfg.dropout_rate

    def forward(self, x, position_bias, mask_bias, key: Optional[int] = None):
        h = self.attention(self.ln_attn(x), position_bias, mask_bias)
        x = x + dropout(h, self.rate, fold_in(key, "attention"))
        h = self.ff(self.ln_ff(x), fold_in(key, "ff_hidden"))
        return x + dropout(h, self.rate, fold_in(key, "ff"))


class T5Encoder(nn.Module):
    """input_ids (B, T) -> last_hidden_state (B, T, d_model). `tp_heads`:
    the model group whose heads this rank runs; `tp`: the same group when it
    shards the embedding's rows."""

    tp = None
    tp_heads = None

    def __init__(self, config: T5Config, device=None, dtype=torch.float32, param_dtype=None):
        super().__init__()
        self.config = config
        self.dtype = dtype
        kw = dict(device=device, dtype=dtype, param_dtype=param_dtype)
        self.shared_embedding = new_param(config.vocab_size, config.d_model,
                                          device=device, dtype=param_dtype or dtype)
        self.relative_attention_bias = new_param(
            config.relative_attention_num_buckets, config.num_heads,
            device=device, dtype=torch.float32,
        )
        self.block = nn.ModuleList(T5Block(config, **kw) for _ in range(config.num_layers))
        self.final_layer_norm = T5LayerNorm(config.d_model, **kw)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.shared_embedding.normal_(0.0, 1.0, generator=generator)
        self.relative_attention_bias.normal_(0.0, 1.0, generator=generator)

    def forward(self, input_ids: torch.Tensor, attention_mask: Optional[torch.Tensor] = None,
                dropout_key: Optional[int] = None):
        """`dropout_key=None` runs deterministically (no dropout)."""
        cfg = self.config
        if self.tp is None:
            x = F.embedding(input_ids, self.shared_embedding).to(self.dtype)
        else:
            x = vocab_embedding(input_ids, self.shared_embedding, self.tp).to(self.dtype)
        x = dropout(x, cfg.dropout_rate, fold_in(dropout_key, "embed"))
        t = input_ids.shape[-1]
        ctx = torch.arange(t, device=input_ids.device)
        rel_pos = ctx[None, :] - ctx[:, None]  # memory - query
        buckets = relative_position_bucket(
            rel_pos, cfg.relative_attention_num_buckets, cfg.relative_attention_max_distance
        )
        table = self.relative_attention_bias
        if self.tp_heads is not None:  # the rank's heads; each rank's gradient summed
            table = copy_to(table, self.tp_heads)[:, self.tp_heads.span(cfg.num_heads)]
        position_bias = table[buckets].permute(2, 0, 1)[None]
        mask_bias = None
        if attention_mask is not None:
            fmin = torch.finfo(torch.float32).min
            mask_bias = torch.zeros(attention_mask.shape, dtype=torch.float32,
                                    device=input_ids.device)
            mask_bias = mask_bias.masked_fill(~attention_mask.to(torch.bool), fmin)
            mask_bias = mask_bias[:, None, None, :]
        for i, block in enumerate(self.block):
            x = block(x, position_bias, mask_bias, fold_in(dropout_key, "block", i))
        return dropout(self.final_layer_norm(x), cfg.dropout_rate, fold_in(dropout_key, "final"))




def convert_t5_encoder_params(tensors: Mapping[str, torch.Tensor], config: T5Config,
                              prefix: str = "") -> Dict:
    """An HF `T5EncoderModel` state dict -> the `T5Encoder` tree (tensors;
    kernels are transposed views). `prefix` is `text_encoder.` inside a
    composite Parler checkpoint."""

    def kernel(name):
        return {"kernel": tensors[prefix + name].t()}

    params: Dict = {
        "shared_embedding": tensors[prefix + "shared.weight"],
        "relative_attention_bias": tensors[
            prefix + "encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight"],
        "final_layer_norm": {"weight": tensors[prefix + "encoder.final_layer_norm.weight"]},
    }
    ff = ("wi_0", "wi_1", "wo") if config.is_gated_act else ("wi", "wo")
    for i in range(config.num_layers):
        bp = f"encoder.block.{i}."
        params[f"block_{i}"] = {
            "ln_attn": {"weight": tensors[prefix + bp + "layer.0.layer_norm.weight"]},
            "attention": {name: kernel(bp + f"layer.0.SelfAttention.{name}.weight")
                          for name in ("q", "k", "v", "o")},
            "ln_ff": {"weight": tensors[prefix + bp + "layer.1.layer_norm.weight"]},
            "ff": {name: kernel(bp + f"layer.1.DenseReluDense.{name}.weight") for name in ff},
        }
    return params
