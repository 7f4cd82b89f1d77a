"""The composite Parler-TTS model: T5 text encoder + codec-token decoder
(port of `parler_tts_tpu/models/parler.py`).

The module owns the neural composition: description encoding, prompt
embedding, the two prompt-conditioning modes, the decoder with its heads,
and the teacher-forced training forward (`forward`). The generation loop and
the codec live in `runtime/` and `codec/`, the train step in `training/`.

Prompt conditioning:
  - default: prompt embeddings are prepended to the decoder input embeds;
  - `prompt_cross_attention=True`: prompt embeddings plus sinusoidal
    positions are concatenated to the encoder states for cross-attention.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import torch
from torch import nn

from ..config import ParlerTTSConfig
from ..convert import as_tensor, load_jax_params, tensor_tree
from ..ops.losses import shift_tokens_right
from ..ops.masks import dense_self_attention_bias, padding_cross_attention_bias
from ..ops.positions import sinusoidal_embed, sinusoidal_table
from ..parallel.collectives import SeqShare, gather_rows, previous_last
from .decoder import ParlerForCausalLM
from .layers import Dense, Embed, fold_in
from .t5_encoder import T5Encoder, convert_t5_encoder_params


class ParlerTTS(nn.Module):
    """`dtype` is the compute dtype, `param_dtype` (default `dtype`) the
    parameters' (the training recipe keeps fp32 parameters under bf16
    compute). `weight_quant=True`: int8 weight-only decoder layers over
    kernel K2 (`models/decoder.py:QuantDense`), `"xla"`: the same parameters
    over a plain matmul; the parameters then follow
    `utils.quantize.quantize_decoder_params`. `fused_qkv=True`: one q|k|v
    projection per decoder self-attention, parameters as `fuse_qkv_params`
    lays them out. `use_chunked_attention` (False | True | int | "pallas"),
    `remat_layers` and `remat_policy` (None or "dots") shape the training
    forward as in the JAX package.

    `parallel.mesh.shard_params(model, mesh)` slices the parameters to a
    rank's shards in place and sets `mesh` and `shard_specs` (the plan per
    parameter); `model_shards` is then the `model` axis's size. Over a mesh
    with a `seq` axis `forward` is sequence-parallel (its docstring)."""

    mesh = None
    shard_specs = None

    def __init__(self, config: ParlerTTSConfig, device=None, dtype=torch.float32,
                 weight_quant: Any = False, param_dtype=None,
                 use_chunked_attention: Any = False, remat_layers: bool = False,
                 fused_qkv: bool = False, remat_policy: Optional[str] = None):
        super().__init__()
        self.config = config
        self.dtype = dtype
        self.param_dtype = param_dtype or dtype
        self.weight_quant = weight_quant
        self.fused_qkv = fused_qkv
        self.use_chunked_attention = use_chunked_attention
        self.remat_layers = remat_layers
        self.remat_policy = remat_policy
        dcfg = config.decoder
        self.text_encoder = T5Encoder(config.text_encoder, device=device, dtype=dtype,
                                      param_dtype=param_dtype)
        self.decoder = ParlerForCausalLM(dcfg, device=device, dtype=dtype,
                                         weight_quant=weight_quant, param_dtype=param_dtype,
                                         use_chunked_attention=use_chunked_attention,
                                         remat_layers=remat_layers, fused_qkv=fused_qkv,
                                         remat_policy=remat_policy)
        self.embed_prompts = Embed(config.vocab_size, dcfg.hidden_size,
                                   std=dcfg.initializer_factor, device=device, dtype=dtype,
                                   param_dtype=param_dtype)
        self.needs_proj = (
            config.text_encoder.d_model != dcfg.hidden_size
            and dcfg.cross_attention_hidden_size is None
        )
        if self.needs_proj:
            self.enc_to_dec_proj = Dense(config.text_encoder.d_model, dcfg.hidden_size,
                                         bias=True, device=device, dtype=dtype,
                                         param_dtype=param_dtype)

    @property
    def model_shards(self) -> int:
        return 1 if self.mesh is None else self.mesh.model.size

    def encode_description(self, input_ids: torch.Tensor,
                           attention_mask: Optional[torch.Tensor],
                           dropout_key: Optional[int] = None) -> torch.Tensor:
        """T5 -> optional projection -> zero the masked positions."""
        enc = self.text_encoder(input_ids, attention_mask, dropout_key)
        if self.needs_proj:
            enc = self.enc_to_dec_proj(enc)
        if attention_mask is not None:
            enc = enc * attention_mask[..., None].to(enc.dtype)
        return enc

    def prompt_hidden(self, prompt_ids: torch.Tensor) -> torch.Tensor:
        return self.embed_prompts(prompt_ids)

    def build_encoder_states(
        self,
        encoder_hidden: torch.Tensor,
        attention_mask: Optional[torch.Tensor],
        prompt_hidden: Optional[torch.Tensor],
        prompt_mask: Optional[torch.Tensor],
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """In prompt_cross_attention mode, concatenate the prompt (+ sinusoidal
        positions) onto the encoder states; otherwise pass them through."""
        cfg = self.config
        if not cfg.prompt_cross_attention or prompt_hidden is None:
            return encoder_hidden, attention_mask
        device = prompt_hidden.device
        table = sinusoidal_table(cfg.decoder.max_position_embeddings,
                                 cfg.decoder.hidden_size, prompt_hidden.dtype, device)
        pos = torch.arange(prompt_hidden.shape[1], device=device)
        prompt_hidden = prompt_hidden + sinusoidal_embed(table, pos)[None]
        if prompt_mask is not None and attention_mask is None:
            attention_mask = torch.ones(encoder_hidden.shape[:2], dtype=torch.int32,
                                        device=device)
        elif attention_mask is not None and prompt_mask is None:
            prompt_mask = torch.ones(prompt_hidden.shape[:2], dtype=torch.int32, device=device)
        states = torch.cat([encoder_hidden, prompt_hidden], dim=1)
        mask = (
            torch.cat([attention_mask.to(torch.int32), prompt_mask.to(torch.int32)], dim=1)
            if attention_mask is not None
            else None
        )
        return states, mask

    def forward(
        self,
        input_ids: torch.Tensor,                        # (B, S_desc) description ids
        attention_mask: Optional[torch.Tensor],         # (B, S_desc)
        prompt_input_ids: torch.Tensor,                 # (B, S_p)
        prompt_attention_mask: Optional[torch.Tensor],  # (B, S_p)
        labels: torch.Tensor,                           # (B, T, K), -100 = padding
        deterministic: bool = True,
        return_hidden: bool = False,
        dropout_key: Optional[int] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Teacher-forced forward: (logits (B, K, T, V) fp32, decoder_input_ids
        (B, K, T)). With `return_hidden=True` the heads are not applied and the
        first element is the pre-head hidden states (B, T, D), for the chunked
        fused-head loss. `deterministic=False` runs dropout and LayerDrop,
        drawn from `dropout_key` (an int, the step's seed).

        T5-encode, embed the prompt, shift the labels right, decode over
        [prompt prefix, labels] (default mode) at absolute positions, and drop
        the prefix from the output.

        Over a mesh with a `seq` axis, `labels` are this rank's share of the
        label columns (`parallel.mesh.local_seq_slice`), and so are the
        outputs: the shift takes its first column from the previous rank's
        last label column, rank 0 of `seq` holds the prompt prefix (so the
        whole sequence, gathered in rank order, is [prompt; frames]), every
        rank decodes its rows at their absolute positions against the
        gathered keys, and the T5 encoder and the cross-attention run whole on
        every rank."""
        cfg = self.config
        dcfg = cfg.decoder
        if not deterministic and dropout_key is None:
            raise ValueError("deterministic=False needs a dropout_key")
        key = None if deterministic else dropout_key
        seq = self.mesh.seq if self.mesh is not None and self.mesh.seq.size > 1 else None
        enc = self.encode_description(input_ids, attention_mask, fold_in(key, "text_encoder"))
        prompt = self.prompt_hidden(prompt_input_ids)
        first_column = None if seq is None else previous_last(labels, seq)
        decoder_input_ids = shift_tokens_right(labels, cfg.pad_token_id,
                                               cfg.decoder_start_token_id, first_column)
        dec_embeds = self.decoder.embed_ids(decoder_input_ids)
        b, t, _ = dec_embeds.shape
        device = dec_embeds.device
        enc_states, enc_mask = self.build_encoder_states(enc, attention_mask, prompt,
                                                         prompt_attention_mask)
        ones = torch.ones((b, t), dtype=torch.int32, device=device)
        # under `seq` rank 0 of the axis holds the prompt prefix and its first
        # frames, so the gathered sequence is [prompt; frames] in order
        owns_prompt = seq is None or seq.rank == 0
        s_p = 0 if cfg.prompt_cross_attention else prompt.shape[1]
        if s_p and owns_prompt:
            full_embeds = torch.cat([prompt.to(dec_embeds.dtype), dec_embeds], dim=1)
            if prompt_attention_mask is None:
                prompt_attention_mask = torch.ones(prompt.shape[:2], dtype=torch.int32,
                                                   device=device)
            dec_mask = torch.cat([prompt_attention_mask.to(torch.int32), ones], dim=1)
        else:
            full_embeds, dec_mask = dec_embeds, ones
        share = None if seq is None else SeqShare(seq, (s_p + t,) + (t,) * (seq.size - 1))
        first = 0 if share is None else share.first
        full_t = s_p + t if share is None else share.total
        if full_t > dcfg.max_position_embeddings:
            raise ValueError(
                f"decoder sequence (prompt {s_p} + frames {full_t - s_p} = {full_t}) exceeds "
                f"max_position_embeddings={dcfg.max_position_embeddings}"
            )
        rows = full_embeds.shape[1]
        key_mask = dec_mask if share is None else gather_rows(dec_mask, share)
        # absolute positions in every mode: masked prompt tokens count
        position_ids = torch.arange(first, first + rows, device=device)[None, :].expand(b, rows)
        chunked = bool(self.use_chunked_attention)
        hidden = self.decoder.decoder(
            full_embeds, position_ids,
            self_attn_bias=None if chunked else dense_self_attention_bias(key_mask)[
                :, :, first:first + rows],
            cross_attn_bias=padding_cross_attention_bias(enc_mask, rows),
            encoder_hidden_states=enc_states,
            mask_1d=key_mask if chunked else None,
            dropout_key=fold_in(key, "decoder"),
            seq=share,
        )
        hidden = hidden[:, rows - t:]
        if return_hidden:
            return hidden, decoder_input_ids
        return self.decoder.logits(hidden), decoder_input_ids


def convert_composite_params(tensors: Mapping[str, torch.Tensor], config: ParlerTTSConfig
                             ) -> Dict:
    """A composite HF checkpoint's tensors -> the `ParlerTTS` tree."""
    from ..utils.hf_bridge import convert_decoder_params

    params: Dict = {
        "text_encoder": convert_t5_encoder_params(tensors, config.text_encoder,
                                                  prefix="text_encoder."),
        "decoder": convert_decoder_params(tensors, config.decoder,
                                          prefix="decoder.model.decoder.",
                                          lm_head_prefix="decoder."),
        "embed_prompts": {"embedding": tensors["embed_prompts.weight"]},
    }
    if "enc_to_dec_proj.weight" in tensors:
        params["enc_to_dec_proj"] = {"kernel": tensors["enc_to_dec_proj.weight"].t(),
                                     "bias": tensors["enc_to_dec_proj.bias"]}
    return params


def fuse_qkv_params(params: Mapping) -> Dict:
    """The tree of a `fused_qkv=True` model: each decoder layer's
    self-attention q/k/v kernels concatenated (bias-free) into one
    `qkv_proj` kernel along the output axis; `encoder_attn` and every other
    leaf untouched. Leaves may be arrays or tensors; the concatenation is a
    tensor on the kernels' device."""
    out = {}
    for key, value in params.items():
        if key == "self_attn" and isinstance(value, Mapping) and "q_proj" in value:
            out[key] = {k: v for k, v in value.items() if k not in ("q_proj", "k_proj", "v_proj")}
            out[key]["qkv_proj"] = {"kernel": torch.cat(
                [as_tensor(value[n]["kernel"]) for n in ("q_proj", "k_proj", "v_proj")], dim=1)}
        elif isinstance(value, Mapping):
            out[key] = fuse_qkv_params(value)
        else:
            out[key] = value
    return out


def fused_qkv_model(model: ParlerTTS) -> ParlerTTS:
    """A `fused_qkv=True` copy of a float `ParlerTTS`, on its device and in its
    dtypes, its kernels fused on the device; `model` is left as it is."""
    if model.weight_quant:
        # quantized projections hold w_q and per-channel scales, not kernels
        raise ValueError("fused_qkv does not support weight_quant models")
    device = next(model.parameters()).device
    fused = ParlerTTS(model.config, device=device, dtype=model.dtype,
                      param_dtype=model.param_dtype, fused_qkv=True)
    with torch.no_grad():
        load_jax_params(fused, fuse_qkv_params(tensor_tree(model)))
    return fused.eval()
