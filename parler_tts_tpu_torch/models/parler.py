"""The composite Parler-TTS model: T5 text encoder + codec-token decoder
(port of `parler_tts_tpu/models/parler.py`, serving side).

The module owns the neural composition: description encoding, prompt
embedding, the two prompt-conditioning modes and the decoder with its heads.
The generation loop and the codec live in `runtime/` and `codec/`.

Prompt conditioning:
  - default: prompt embeddings are prepended to the decoder input embeds;
  - `prompt_cross_attention=True`: prompt embeddings plus sinusoidal
    positions are concatenated to the encoder states for cross-attention.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
from torch import nn

from ..config import ParlerTTSConfig
from ..ops.positions import sinusoidal_embed, sinusoidal_table
from .decoder import ParlerForCausalLM
from .layers import Dense, Embed
from .t5_encoder import T5Encoder


class ParlerTTS(nn.Module):
    """`weight_quant=True`: int8 weight-only decoder layers over kernel K2
    (`models/decoder.py:QuantDense`); the parameters then follow
    `utils.quantize.quantize_decoder_params`."""

    def __init__(self, config: ParlerTTSConfig, device=None, dtype=torch.float32,
                 weight_quant: Any = False):
        super().__init__()
        self.config = config
        self.weight_quant = weight_quant
        dcfg = config.decoder
        self.text_encoder = T5Encoder(config.text_encoder, device=device, dtype=dtype)
        self.decoder = ParlerForCausalLM(dcfg, device=device, dtype=dtype,
                                         weight_quant=weight_quant)
        self.embed_prompts = Embed(config.vocab_size, dcfg.hidden_size,
                                   std=dcfg.initializer_factor, device=device, dtype=dtype)
        self.needs_proj = (
            config.text_encoder.d_model != dcfg.hidden_size
            and dcfg.cross_attention_hidden_size is None
        )
        if self.needs_proj:
            self.enc_to_dec_proj = Dense(config.text_encoder.d_model, dcfg.hidden_size,
                                         bias=True, device=device, dtype=dtype)

    def encode_description(self, input_ids: torch.Tensor,
                           attention_mask: Optional[torch.Tensor]) -> torch.Tensor:
        """T5 -> optional projection -> zero the masked positions."""
        enc = self.text_encoder(input_ids, attention_mask)
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
