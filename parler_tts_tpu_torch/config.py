"""Immutable configuration tree (own copy of `parler_tts_tpu/config.py`).

Same fields and defaults as the JAX package's dataclasses, so a config built
for one package describes the same model in the other. Token-id layout:
pad == eos == codebook_size (1024 for DAC), bos == codebook_size + 1, decoder
vocab_size rounded up to a multiple of 64 (1088), embedding tables get
vocab_size + 1 rows so the bos id (1025) is addressable.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class T5Config:
    """Encoder-only Flan-T5 config (the frozen description encoder)."""

    vocab_size: int = 32128
    d_model: int = 1024
    d_kv: int = 64
    d_ff: int = 2816
    num_layers: int = 24
    num_heads: int = 16
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6
    feed_forward_proj: str = "gated-gelu"  # flan-t5 uses gated gelu
    dropout_rate: float = 0.1

    @property
    def is_gated_act(self) -> bool:
        return self.feed_forward_proj.startswith("gated-")

    @property
    def dense_act_fn(self) -> str:
        act = self.feed_forward_proj
        return act[len("gated-"):] if act.startswith("gated-") else act


@dataclass(frozen=True)
class DACConfig:
    """Descript audio codec config."""

    num_codebooks: int = 9
    codebook_size: int = 1024
    codebook_dim: int = 8
    latent_dim: int = 1024
    frame_rate: int = 86
    sampling_rate: int = 44100
    encoder_dim: int = 64
    encoder_rates: Tuple[int, ...] = (2, 4, 8, 8)
    decoder_dim: int = 1536
    decoder_rates: Tuple[int, ...] = (8, 8, 4, 2)
    codec_type: str = "dac"

    @property
    def hop_length(self) -> int:
        hop = 1
        for r in self.encoder_rates:
            hop *= r
        return hop


@dataclass(frozen=True)
class DecoderConfig:
    """AR codec-token decoder config."""

    vocab_size: int = 1088
    max_position_embeddings: int = 4096
    num_hidden_layers: int = 24
    ffn_dim: int = 4096
    num_attention_heads: int = 16
    num_key_value_heads: Optional[int] = None
    num_cross_attention_key_value_heads: Optional[int] = None
    activation_function: str = "gelu"
    hidden_size: int = 1024
    dropout: float = 0.1
    attention_dropout: float = 0.0
    activation_dropout: float = 0.0
    initializer_factor: float = 0.02
    layerdrop: float = 0.0
    scale_embedding: bool = False
    num_codebooks: int = 9
    pad_token_id: int = 1024
    bos_token_id: int = 1025
    eos_token_id: int = 1024
    tie_word_embeddings: bool = False
    rope_embeddings: bool = False
    rope_theta: float = 10000.0
    sliding_window: Optional[int] = None
    use_fused_lm_heads: bool = False
    codebook_weights: Optional[Tuple[float, ...]] = None
    cross_attention_hidden_size: Optional[int] = None

    def __post_init__(self):
        if self.num_key_value_heads is None:
            object.__setattr__(self, "num_key_value_heads", self.num_attention_heads)
        if self.num_cross_attention_key_value_heads is None:
            object.__setattr__(
                self, "num_cross_attention_key_value_heads", self.num_key_value_heads
            )
        if self.codebook_weights is not None:
            if len(self.codebook_weights) != self.num_codebooks:
                raise ValueError(
                    f"`codebook_weights` has length {len(self.codebook_weights)} when it "
                    f"should be of length {self.num_codebooks}."
                )
            object.__setattr__(self, "codebook_weights", tuple(self.codebook_weights))

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def embed_rows(self) -> int:
        # +1 row so the bos id (vocab_size + 1 in the v1 token layout) is addressable
        return self.vocab_size + 1


@dataclass(frozen=True)
class ParlerTTSConfig:
    """Composite config: text encoder + codec + decoder. `audio_encoder` is a
    `DACConfig` or an `EncodecCodecConfig` (`codec/encodec_model.py`),
    told apart by its `codec_type`."""

    text_encoder: T5Config = field(default_factory=T5Config)
    audio_encoder: DACConfig = field(default_factory=DACConfig)
    decoder: DecoderConfig = field(default_factory=DecoderConfig)
    vocab_size: int = 32128  # prompt-token vocab (shared tokenizer with text encoder)
    prompt_cross_attention: bool = False
    pad_token_id: int = 1024
    decoder_start_token_id: int = 1025

    @property
    def sampling_rate(self) -> int:
        return self.audio_encoder.sampling_rate

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, text: str) -> "ParlerTTSConfig":
        """The inverse of `to_json`, lists back to tuples; reads the JSON the
        JAX package's `ParlerTTSConfig.to_json` writes too."""
        raw = json.loads(text)
        ae_raw = _tuples(raw["audio_encoder"])
        if ae_raw.get("codec_type", "dac") == "encodec":
            # imported here: the codec modules import this module
            from .codec.encodec_model import EncodecCodecConfig

            audio_encoder = EncodecCodecConfig(**ae_raw)
        else:
            audio_encoder = DACConfig(**ae_raw)
        return cls(
            text_encoder=T5Config(**raw["text_encoder"]),
            audio_encoder=audio_encoder,
            decoder=DecoderConfig(**_tuples(raw["decoder"])),
            **{k: v for k, v in raw.items()
               if k not in ("text_encoder", "audio_encoder", "decoder")},
        )


def _tuples(fields: dict) -> dict:
    return {k: tuple(v) if isinstance(v, list) else v for k, v in fields.items()}


@dataclass(frozen=True)
class GenerationConfig:
    """Generation knobs."""

    max_length: int = 2580  # 30 s at 86 fps
    min_new_tokens: int = 0
    do_sample: bool = True
    temperature: float = 1.0
    top_k: int = 0  # 0 = disabled
    top_p: float = 1.0  # 1.0 = disabled
    bos_token_id: int = 1025
    pad_token_id: int = 1024
    eos_token_id: int = 1024
    # When set, only ids < codebook_guard (plus EOS) can be sampled, so every
    # emitted frame is codec-decodable (random weights need it).
    codebook_guard: Optional[int] = None
    # "static" or "sliding_window": with "sliding_window" the decoder's
    # self-attention sees only the last `decoder.sliding_window` positions
    cache_implementation: str = "static"
    # samples per input row; inputs are repeated at the pipeline boundary
    num_return_sequences: int = 1


def dummy_decoder_config(**overrides: Any) -> DecoderConfig:
    """Tiny test-scale decoder (4 layers / 512 hidden / 8 heads)."""
    base = dict(
        vocab_size=1088,
        max_position_embeddings=1024,
        num_hidden_layers=4,
        ffn_dim=512,
        num_attention_heads=8,
        hidden_size=512,
        num_codebooks=9,
        pad_token_id=1024,
        bos_token_id=1025,
        eos_token_id=1024,
    )
    base.update(overrides)
    return DecoderConfig(**base)


def mini_v1_decoder_config(**overrides: Any) -> DecoderConfig:
    """parler-tts-mini-v1 decoder: 24 layers, hidden 1024, 16 heads, FFN 4096."""
    base = dict(
        vocab_size=_round_up(1024, 64) + 64,  # 1088
        max_position_embeddings=4096,
        num_hidden_layers=24,
        ffn_dim=4096,
        num_attention_heads=16,
        hidden_size=1024,
        num_codebooks=9,
        pad_token_id=1024,
        bos_token_id=1025,
        eos_token_id=1024,
    )
    base.update(overrides)
    return DecoderConfig(**base)


def large_v1_decoder_config(**overrides: Any) -> DecoderConfig:
    """parler-tts-large-v1 decoder: 30 layers, hidden 1536, 24 heads, FFN 6144.
    Its composite is `ParlerTTSConfig(decoder=large_v1_decoder_config())`: the
    default text encoder is flan-t5-large and the codec the 44.1 kHz DAC."""
    base = dict(
        vocab_size=1088,
        max_position_embeddings=4096,
        num_hidden_layers=30,
        ffn_dim=6144,
        num_attention_heads=24,
        hidden_size=1536,
        num_codebooks=9,
        pad_token_id=1024,
        bos_token_id=1025,
        eos_token_id=1024,
    )
    base.update(overrides)
    return DecoderConfig(**base)


def mini_v1_config() -> ParlerTTSConfig:
    """parler-tts-mini-v1: flan-t5-base encoder, mini-v1 decoder, 44.1 kHz DAC."""
    return ParlerTTSConfig(
        text_encoder=T5Config(
            vocab_size=32128, d_model=768, d_kv=64, d_ff=2048,
            num_layers=12, num_heads=12, dropout_rate=0.0,
        ),
        audio_encoder=DACConfig(),
        decoder=mini_v1_decoder_config(),
        vocab_size=32128,
        pad_token_id=1024,
        decoder_start_token_id=1025,
    )
