"""Codec registry (port of `parler_tts_tpu/codec/registry.py`): picks the codec
family from the composite config's `audio_encoder.codec_type`, so the
pipeline, the checkpoint loaders and the training CLI stay codec-agnostic.
Both codecs share one contract: encode (B, T, C) float -> (B, K, T / hop)
int64 codes, decode the inverse."""

from __future__ import annotations

from typing import Any, Dict, Mapping

import torch
from torch import nn

from ..models.layers import init_weights
from .convert import convert_dac_params
from .dac_model import DACModel
from .encodec_model import EncodecCodec, convert_encodec_params


def codec_kind(audio_cfg: Any) -> str:
    return getattr(audio_cfg, "codec_type", "dac")


def codec_channels(audio_cfg: Any) -> int:
    return getattr(audio_cfg, "audio_channels", 1)


def build_codec(audio_cfg: Any, device=None) -> nn.Module:
    """The config's codec module on `device`, its parameters not yet filled
    (`init_codec_params` or `convert.load_jax_dac_params`)."""
    if codec_kind(audio_cfg) == "encodec":
        return EncodecCodec(audio_cfg, device)
    return DACModel(audio_cfg, device)


def init_codec_params(codec: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random codec parameters, encoder and decoder, drawn from `generator`."""
    init_weights(codec, generator)
    return codec


def convert_codec_params(tensors: Mapping[str, torch.Tensor], audio_cfg: Any,
                         prefix: str = "audio_encoder.") -> Dict:
    """A composite HF state dict -> the codec's JAX-named tree. The DAC
    wrapper nests its model under `.model.`; Encodec's tensors sit directly
    under `audio_encoder.`."""
    if codec_kind(audio_cfg) == "encodec":
        return convert_encodec_params(tensors, audio_cfg, prefix=prefix)
    return convert_dac_params(tensors, audio_cfg, prefix=prefix + "model.")
