"""User-facing pipeline: token ids in, waveform out (port of the serving core
of `parler_tts_tpu/runtime/pipeline.py`).

Runs on the GPU unless the caller passes `device="cpu"`: without a GPU the
pipeline raises instead of falling back. It takes id arrays; string input
needs the tokenizer, which the port does not have yet.

Two serving modes of the JAX pipeline: a model built with `weight_quant=True`
(int8 weight-only decoder layers over kernel K2) is served unchanged, and
`fused_decode=True` sends B=1 requests through the fused decode step (kernel
K3, `generate_tokens_fused`) while B>1 requests take the eager loop.

Codec decode is bucketed: the batch's largest valid frame count is rounded up
to `frame_bucket` frames, so the conv stack never runs over the full
max_length grid when the frames end early.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..codec.dac_model import DACModel
from ..config import GenerationConfig, ParlerTTSConfig
from ..models.layers import init_weights
from ..models.parler import ParlerTTS
from ..ops.fused_decode_step import prepare_fused_params
from .generate import GenerateOutput, generate_tokens, generate_tokens_fused


def _round_up(x: int, m: int) -> int:
    return max(m, ((x + m - 1) // m) * m)


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


def _as_ids(x, device) -> Optional[torch.Tensor]:
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int64)
    return torch.as_tensor(np.asarray(x), dtype=torch.int64).to(device)


class ParlerTTSPipeline:
    """End-to-end TTS: (description ids, prompt ids) -> waveform."""

    def __init__(
        self,
        model: ParlerTTS,
        dac: DACModel,
        generation_config: Optional[GenerationConfig] = None,
        frame_bucket: int = 256,
        cache_dtype: torch.dtype = torch.bfloat16,
        device=None,
        fused_decode: bool = False,
    ):
        if fused_decode and getattr(model, "weight_quant", False):
            raise ValueError(
                "fused_decode and weight_quant are exclusive: the fused step quantizes the "
                "float decoder itself (prepare_fused_params)"
            )
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.dac = dac.to(self.device).eval()
        self.config: ParlerTTSConfig = model.config
        self.frame_bucket = frame_bucket
        self.cache_dtype = cache_dtype
        dcfg = model.config.decoder
        self.generation_config = generation_config or GenerationConfig(
            bos_token_id=dcfg.bos_token_id,
            pad_token_id=dcfg.pad_token_id,
            eos_token_id=dcfg.eos_token_id,
        )
        # B=1 requests run the fused decode step over int8 weights stacked once
        self.fused = prepare_fused_params(self.model.decoder.decoder) if fused_decode else None

    @classmethod
    def from_random(
        cls,
        config: ParlerTTSConfig,
        seed: int = 0,
        generation_config: Optional[GenerationConfig] = None,
        device=None,
        dtype: torch.dtype = torch.float32,
        weight_quant: bool = False,
        **kw,
    ) -> "ParlerTTSPipeline":
        """Randomly initialised pipeline, built and filled on the device from a
        `torch.Generator` seeded with `seed` (the codec stays fp32). With
        `weight_quant=True` each decoder projection draws its `dtype` weights
        on the device and quantizes them there to int8."""
        dev = resolve_device(device)
        generator = torch.Generator(device=dev)
        generator.manual_seed(seed)
        model = ParlerTTS(config, device=dev, dtype=dtype, weight_quant=weight_quant)
        init_weights(model, generator)
        dac = DACModel(config.audio_encoder, device=dev)
        init_weights(dac, generator)
        return cls(model, dac, generation_config, device=dev, **kw)

    def generate_codes(
        self,
        desc_ids,
        desc_mask,
        prompt_ids,
        prompt_mask,
        seed: int = 0,
        decoder_prompt_codes=None,
    ) -> GenerateOutput:
        """Token generation; arrays may be numpy or tensors."""
        gen = self.generation_config
        n = gen.num_return_sequences
        ids = [_as_ids(x, self.device) for x in
               (desc_ids, desc_mask, prompt_ids, prompt_mask, decoder_prompt_codes)]
        if n > 1:
            if not gen.do_sample:
                raise ValueError(
                    "num_return_sequences > 1 requires do_sample=True "
                    "(greedy search returns one sequence per input)"
                )
            ids = [None if x is None else x.repeat_interleave(n, dim=0) for x in ids]
        generator = torch.Generator(device=self.device)
        generator.manual_seed(seed)
        if self.fused is not None and ids[0].shape[0] == 1:
            return generate_tokens_fused(
                self.model, gen, self.fused, ids[0], ids[1], ids[2], ids[3], generator,
                decoder_prompt_codes=ids[4],
            )
        return generate_tokens(
            self.model, gen, ids[0], ids[1], ids[2], ids[3], generator,
            decoder_prompt_codes=ids[4], cache_dtype=self.cache_dtype,
        )

    @torch.inference_mode()
    def decode_codes(self, codes: torch.Tensor, lengths: torch.Tensor
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """Bucketed DAC decode: (B, K, T) codes -> (B, samples) waveform and
        sample lengths."""
        hop = self.config.audio_encoder.hop_length
        lengths = lengths.cpu().numpy().astype(np.int64)
        b = codes.shape[0]
        max_frames = int(lengths.max()) if b else 0
        if max_frames == 0:
            return np.zeros((b, hop), np.float32), np.zeros((b,), np.int64)
        bucket = min(_round_up(max_frames, self.frame_bucket), codes.shape[-1])
        # invalid tail ids would index past the codebooks; clamp them (those
        # samples are cut by `lengths`)
        sliced = codes[:, :, :bucket].clamp(0, self.config.audio_encoder.codebook_size - 1)
        audio = self.dac.decode(sliced.to(self.device)).float()  # (B, T*hop, 1)
        return audio[:, :, 0].cpu().numpy(), lengths * hop

    def generate(
        self,
        description,
        prompt,
        desc_mask=None,
        prompt_mask=None,
        seed: int = 0,
        decoder_prompt_codes=None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """(waveform (B, samples), audio lengths (B,)) from token-id arrays."""
        for name, x in (("description", description), ("prompt", prompt)):
            if isinstance(x, (str, list, tuple)):
                raise TypeError(
                    f"{name}: pass token ids; text input needs a tokenizer, which "
                    "parler_tts_tpu_torch does not have yet"
                )
        out = self.generate_codes(description, desc_mask, prompt, prompt_mask, seed,
                                  decoder_prompt_codes=decoder_prompt_codes)
        return self.decode_codes(out.codes, out.lengths)
