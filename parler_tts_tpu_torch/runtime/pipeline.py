"""User-facing pipeline: text or token ids in, waveform out (port of the
serving core of `parler_tts_tpu/runtime/pipeline.py`).

Runs on the GPU unless the caller passes `device="cpu"`: without a GPU the
pipeline raises instead of falling back. Text goes through the tokenizer the
caller passes (a callable mapping a list of strings to
`{"input_ids": [[int, ...], ...]}`); the port imports no tokenizer library.

Checkpoints: `from_pretrained` reads a directory in either layout the JAX
package reads (native: `config.json` + pickled numpy trees; HF:
`config.json` + `.safetensors`, read without the safetensors package), and
`save_pretrained` writes the native layout, which the JAX package loads.

Serving modes of the JAX pipeline: a model built with `weight_quant=True`
(int8 weight-only decoder layers over kernel K2) or `"xla"` (the same int8
weights over a plain matmul) is served unchanged; `fused_decode=True` sends
B=1 requests through the fused decode step (kernel K3,
`generate_tokens_fused`) while B>1 requests take the eager loop;
`fused_qkv=True` serves a copy of the model with one q|k|v matmul per
decoder layer; `codec_dtype` keeps a copy of the codec's weights in that
dtype for decoding (the audio stays fp32).

Codec decode is bucketed: the batch's largest valid frame count is rounded up
to `frame_bucket` frames, so the conv stack never runs over the full
max_length grid when the frames end early.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import pickle
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch

from ..codec.convert import convert_dac_params
from ..codec.dac_model import DACModel
from ..config import GenerationConfig, ParlerTTSConfig
from ..convert import dac_to_jax_tree, load_jax_dac_params, load_jax_params, to_jax_tree
from ..models.layers import init_weights
from ..models.parler import ParlerTTS, convert_composite_params, fused_qkv_model
from ..ops.fused_decode_step import prepare_fused_params
from ..utils.quantize import quantize_decoder_params_torch
from .checkpoint import load_hf_config, load_safetensors_dir
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


class _ArrayUnpickler(pickle.Unpickler):
    """Unpickles nested dicts, lists and numpy arrays only: a checkpoint's
    pickles cannot name any other class or function to run."""

    def find_class(self, module, name):
        if module.split(".")[0] == "numpy" and name in (
                "_reconstruct", "ndarray", "dtype", "scalar", "_frombuffer"):
            return super().find_class(module, name)
        raise pickle.UnpicklingError(f"a checkpoint pickle may not load {module}.{name}")


def _load_pickle(filename: str):
    with open(filename, "rb") as f:
        return _ArrayUnpickler(f).load()


class ParlerTTSPipeline:
    """End-to-end TTS: (description, prompt) -> waveform.

        pipe = ParlerTTSPipeline.from_pretrained(path, dtype=torch.bfloat16,
                                                 tokenizer=tokenizer)
        audio, lengths = pipe.generate(["a calm female voice"], ["Hello world"])
    """

    def __init__(
        self,
        model: ParlerTTS,
        dac: DACModel,
        generation_config: Optional[GenerationConfig] = None,
        tokenizer: Any = None,
        frame_bucket: int = 256,
        pad_to_multiple: int = 16,
        cache_dtype: torch.dtype = torch.bfloat16,
        device=None,
        fused_decode: bool = False,
        fused_qkv: bool = False,
        codec_dtype: Optional[torch.dtype] = None,
    ):
        if fused_decode and model.weight_quant:
            raise ValueError(
                "fused_decode and weight_quant are exclusive: the fused step quantizes the "
                "float decoder itself (prepare_fused_params)"
            )
        if fused_qkv and fused_decode:
            raise ValueError("fused_qkv and fused_decode are exclusive")
        self.device = resolve_device(device)
        model = model.to(self.device).eval()
        # serving transform: one q|k|v matmul per decoder layer, on a copy
        self.model = fused_qkv_model(model) if fused_qkv else model
        self.dac = dac.to(self.device).eval()
        # the codec's weights in `codec_dtype` for decoding (it computes in fp32)
        self.dac_decode = (self.dac if codec_dtype is None
                           else copy.deepcopy(self.dac).to(codec_dtype))
        self.config: ParlerTTSConfig = model.config
        self.tokenizer = tokenizer
        self.frame_bucket = frame_bucket
        self.pad_to_multiple = pad_to_multiple
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
        weight_quant: Any = False,
        **kw,
    ) -> "ParlerTTSPipeline":
        """Randomly initialised pipeline, built and filled on the device from a
        `torch.Generator` seeded with `seed` (the codec stays fp32). With
        `weight_quant` (True or "xla") each decoder projection draws its
        `dtype` weights on the device and quantizes them there to int8."""
        dev = resolve_device(device)
        generator = torch.Generator(device=dev)
        generator.manual_seed(seed)
        model = ParlerTTS(config, device=dev, dtype=dtype, weight_quant=weight_quant)
        init_weights(model, generator)
        dac = DACModel(config.audio_encoder, device=dev)
        init_weights(dac, generator)
        return cls(model, dac, generation_config, device=dev, **kw)

    @classmethod
    def from_pretrained(
        cls,
        path: str,
        generation_config: Optional[GenerationConfig] = None,
        tokenizer: Any = None,
        device=None,
        dtype: torch.dtype = torch.float32,
        weight_quant: Any = False,
        **kw,
    ) -> "ParlerTTSPipeline":
        """Load a checkpoint directory onto the device, in either layout:

          - native (`params.pkl` present): `config.json` as `to_json` writes
            it, `params.pkl` (the flax-named numpy tree), `dac_params.pkl`
            (the JAX codec's tree; without it the codec is drawn from a
            `torch.Generator` seeded with 0);
          - HF: `config.json` with `text_encoder`/`audio_encoder`/`decoder`
            sections and `*.safetensors` holding `text_encoder.*`,
            `decoder.*`, `embed_prompts.*`, `enc_to_dec_proj.*` and
            `audio_encoder.model.*` (weight-norm folded on load).

        `generation_config.json`, when present and no `generation_config` is
        given, fills the fields `GenerationConfig` knows. The model is built
        in `dtype` (the codec in fp32); with `weight_quant` (True or "xla")
        the loaded decoder kernels are quantized to int8 on the device.
        `tokenizer` is the caller's callable (see the module docstring); the
        other keywords go to `__init__`. The pickles are read by an
        unpickler that admits numpy arrays only."""
        dev = resolve_device(device)
        if os.path.exists(os.path.join(path, "params.pkl")):
            with open(os.path.join(path, "config.json")) as f:
                cfg = ParlerTTSConfig.from_json(f.read())
            params = _load_pickle(os.path.join(path, "params.pkl"))
            dac_path = os.path.join(path, "dac_params.pkl")
            dac_params = _load_pickle(dac_path) if os.path.exists(dac_path) else None
        else:
            cfg = load_hf_config(path)
            tensors = load_safetensors_dir(path)
            params = convert_composite_params(tensors, cfg)
            dac_params = convert_dac_params(tensors, cfg.audio_encoder,
                                            prefix="audio_encoder.model.")
        gen_path = os.path.join(path, "generation_config.json")
        if generation_config is None and os.path.exists(gen_path):
            with open(gen_path) as f:
                raw = json.load(f)
            known = {f.name for f in dataclasses.fields(GenerationConfig)}
            generation_config = GenerationConfig(**{k: v for k, v in raw.items() if k in known})
        model = ParlerTTS(cfg, device=dev, dtype=dtype, weight_quant=weight_quant)
        if weight_quant:
            params = quantize_decoder_params_torch(params, dev)
        load_jax_params(model, params)
        dac = DACModel(cfg.audio_encoder, device=dev)
        if dac_params is None:
            init_weights(dac, torch.Generator(device=dev).manual_seed(0))
        else:
            load_jax_dac_params(dac, dac_params)
        return cls(model, dac, generation_config, tokenizer=tokenizer, device=dev, **kw)

    def save_pretrained(self, path: str) -> None:
        """Write the native layout: `config.json`, `generation_config.json`,
        `params.pkl` (the flax-named tree, numpy fp32) and `dac_params.pkl`
        (the JAX codec's names and layouts, numpy fp32). The port's codec has
        the decode side only, so its `dac_params.pkl` holds no encoder and no
        quantizer `in_proj` leaves (ROADMAP.md, item 16): the JAX package
        loads it and generates codes, but its codec needs those leaves to
        decode. A pipeline serving int8 or fused q|k|v weights raises: save
        the float model it was built from."""
        if self.model.weight_quant or self.model.fused_qkv:
            raise ValueError("save_pretrained writes float, unfused weights; this pipeline "
                             "serves weight_quant or fused_qkv weights")
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "config.json"), "w") as f:
            f.write(self.config.to_json())
        with open(os.path.join(path, "generation_config.json"), "w") as f:
            json.dump(dataclasses.asdict(self.generation_config), f, indent=2)
        with open(os.path.join(path, "params.pkl"), "wb") as f:
            pickle.dump(to_jax_tree(self.model.named_parameters()), f, protocol=4)
        with open(os.path.join(path, "dac_params.pkl"), "wb") as f:
            pickle.dump(dac_to_jax_tree(self.dac), f, protocol=4)

    def _encode_text(self, texts: Sequence[str], left_pad: bool
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """Tokenize, pad to a multiple of `pad_to_multiple`: (ids, mask), both
        (B, S) int64. Prompts pad on the left, descriptions on the right."""
        if self.tokenizer is None:
            raise ValueError("pipeline has no tokenizer; pass token ids directly")
        ids_list = self.tokenizer(list(texts))["input_ids"]
        max_len = _round_up(max(len(x) for x in ids_list), self.pad_to_multiple)
        ids = np.zeros((len(ids_list), max_len), np.int64)
        mask = np.zeros((len(ids_list), max_len), np.int64)
        for i, x in enumerate(ids_list):
            row = slice(max_len - len(x), max_len) if left_pad else slice(0, len(x))
            ids[i, row] = x
            mask[i, row] = 1
        return ids, mask

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
        audio = self.dac_decode.decode(sliced.to(self.device)).float()  # (B, T*hop, 1)
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
        """(waveform (B, samples), audio lengths (B,)). `description` and
        `prompt` are strings or lists of strings (tokenized, their masks
        made here) or token-id arrays."""
        if isinstance(description, str):
            description = [description]
        if isinstance(prompt, str):
            prompt = [prompt]
        if isinstance(description, (list, tuple)):
            description, desc_mask = self._encode_text(description, left_pad=False)
        if isinstance(prompt, (list, tuple)):
            prompt, prompt_mask = self._encode_text(prompt, left_pad=True)
        out = self.generate_codes(description, desc_mask, prompt, prompt_mask, seed,
                                  decoder_prompt_codes=decoder_prompt_codes)
        return self.decode_codes(out.codes, out.lengths)
