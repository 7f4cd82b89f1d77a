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

The codec is DAC or Encodec, as the config's `audio_encoder.codec_type`
says (`codec/registry.py`). Voice steering: `encode_voice_prompt` turns a
reference clip into codec codes with the fp32 codec's encoder; they go to
`generate` as `decoder_prompt_codes`. A scale-normalised Encodec returns
each clip's scale beside its codes, for `generate(..., audio_scales=)` and
`decode_codes`; a stereo codec's audio comes back interleaved,
PCM-style. Streaming: `stream` (B=1 or the batch's row 0) and
`stream_batch` yield waveform chunks every `play_steps` columns, decoding a
trailing window of frames each time (`runtime/generate.py:
make_stream_functions`; `runtime/streamer.py` wraps them for a player).

Speculative decoding (the JAX package's default B=1 serving mode):
`speculative_window=W` verifies W candidate columns per decoder forward
(`runtime/speculative.py`) in `generate_codes`, `stream` and `stream_batch`;
`speculative_per_row=True` advances each row by its own accepted prefix;
`speculative_lookup=g` drafts from the stream's own history. Greedy tokens
are the AR loop's. It composes with `weight_quant` and excludes
`fused_decode`.

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

from ..codec.registry import build_codec, codec_channels, convert_codec_params, init_codec_params
from ..config import GenerationConfig, ParlerTTSConfig
from ..convert import dac_to_jax_tree, load_jax_dac_params, load_jax_params, to_jax_tree
from ..models.layers import init_weights
from ..models.parler import ParlerTTS, convert_composite_params, fused_qkv_model
from ..ops.fused_decode_step import prepare_fused_params
from ..utils.quantize import quantize_decoder_params_torch
from .checkpoint import load_hf_config, load_safetensors_dir
from ..ops.delay_pattern import undelay_pattern, valid_frame_lengths
from .speculative import (
    SpecStats,
    generate_tokens_speculative,
    make_stream_functions_speculative,
)
from .generate import (
    GenerateOutput,
    generate_tokens,
    generate_tokens_fused,
    make_stream_functions,
    resolve_device,
)


def _round_up(x: int, m: int) -> int:
    return max(m, ((x + m - 1) // m) * m)


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


def load_pickle(filename: str):
    """A checkpoint's pickled tree (`params.pkl`, `dac_params.pkl`), read by
    `_ArrayUnpickler`."""
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
        dac: torch.nn.Module,
        generation_config: Optional[GenerationConfig] = None,
        tokenizer: Any = None,
        frame_bucket: int = 256,
        pad_to_multiple: int = 16,
        cache_dtype: torch.dtype = torch.bfloat16,
        device=None,
        fused_decode: bool = False,
        fused_qkv: bool = False,
        codec_dtype: Optional[torch.dtype] = None,
        speculative_window: Optional[int] = None,
        speculative_per_row: bool = False,
        speculative_lookup: int = 3,
    ):
        if speculative_per_row and speculative_window is None:
            raise ValueError("speculative_per_row=True requires speculative_window (per-row "
                             "advance is a property of the speculative decoder)")
        if speculative_window is not None and fused_decode:
            raise ValueError("speculative_window and fused_decode are exclusive")
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
        # speculative decoding: W candidate columns verified per forward
        # (runtime/speculative.py), per row or over the batch's shared
        # horizon, with a history-lookup draft of `speculative_lookup`
        # columns (0: self-drafts only); stats of the last call in
        # `last_spec_stats`
        self.spec_window = speculative_window
        self.spec_per_row = speculative_per_row
        self.spec_lookup = speculative_lookup
        self.last_spec_stats: Optional[SpecStats] = None
        self._stream_fns = None

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
        `torch.Generator` seeded with `seed` (the codec, encoder and decoder,
        stays fp32). With
        `weight_quant` (True or "xla") each decoder projection draws its
        `dtype` weights on the device and quantizes them there to int8."""
        dev = resolve_device(device)
        generator = torch.Generator(device=dev)
        generator.manual_seed(seed)
        model = ParlerTTS(config, device=dev, dtype=dtype, weight_quant=weight_quant)
        init_weights(model, generator)
        dac = init_codec_params(build_codec(config.audio_encoder, dev), generator)
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
            `torch.Generator` seeded with 0), whatever the codec;
          - HF: `config.json` with `text_encoder`/`audio_encoder`/`decoder`
            sections (an `audio_encoder` of `model_type` "encodec" is an
            Encodec) and `*.safetensors` holding `text_encoder.*`,
            `decoder.*`, `embed_prompts.*`, `enc_to_dec_proj.*` and the
            codec's `audio_encoder.*` (weight-norm folded on load), or, with
            no codec tensors, the codec's tree in `dac_params.pkl` (the
            layout `training.run_training.export_and_push` writes, its
            `config.json` that of `to_json`).

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
            params = load_pickle(os.path.join(path, "params.pkl"))
            dac_path = os.path.join(path, "dac_params.pkl")
            dac_params = load_pickle(dac_path) if os.path.exists(dac_path) else None
        else:
            cfg = load_hf_config(path)
            tensors = load_safetensors_dir(path)
            params = convert_composite_params(tensors, cfg)
            dac_path = os.path.join(path, "dac_params.pkl")
            if not any(n.startswith("audio_encoder.") for n in tensors) and os.path.exists(
                    dac_path):  # the training CLI's export: the codec beside the tensors
                dac_params = load_pickle(dac_path)
            else:
                dac_params = convert_codec_params(tensors, cfg.audio_encoder)
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
        dac = build_codec(cfg.audio_encoder, dev)
        if dac_params is None:
            init_codec_params(dac, torch.Generator(device=dev).manual_seed(0))
        else:
            load_jax_dac_params(dac, dac_params)
        return cls(model, dac, generation_config, tokenizer=tokenizer, device=dev, **kw)

    def save_pretrained(self, path: str) -> None:
        """Write the native layout: `config.json`, `generation_config.json`,
        `params.pkl` (the flax-named tree, numpy fp32) and `dac_params.pkl`
        (the whole codec under the JAX codec's names and layouts, numpy
        fp32), which the JAX package loads and serves, decode and encode. A
        pipeline serving int8 or fused q|k|v weights raises: save the float
        model it was built from."""
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
        if self.spec_window is not None:
            out, self.last_spec_stats = generate_tokens_speculative(
                self.model, gen, ids[0], ids[1], ids[2], ids[3], generator,
                decoder_prompt_codes=ids[4], cache_dtype=self.cache_dtype,
                window=self.spec_window, per_row=self.spec_per_row,
                lookup_ngram=self.spec_lookup,
            )
            return out
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
    def encode_voice_prompt(self, audio, return_scales: bool = False):
        """A reference clip -> codec codes (B, K, T / hop) int64 on the
        pipeline's device, for `generate(..., decoder_prompt_codes=...)`.
        `audio` is (B, T) or (T,) float (numpy or a tensor), mono, replicated
        to the codec's channels, or (B, T, C); it is zero-padded to a
        multiple of `hop_length`. The fp32 codec encodes, whatever
        `codec_dtype` says (as the JAX package's encode keeps its fp32
        parameters). On the card, fp32 convolutions follow
        `torch.backends.cudnn.allow_tf32` (PyTorch turns it on by default),
        which moves the latents by about 1e-3 and with them the codes at
        near-ties; turn it off for fp32 codes.

        With `return_scales=True` also returns the per-clip audio scales
        (B,): a scale-normalised Encodec's, to pass to `generate(...,
        audio_scales=)` or `decode_codes`, else ones. Such a codec raises
        ValueError without `return_scales`: dropping the scales would give
        wrongly scaled audio."""
        normalize = getattr(self.config.audio_encoder, "normalize", False)
        if normalize and not return_scales:
            raise ValueError(
                "this codec is scale-normalized (Encodec normalize=True): call "
                "encode_voice_prompt(audio, return_scales=True) and pass the scales to "
                "generate(..., audio_scales=...); dropping them would give wrongly-scaled audio"
            )
        audio = (audio.float() if isinstance(audio, torch.Tensor)
                 else torch.from_numpy(np.array(audio, np.float32)))
        if audio.dim() == 1:
            audio = audio[None]
        if audio.dim() == 2:  # (B, T) mono: replicated across the codec's channels
            audio = audio[:, :, None].expand(-1, -1, codec_channels(self.config.audio_encoder))
        hop = self.config.audio_encoder.hop_length
        audio = torch.nn.functional.pad(audio, (0, 0, 0, -audio.shape[1] % hop)).to(self.device)
        if normalize:
            codes, scales = self.dac.encode_with_scale(audio)
        else:
            codes = self.dac.encode(audio)
            scales = torch.ones((codes.shape[0],), dtype=torch.float32, device=self.device)
        return (codes, scales) if return_scales else codes

    @torch.inference_mode()
    def decode_codes(self, codes: torch.Tensor, lengths: torch.Tensor, audio_scales=None
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """Bucketed codec decode: (B, K, T) codes -> (B, samples) waveform and
        sample lengths. `audio_scales` (B,) multiplies each clip back to the
        amplitude a normalising Encodec's encode divided away. A stereo
        codec's channels come interleaved, PCM-style: samples = frames x hop
        x channels."""
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
        audio = self.dac_decode.decode(sliced.to(self.device)).float()  # (B, T*hop, C)
        if audio_scales is not None:
            audio = audio * torch.as_tensor(audio_scales, dtype=audio.dtype,
                                            device=audio.device)[:, None, None]
        channels = audio.shape[-1]
        return audio.reshape(b, -1).cpu().numpy(), lengths * hop * channels

    def generate(
        self,
        description,
        prompt,
        desc_mask=None,
        prompt_mask=None,
        seed: int = 0,
        decoder_prompt_codes=None,
        audio_scales=None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """(waveform (B, samples), audio lengths (B,)). `description` and
        `prompt` are strings or lists of strings (tokenized, their masks
        made here) or token-id arrays; `audio_scales` (B,), from
        `encode_voice_prompt(..., return_scales=True)`, restores a
        normalising codec's amplitude."""
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
        return self.decode_codes(out.codes, out.lengths, audio_scales=audio_scales)

    # --------------------------------------------------------------- streaming
    def _ensure_stream_fns(self):
        """The (prefill, chunk step) pair, made once: speculative
        (`make_stream_functions_speculative`) when the pipeline has a window,
        else `make_stream_functions`. Streams take the eager decode step
        whatever `fused_decode` says, as in the JAX package."""
        if self._stream_fns is None:
            if self.spec_window is not None:
                self._stream_fns = make_stream_functions_speculative(
                    self.model, self.generation_config, window=self.spec_window,
                    cache_dtype=self.cache_dtype, per_row=self.spec_per_row,
                    lookup_ngram=self.spec_lookup)
            else:
                self._stream_fns = make_stream_functions(self.model, self.generation_config,
                                                         self.cache_dtype)
        return self._stream_fns

    def warmup_stream_async(self, desc_ids, desc_mask, prompt_ids, prompt_mask,
                            play_steps: int = 86, **stream_kwargs):
        """Run one stream flush with the given inputs on a background thread,
        so that a server pays the first-use costs (the kernels' nvcc builds,
        cuDNN's plans for the codec's shapes) before its first request.
        Returns the started thread; its `join()` re-raises a failure of the
        flush as RuntimeError("stream warmup failed")."""
        import threading

        pipe = self

        class _WarmupThread(threading.Thread):
            exc: Optional[BaseException] = None

            def run(self):
                try:
                    for _ in pipe.stream(desc_ids, desc_mask, prompt_ids, prompt_mask,
                                         play_steps=play_steps, **stream_kwargs):
                        break
                except BaseException as e:  # noqa: BLE001 - re-raised by join()
                    self.exc = e

            def join(self, timeout=None):
                super().join(timeout)
                if self.exc is not None:
                    raise RuntimeError("stream warmup failed") from self.exc

        thread = _WarmupThread(daemon=True, name="parler-stream-warmup")
        thread.start()
        return thread

    def _stream_state(self, desc_ids, desc_mask, prompt_ids, prompt_mask, seed,
                      decoder_prompt_codes):
        prefill_fn, step_fn = self._ensure_stream_fns()
        generator = torch.Generator(device=self.device)
        generator.manual_seed(seed)
        ids = [_as_ids(x, self.device) for x in
               (desc_ids, desc_mask, prompt_ids, prompt_mask, decoder_prompt_codes)]
        return prefill_fn(*ids[:4], generator, ids[4]), step_fn

    def _stream_frames(self, state, step_fn, play_steps: int):
        """Advance `state` a chunk at a time; yields (codes (B, K, t - K) of
        the columns so far, frame lengths (B,) numpy, done). Flush i shows
        the columns below t_start + i * play_steps, or below the row's end
        if that comes first: a speculative chunk, which runs past its
        target, shows the columns a plain stream shows, and those past it at
        the next flush (with no forward if they are already there). Each
        chunk runs until the slowest unfinished row reaches that limit; a
        finished row's columns past its own end hold the pattern's fill (its
        unverified candidates stay hidden)."""
        dcfg = self.config.decoder
        gen = self.generation_config
        max_len = gen.max_length

        def progress():
            t_raw = np.atleast_1d(torch.as_tensor(state.t).cpu().numpy())
            eos_rows = state.eos.eos_seen.all(dim=1).cpu().numpy()
            return t_raw, (t_raw >= max_len) | (eos_rows if t_raw.size > 1 else eos_rows.all())

        t_raw, row_done = progress()
        limit = int(t_raw.min())
        while True:
            limit += play_steps
            if not row_done.all():
                n_steps = limit - int(t_raw[~row_done].min())
                if n_steps > 0:
                    step_fn(state, n_steps)
                    t_raw, row_done = progress()
            t_vis = np.minimum(t_raw, limit)
            done = bool(row_done.all()) and int(t_raw.max()) <= limit
            t = int(t_vis.max())
            if t <= dcfg.num_codebooks:
                if done:
                    return
                continue
            cols = state.out_ids[:, :, :t]
            if (t_vis < t).any():
                pat = state.pattern[:, :, :t]
                tail = torch.where(pat == -1, torch.full_like(pat, gen.pad_token_id), pat)
                shown = torch.arange(t, device=pat.device)[None, None, :] < torch.as_tensor(
                    t_vis, device=pat.device)[:, None, None]
                cols = torch.where(shown, cols, tail)
            codes = undelay_pattern(cols, dcfg.num_codebooks)
            lengths = valid_frame_lengths(codes, dcfg.pad_token_id).cpu().numpy()
            yield codes, lengths, done
            if done:
                return

    def stream(self, desc_ids, desc_mask, prompt_ids, prompt_mask, play_steps: int = 86,
               seed: int = 0, decoder_prompt_codes=None, incremental: bool = True,
               context_frames: int = 64):
        """Yield waveform chunks (B, S) float32 numpy as generation goes on,
        for row 0's frames (port of the JAX package's `stream`): every
        `play_steps` columns the new frames are codec-decoded and the new
        samples emitted, holding back `stride = hop * max(play_steps - K, 1)
        // 6` samples for smooth joins; the last chunk gives the rest.

        `incremental=True` decodes only a trailing window of frames each
        flush, the new ones and `context_frames` before the first sample
        still to emit (`_decode_stream_window`), so a flush costs the same
        all along an utterance."""
        if self.spec_per_row and len(desc_ids) > 1:
            raise ValueError("stream() is the single-stream surface; with "
                             "speculative_per_row=True and B>1 use stream_batch()")
        hop = self.config.audio_encoder.hop_length
        stride = hop * max(play_steps - self.config.decoder.num_codebooks, 1) // 6
        state, step_fn = self._stream_state(desc_ids, desc_mask, prompt_ids, prompt_mask, seed,
                                            decoder_prompt_codes)
        to_yield = 0
        for codes, lengths, done in self._stream_frames(state, step_fn, play_steps):
            n = int(lengths[0])
            if n == 0:
                continue
            audio, base = self._decode_stream_window(codes, n, to_yield, play_steps,
                                                     incremental, context_frames)
            total = base + audio.shape[1]
            if done:
                if total > to_yield:
                    yield audio[:, to_yield - base:]
                return
            upper = max(total - stride, to_yield)
            if upper > to_yield:
                yield audio[:, to_yield - base: upper - base]
                to_yield = upper

    @torch.inference_mode()
    def _decode_stream_window(self, codes, n: int, to_yield: int, play_steps: int,
                              incremental: bool, context_frames: int):
        """Codec-decode the frames the next flush needs: the trailing window
        [w0, n), w0 = `context_frames` before the first sample still to emit
        (0 if not incremental), rounded up to a multiple of `play_steps`
        frames and clipped to the codes. Returns (audio (B, S) numpy, the
        sample offset of audio[:, 0])."""
        hop = self.config.audio_encoder.hop_length
        cb_max = self.config.audio_encoder.codebook_size - 1
        w0 = max(0, to_yield // hop - context_frames) if incremental else 0
        m = min(_round_up(n - w0, play_steps), codes.shape[-1] - w0)
        window = codes[:, :, w0: w0 + m].clamp(0, cb_max)
        audio = self.dac_decode.decode(window).float()[:, : (n - w0) * hop, 0]
        return audio.cpu().numpy(), w0 * hop

    def stream_batch(self, desc_ids, desc_mask, prompt_ids, prompt_mask,
                     play_steps: int = 86, seed: int = 0, decoder_prompt_codes=None,
                     incremental: bool = True, context_frames: int = 64):
        """B streams from one chunked loop (port of the JAX package's
        `stream_batch`). Yields `(chunk, valid)` pairs on one sample grid:
        `chunk` (B, S) float32 numpy, and `valid[i]` the count of this
        chunk's samples that are real for stream i (0 once stream i has
        ended; chunks go on until the longest stream ends). The stride
        hold-back and the decode window are those of `stream`. With
        `speculative_per_row=True` each stream advances by its own accepted
        prefix, and a flush shows what every stream has finalized."""
        hop = self.config.audio_encoder.hop_length
        stride = hop * max(play_steps - self.config.decoder.num_codebooks, 1) // 6
        state, step_fn = self._stream_state(desc_ids, desc_mask, prompt_ids, prompt_mask, seed,
                                            decoder_prompt_codes)
        to_yield = 0
        for codes, lengths, done in self._stream_frames(state, step_fn, play_steps):
            n_max = int(lengths.max())
            if n_max == 0:
                continue
            audio, base = self._decode_stream_window(codes, n_max, to_yield, play_steps,
                                                     incremental, context_frames)
            total = base + audio.shape[1]  # == n_max * hop
            upper = total if done else max(total - stride, to_yield)
            if upper > to_yield:
                width = upper - to_yield
                valid = np.clip(lengths * hop - to_yield, 0, width).astype(np.int64)
                yield audio[:, to_yield - base: upper - base], valid
                to_yield = upper
