"""Checkpoint files of the HF layout: `config.json` parsed into the config
tree, and `.safetensors` files read without the safetensors package (port of
`load_hf_config` and `load_safetensors_dir` in
`parler_tts_tpu/runtime/pipeline.py`).

A `.safetensors` file is an 8-byte little-endian header length, a JSON
header mapping each tensor's name to its `dtype`, `shape` and
`data_offsets` ([begin, end) into the bytes after the header; an optional
`__metadata__` entry holds strings), then the raw little-endian bytes. The
reader maps the file copy-on-write and returns tensors that view the
mapping, so the weights occupy host memory once, as the page cache's pages;
BF16 loads bit for bit as `torch.bfloat16`. `write_safetensors` writes the
format (the training CLI's export).
"""

from __future__ import annotations

import json
import math
import mmap
import os
import struct
import sys
from typing import Dict

import torch

from ..codec.encodec_model import EncodecCodecConfig
from ..config import DACConfig, DecoderConfig, ParlerTTSConfig, T5Config

SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32, "I16": torch.int16,
    "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool,
}


def load_hf_config(path: str) -> ParlerTTSConfig:
    """Parse an HF-layout `config.json` into the config tree, with the JAX
    package's defaults for absent fields (`feed_forward_proj` defaults to
    "relu", as in HF's T5Config). The codec is Encodec when its section's
    `model_type` (HF) or `codec_type` (`ParlerTTSConfig.to_json`) says so."""
    with open(os.path.join(path, "config.json")) as f:
        raw = json.load(f)
    te, ae, de = raw["text_encoder"], raw["audio_encoder"], raw["decoder"]
    mt = ae.get("model_type")
    if mt == "encodec" or ae.get("codec_type") == "encodec":  # HF's name, or to_json's
        audio_encoder = _encodec_config(ae, de)
    elif mt not in (None, "dac", "dac_on_the_hub"):
        raise ValueError(
            f"unsupported audio_encoder model_type {mt!r}; "
            "supported codecs: dac_on_the_hub, encodec"
        )
    else:
        # geometry fields beyond HF's DACConfig (which fixes them to the
        # 44.1 kHz model) are read when present, so other DAC variants
        # round-trip
        dac = DACConfig()
        audio_encoder = DACConfig(
            num_codebooks=ae.get("num_codebooks", 9),
            codebook_size=ae.get("codebook_size", 1024),
            codebook_dim=ae.get("codebook_dim", dac.codebook_dim),
            latent_dim=ae.get("latent_dim", 1024),
            encoder_dim=ae.get("encoder_dim", dac.encoder_dim),
            encoder_rates=tuple(ae.get("encoder_rates", dac.encoder_rates)),
            decoder_dim=ae.get("decoder_dim", dac.decoder_dim),
            decoder_rates=tuple(ae.get("decoder_rates", dac.decoder_rates)),
            frame_rate=int(ae.get("frame_rate", 86)),
            sampling_rate=ae.get("sampling_rate", 44100),
        )
    return ParlerTTSConfig(
        text_encoder=T5Config(
            vocab_size=te["vocab_size"],
            d_model=te["d_model"],
            d_kv=te["d_kv"],
            d_ff=te["d_ff"],
            num_layers=te["num_layers"],
            num_heads=te["num_heads"],
            relative_attention_num_buckets=te.get("relative_attention_num_buckets", 32),
            relative_attention_max_distance=te.get("relative_attention_max_distance", 128),
            feed_forward_proj=te.get("feed_forward_proj", "relu"),
            dropout_rate=te.get("dropout_rate", 0.1),
        ),
        audio_encoder=audio_encoder,
        decoder=DecoderConfig(
            vocab_size=de["vocab_size"],
            max_position_embeddings=de.get("max_position_embeddings", 4096),
            num_hidden_layers=de["num_hidden_layers"],
            ffn_dim=de["ffn_dim"],
            num_attention_heads=de["num_attention_heads"],
            num_key_value_heads=de.get("num_key_value_heads"),
            num_cross_attention_key_value_heads=de.get("num_cross_attention_key_value_heads"),
            activation_function=de.get("activation_function", "gelu"),
            hidden_size=de["hidden_size"],
            dropout=de.get("dropout", 0.1),
            num_codebooks=de.get("num_codebooks", 9),
            pad_token_id=de.get("pad_token_id", 1024),
            bos_token_id=de.get("bos_token_id", 1025),
            eos_token_id=de.get("eos_token_id", 1024),
            rope_embeddings=de.get("rope_embeddings", False),
            rope_theta=de.get("rope_theta", 10000.0),
            sliding_window=de.get("sliding_window"),
            use_fused_lm_heads=de.get("use_fused_lm_heads", False),
            codebook_weights=tuple(de["codebook_weights"]) if de.get("codebook_weights") else None,
        ),
        vocab_size=raw.get("vocab_size", 32128),
        prompt_cross_attention=raw.get("prompt_cross_attention", False),
        pad_token_id=raw.get("pad_token_id", 1024),
        decoder_start_token_id=raw.get("decoder_start_token_id", 1025),
    )


def _encodec_config(ae: dict, de: dict) -> EncodecCodecConfig:
    """An HF `EncodecConfig` section -> `EncodecCodecConfig`, with HF's
    defaults; without `num_codebooks` the quantizer count comes from the top
    target bandwidth (HF's `EncodecConfig.num_quantizers`), else from the
    decoder's codebook count."""
    up = tuple(ae.get("upsampling_ratios", (8, 5, 4, 4)))
    frame_rate = -(-ae.get("sampling_rate", 32000) // math.prod(up))  # ceil
    if "num_codebooks" in ae:
        n_q = ae["num_codebooks"]
    elif ae.get("target_bandwidths"):
        n_q = int(1000 * ae["target_bandwidths"][-1] // (frame_rate * 10))
    else:
        n_q = de.get("num_codebooks", 4)
    return EncodecCodecConfig(
        sampling_rate=ae.get("sampling_rate", 32000),
        audio_channels=ae.get("audio_channels", 1),
        num_filters=ae.get("num_filters", 64),
        hidden_size=ae.get("hidden_size", 128),
        num_residual_layers=ae.get("num_residual_layers", 1),
        upsampling_ratios=up,
        codebook_size=ae.get("codebook_size", 2048),
        codebook_dim=ae.get("codebook_dim", ae.get("hidden_size", 128)),
        num_codebooks=n_q,
        num_lstm_layers=ae.get("num_lstm_layers", 2),
        kernel_size=ae.get("kernel_size", 7),
        last_kernel_size=ae.get("last_kernel_size", 7),
        residual_kernel_size=ae.get("residual_kernel_size", 3),
        dilation_growth_rate=ae.get("dilation_growth_rate", 2),
        use_causal_conv=ae.get("use_causal_conv", True),
        trim_right_ratio=ae.get("trim_right_ratio", 1.0),
        pad_mode=ae.get("pad_mode", "reflect"),
        compress=ae.get("compress", 2),
        normalize=ae.get("normalize", False),
    )


def _unique_keys(pairs):
    out = {}
    for key, value in pairs:
        if key in out:
            raise ValueError(f"safetensors header names {key!r} twice")
        out[key] = value
    return out


def read_safetensors(filename: str) -> Dict[str, torch.Tensor]:
    """Every tensor of one `.safetensors` file, as CPU tensors over a
    copy-on-write mapping of the file. Raises `ValueError` on a header that
    does not fit the file, offsets that run past the data or overlap, a size
    that does not match the shape, or an unknown dtype."""
    if sys.byteorder != "little":
        raise ValueError("reading .safetensors needs a little-endian host")
    size = os.path.getsize(filename)
    with open(filename, "rb") as f:
        head = f.read(8)
        if len(head) < 8:
            raise ValueError(f"{filename}: {size} bytes, shorter than the header length")
        (n,) = struct.unpack("<Q", head)
        if n > size - 8:
            raise ValueError(f"{filename}: header of {n} bytes runs past the file ({size})")
        try:
            header = json.loads(f.read(n), object_pairs_hook=_unique_keys)
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise ValueError(f"{filename}: the header is not JSON ({e})") from None
        if not isinstance(header, dict):
            raise ValueError(f"{filename}: the header is not a JSON object")
        header.pop("__metadata__", None)
        start, data_size = 8 + n, size - 8 - n
        spans = []
        for name, entry in header.items():
            try:
                dtype = SAFETENSORS_DTYPES.get(entry["dtype"])
                shape = [int(d) for d in entry["shape"]]
                begin, end = (int(x) for x in entry["data_offsets"])
            except (KeyError, TypeError, ValueError) as e:
                raise ValueError(f"{filename}: {name}: malformed entry {entry!r} ({e})") from None
            if min(shape, default=0) < 0:
                raise ValueError(f"{filename}: {name}: negative dimension in {shape}")
            if dtype is None:
                raise ValueError(f"{filename}: {name}: unknown dtype {entry['dtype']!r}")
            nbytes = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
            if not 0 <= begin <= end <= data_size or end - begin != nbytes:
                raise ValueError(f"{filename}: {name}: data_offsets [{begin}, {end}) do not "
                                 f"hold {nbytes} bytes within the {data_size} data bytes")
            spans.append((begin, end, name, dtype, tuple(shape)))
        spans.sort()
        for (_, end, a, *_), (begin, _, b, *_) in zip(spans, spans[1:]):
            if begin < end:
                raise ValueError(f"{filename}: the data of {a} and {b} overlap")
        if not spans:
            return {}
        mapped = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    tensors = {}
    for begin, end, name, dtype, shape in spans:
        if begin == end:
            tensors[name] = torch.empty(shape, dtype=dtype)
        else:
            flat = torch.frombuffer(mapped, dtype=dtype, count=math.prod(shape),
                                    offset=start + begin)
            tensors[name] = flat.reshape(shape)
    return tensors


def load_safetensors_dir(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of every `*.safetensors` file in `path`, the files read
    in sorted order; a name found in two files raises `ValueError`."""
    files = sorted(f for f in os.listdir(path) if f.endswith(".safetensors"))
    if not files:
        raise FileNotFoundError(f"no .safetensors files under {path}")
    tensors: Dict[str, torch.Tensor] = {}
    for fname in files:
        for name, tensor in read_safetensors(os.path.join(path, fname)).items():
            if name in tensors:
                raise ValueError(f"{name} is in two shards of {path} (the second: {fname})")
            tensors[name] = tensor
    return tensors


SAFETENSORS_CODES = {dtype: code for code, dtype in SAFETENSORS_DTYPES.items()}


def write_safetensors(filename: str, tensors: Dict[str, torch.Tensor]) -> int:
    """A writer of the `.safetensors` format (the inverse of
    `read_safetensors`, without the safetensors package): an 8-byte
    little-endian header length, a JSON header (name -> dtype, shape,
    data_offsets), padded with spaces to 8 bytes, then each tensor's bytes
    in order; BF16 written as its raw 16-bit words. Tensors may live on the
    card; each is copied to the host and written in turn. Returns the bytes
    written."""
    header, offset = {}, 0
    for name, t in tensors.items():
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": SAFETENSORS_CODES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(filename, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for t in tensors.values():
            host = t.detach().contiguous().cpu()
            f.write((host.view(torch.int16) if host.dtype == torch.bfloat16 else host)
                    .numpy().tobytes())
    return 8 + len(head) + offset
