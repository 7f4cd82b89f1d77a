"""Encodec neural codec (port of `parler_tts_tpu/codec/encodec_model.py`):
the SEANet encoder and decoder with ELU activations, residual blocks with
shortcut convs and a residual 2-layer LSTM, and the residual vector
quantizer, with HF `transformers.EncodecModel` semantics:

  - causal convs pad `padding_total = (k - 1) * dilation + 1 - stride` on the
    left, plus a right `extra_padding` that aligns the last frame;
    non-causal convs split `padding_total` half and half;
  - reflect padding of an input no longer than the pad zero-extends it
    first and trims the extension after, as the JAX package does
    (`F.pad(mode="reflect")` alone refuses such an input);
  - the transposed conv trims `padding_total` from the ends, the right share
    set by `trim_right_ratio` in causal mode;
  - the quantizer takes the plain L2 argmin against each codebook of the
    residual, with the JAX package's distance |r|^2 - 2 r.c + |c|^2 (the
    first index wins a tie, as `jnp.argmin`); decoding sums the gathered
    codebook vectors.

Public functions keep the JAX package's (B, T, C) layout; inside, the conv
stack runs channels-first (B, C, T). Parameters are stored in PyTorch's
layouts under the flax names; each module's `from_jax` maps a JAX leaf onto
its parameter and `to_jax` maps it back (`convert.py`). The LSTM is PyTorch's
`nn.LSTM` (cuDNN on the card), whose gate order i, f, g, o and summed biases
are the JAX package's manual scan; the residual is added after the last
layer. Weight norm is folded at conversion (`convert_encodec_params`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..models.layers import new_param
from .convert import _folded_weight


@dataclass(frozen=True)
class EncodecCodecConfig:
    """The HF EncodecConfig fields that shape the network, with the JAX
    package's defaults (the geometry of `facebook/encodec_32khz`)."""

    sampling_rate: int = 32000
    audio_channels: int = 1
    num_filters: int = 64
    hidden_size: int = 128
    num_residual_layers: int = 1
    upsampling_ratios: Tuple[int, ...] = (8, 5, 4, 4)
    codebook_size: int = 2048
    codebook_dim: int = 128
    num_codebooks: int = 4          # derived from the bandwidth in HF; explicit here
    num_lstm_layers: int = 2
    kernel_size: int = 7
    last_kernel_size: int = 7
    residual_kernel_size: int = 3
    dilation_growth_rate: int = 2
    use_causal_conv: bool = True
    trim_right_ratio: float = 1.0
    pad_mode: str = "reflect"
    compress: int = 2
    # scale-normalised checkpoints: encode divides each clip by its RMS and
    # returns the scale; decode multiplies it back (`audio_scales`)
    normalize: bool = False
    codec_type: str = "encodec"  # the registry's discriminator (codec/registry.py)

    @property
    def hop_length(self) -> int:
        return math.prod(self.upsampling_ratios)

    @property
    def frame_rate(self) -> int:
        return math.ceil(self.sampling_rate / self.hop_length)


def _extra_padding(length: int, k_eff: int, stride: int, padding_total: int) -> int:
    n_frames = (length - k_eff + padding_total) / stride + 1
    ideal = (math.ceil(n_frames) - 1) * stride + (k_eff - padding_total)
    return max(ideal - length, 0)


def _pad1d(x: torch.Tensor, left: int, right: int, mode: str) -> torch.Tensor:
    """Pad (B, C, T) on the time axis. Reflect padding of an input no longer
    than the pad zero-extends the input by the missing samples, reflects,
    and trims the extension from the end, as the JAX package does."""
    if mode != "reflect":
        return F.pad(x, (left, right))
    length = x.shape[-1]
    max_pad = max(left, right)
    if length <= max_pad:
        extra = max_pad - length + 1
        out = F.pad(F.pad(x, (0, extra)), (left, right), mode="reflect")
        return out[..., : out.shape[-1] - extra]
    return F.pad(x, (left, right), mode="reflect")


class EncodecConv1d(nn.Module):
    """HF `EncodecConv1d`: a conv with causal or split auto-padding; weight
    (C_out, C_in, K), the JAX kernel (K, C_in, C_out)."""

    def __init__(self, config: EncodecCodecConfig, c_in: int, c_out: int, kernel_size: int,
                 stride: int = 1, dilation: int = 1, device=None):
        super().__init__()
        self.config = config
        self.weight = new_param(c_out, c_in, kernel_size, device=device)
        self.bias = new_param(c_out, device=device)
        self.stride, self.dilation = stride, dilation

    def reset_parameters(self, generator: torch.Generator) -> None:
        fan_in = self.weight.shape[1] * self.weight.shape[2]
        self.weight.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=generator)
        self.bias.zero_()

    def from_jax(self, leaf: str, arr: torch.Tensor) -> Tuple[str, torch.Tensor]:
        return ("weight", arr.permute(2, 1, 0)) if leaf == "kernel" else (leaf, arr)

    def to_jax(self, name: str, t: torch.Tensor) -> Tuple[str, torch.Tensor]:
        return ("kernel", t.permute(2, 1, 0)) if name == "weight" else (name, t)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, C, T)
        cfg = self.config
        k_eff = (self.weight.shape[2] - 1) * self.dilation + 1
        padding_total = k_eff - self.stride
        extra = _extra_padding(x.shape[-1], k_eff, self.stride, padding_total)
        if cfg.use_causal_conv:
            x = _pad1d(x, padding_total, extra, cfg.pad_mode)
        else:
            half = padding_total // 2
            x = _pad1d(x, half, padding_total - half + extra, cfg.pad_mode)
        return F.conv1d(x, self.weight.to(x.dtype), self.bias.to(x.dtype), self.stride,
                        0, self.dilation)


class EncodecConvTranspose1d(nn.Module):
    """HF `EncodecConvTranspose1d`: a transposed conv trimmed at both ends.
    The JAX package runs it as an input-dilated conv with the kernel flipped
    in time, which is `conv_transpose1d` with weight[c_in, c_out, k] =
    kernel[k, c_in, c_out] (no flip here); both give (T - 1) * stride + K
    samples before the trim."""

    def __init__(self, config: EncodecCodecConfig, c_in: int, c_out: int, kernel_size: int,
                 stride: int = 1, device=None):
        super().__init__()
        self.config = config
        self.weight = new_param(c_in, c_out, kernel_size, device=device)
        self.bias = new_param(c_out, device=device)
        self.stride = stride

    def reset_parameters(self, generator: torch.Generator) -> None:
        fan_in = self.weight.shape[0] * self.weight.shape[2]
        self.weight.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=generator)
        self.bias.zero_()

    def from_jax(self, leaf: str, arr: torch.Tensor) -> Tuple[str, torch.Tensor]:
        return ("weight", arr.permute(1, 2, 0)) if leaf == "kernel" else (leaf, arr)

    def to_jax(self, name: str, t: torch.Tensor) -> Tuple[str, torch.Tensor]:
        return ("kernel", t.permute(2, 0, 1)) if name == "weight" else (name, t)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, C, T)
        cfg = self.config
        y = F.conv_transpose1d(x, self.weight.to(x.dtype), self.bias.to(x.dtype), self.stride)
        padding_total = self.weight.shape[2] - self.stride
        if cfg.use_causal_conv:
            trim_right = math.ceil(padding_total * cfg.trim_right_ratio)
        else:
            trim_right = padding_total // 2
        trim_left = padding_total - trim_right
        return y[..., trim_left: y.shape[-1] - trim_right]


class EncodecResnetBlock(nn.Module):
    """ELU -> conv (residual kernel, dilated) -> ELU -> 1x1 conv, plus a 1x1
    shortcut conv of the input; the flax names `block_0`, `block_1`,
    `shortcut`."""

    def __init__(self, config: EncodecCodecConfig, dim: int, dilations: Tuple[int, int],
                 device=None):
        super().__init__()
        hidden = dim // config.compress
        self.block = nn.ModuleList([
            EncodecConv1d(config, dim, hidden, config.residual_kernel_size,
                          dilation=dilations[0], device=device),
            EncodecConv1d(config, hidden, dim, 1, dilation=dilations[1], device=device),
        ])
        self.shortcut = EncodecConv1d(config, dim, dim, 1, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for conv in self.block:
            h = conv(F.elu(h))
        return self.shortcut(x) + h


class EncodecLSTM(nn.LSTM):
    """HF `EncodecLSTM`: `num_lstm_layers` of `nn.LSTM` over (B, T, C) with
    the input added to the last layer's output. The flax leaves
    `w_ih_l{n}`, `w_hh_l{n}`, `b_ih_l{n}`, `b_hh_l{n}` are PyTorch's
    `weight_ih_l{n}` ... in the same layout."""

    def __init__(self, config: EncodecCodecConfig, dim: int, device=None):
        super().__init__(dim, dim, num_layers=config.num_lstm_layers, batch_first=True,
                         device=device)
        self.requires_grad_(False)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        if generator is None:  # nn.LSTM's own initialisation, from its constructor
            return super().reset_parameters()
        std = 1.0 / math.sqrt(self.hidden_size)
        for name, p in self.named_parameters():
            if name.startswith("weight"):
                p.normal_(0.0, std, generator=generator)
            else:
                p.zero_()

    def from_jax(self, leaf: str, arr: torch.Tensor) -> Tuple[str, torch.Tensor]:
        return leaf.replace("w_", "weight_").replace("b_", "bias_"), arr

    def to_jax(self, name: str, t: torch.Tensor) -> Tuple[str, torch.Tensor]:
        return name.replace("weight_", "w_").replace("bias_", "b_"), t

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, T, C)
        y, _ = super().forward(x)
        return x + y


class EncodecEncoder(nn.Module):
    def __init__(self, config: EncodecCodecConfig, device=None):
        super().__init__()
        cfg = config
        self.conv_in = EncodecConv1d(cfg, cfg.audio_channels, cfg.num_filters, cfg.kernel_size,
                                     device=device)
        self.n_ratios = len(cfg.upsampling_ratios)
        self.n_res = cfg.num_residual_layers
        for i, ratio in enumerate(cfg.upsampling_ratios[::-1]):
            dim = cfg.num_filters * 2 ** i
            for j in range(cfg.num_residual_layers):
                self.add_module(f"res_{i}_{j}", EncodecResnetBlock(
                    cfg, dim, (cfg.dilation_growth_rate ** j, 1), device))
            self.add_module(f"down_{i}", EncodecConv1d(cfg, dim, dim * 2, 2 * ratio,
                                                       stride=ratio, device=device))
        top = cfg.num_filters * 2 ** self.n_ratios
        self.lstm = EncodecLSTM(cfg, top, device)
        self.conv_out = EncodecConv1d(cfg, top, cfg.hidden_size, cfg.last_kernel_size,
                                      device=device)

    def forward(self, audio: torch.Tensor) -> torch.Tensor:
        """audio (B, T, channels) -> latents (B, T / hop, hidden_size)."""
        x = self.conv_in(audio.transpose(1, 2))
        for i in range(self.n_ratios):
            for j in range(self.n_res):
                x = getattr(self, f"res_{i}_{j}")(x)
            x = getattr(self, f"down_{i}")(F.elu(x))
        x = self.lstm(x.transpose(1, 2)).transpose(1, 2)
        return self.conv_out(F.elu(x)).transpose(1, 2)


class EncodecDecoder(nn.Module):
    def __init__(self, config: EncodecCodecConfig, device=None):
        super().__init__()
        cfg = config
        self.n_ratios = len(cfg.upsampling_ratios)
        self.n_res = cfg.num_residual_layers
        top = cfg.num_filters * 2 ** self.n_ratios
        self.conv_in = EncodecConv1d(cfg, cfg.hidden_size, top, cfg.kernel_size, device=device)
        self.lstm = EncodecLSTM(cfg, top, device)
        for i, ratio in enumerate(cfg.upsampling_ratios):
            dim = cfg.num_filters * 2 ** (self.n_ratios - i)
            self.add_module(f"up_{i}", EncodecConvTranspose1d(cfg, dim, dim // 2, 2 * ratio,
                                                              stride=ratio, device=device))
            for j in range(cfg.num_residual_layers):
                self.add_module(f"res_{i}_{j}", EncodecResnetBlock(
                    cfg, dim // 2, (cfg.dilation_growth_rate ** j, 1), device))
        self.conv_out = EncodecConv1d(cfg, cfg.num_filters, cfg.audio_channels,
                                      cfg.last_kernel_size, device=device)

    def forward(self, latents: torch.Tensor) -> torch.Tensor:
        """latents (B, T', hidden_size) -> audio (B, T' * hop, channels)."""
        x = self.conv_in(latents.transpose(1, 2))
        x = self.lstm(x.transpose(1, 2)).transpose(1, 2)
        for i in range(self.n_ratios):
            x = getattr(self, f"up_{i}")(F.elu(x))
            for j in range(self.n_res):
                x = getattr(self, f"res_{i}_{j}")(x)
        return self.conv_out(F.elu(x)).transpose(1, 2)


class EncodecRVQ(nn.Module):
    """The residual vector quantizer over `codebooks` (K, C, D)."""

    def __init__(self, config: EncodecCodecConfig, device=None):
        super().__init__()
        self.codebooks = new_param(config.num_codebooks, config.codebook_size,
                                   config.codebook_dim, device=device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.codebooks.normal_(0.0, 1.0, generator=generator)

    def from_codes(self, codes: torch.Tensor) -> torch.Tensor:
        """(B, K, T') -> (B, T', D): the sum of the gathered codebook vectors."""
        k, c, d = self.codebooks.shape
        offsets = (torch.arange(k, device=codes.device) * c)[None, :, None]
        return F.embedding(codes + offsets, self.codebooks.reshape(-1, d)).sum(dim=1)

    def distances(self, residual: torch.Tensor, k: int) -> torch.Tensor:
        """(B, T', C) squared distances of `residual` (B, T', D) to codebook
        k's entries, |r|^2 - 2 r.c + |c|^2 as the JAX package sums them."""
        cb = self.codebooks[k]
        return (residual.square().sum(dim=-1, keepdim=True) - 2.0 * residual @ cb.t()
                + cb.square().sum(dim=-1))

    def quantized(self, k: int, idx: torch.Tensor) -> torch.Tensor:
        """Codebook k's vectors for the codes `idx`, which leave the residual."""
        return self.codebooks[k][idx]

    def encode(self, latents: torch.Tensor) -> torch.Tensor:
        """(B, T', D) -> (B, K, T') int64: greedy residual L2 argmin over
        `distances` (the first index wins a tie, as with `jnp.argmin`)."""
        residual, out = latents, []
        for k in range(self.codebooks.shape[0]):
            idx = torch.argmin(self.distances(residual, k), dim=-1)
            out.append(idx)
            residual = residual - self.quantized(k, idx)
        return torch.stack(out, dim=1)

    def forward(self, codes: torch.Tensor) -> torch.Tensor:
        return self.from_codes(codes)


class EncodecCodec(nn.Module):
    """The codec, with `DACModel`'s contract: encode (B, T, C) float ->
    (B, K, T / hop) int64 codes; decode the inverse, (B, T' * hop, C)."""

    def __init__(self, config: EncodecCodecConfig, device=None):
        super().__init__()
        self.config = config
        self.encoder = EncodecEncoder(config, device)
        self.quantizer = EncodecRVQ(config, device)
        self.decoder = EncodecDecoder(config, device)

    def _scale(self, audio: torch.Tensor) -> torch.Tensor:
        """(B, T, C) -> (B,): the RMS of the channel mean, plus 1e-8."""
        mono = audio.mean(dim=-1)
        return mono.square().mean(dim=-1).sqrt() + 1e-8

    def encode(self, audio: torch.Tensor) -> torch.Tensor:
        """(B, T, C) -> codes (B, K, T'); a `normalize` codec divides each
        clip by its scale first (`encode_with_scale` returns the scales)."""
        return self.encode_with_scale(audio)[0]

    def encode_with_scale(self, audio: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(codes (B, K, T'), audio_scales (B,)); the scales are ones unless
        the codec normalises."""
        if not self.config.normalize:
            return (self.quantizer.encode(self.encoder(audio)),
                    torch.ones(audio.shape[0], dtype=audio.dtype, device=audio.device))
        scale = self._scale(audio)
        return self.quantizer.encode(self.encoder(audio / scale[:, None, None])), scale

    def decode(self, codes: torch.Tensor, audio_scales=None) -> torch.Tensor:
        """(B, K, T') -> (B, T' * hop, C); `audio_scales` (B,) multiplies
        each clip back to the amplitude its encode divided away."""
        audio = self.decoder(self.quantizer.from_codes(codes))
        if audio_scales is not None:
            scales = torch.as_tensor(audio_scales, dtype=audio.dtype, device=audio.device)
            audio = audio * scales[:, None, None]
        return audio

    def forward(self, audio: torch.Tensor) -> torch.Tensor:
        codes, scale = self.encode_with_scale(audio)
        return self.decode(codes, scale if self.config.normalize else None)


# -------------------------------------------------------------------- convert
def convert_encodec_params(tensors: Mapping[str, torch.Tensor], config: EncodecCodecConfig,
                           prefix: str = "") -> Dict:
    """An HF `EncodecModel` state dict -> the JAX `EncodecCodec` tree, weight
    norm folded. The ELU modules own layer indices of HF's `layers` lists,
    so the walk skips them; the LSTM sits at `encoder.layers.{li}` and
    `decoder.layers.1`."""

    def conv(name):  # (out, in, k) -> (k, in, out)
        return {"kernel": _folded_weight(tensors, f"{prefix}{name}.conv").permute(2, 1, 0),
                "bias": tensors[f"{prefix}{name}.conv.bias"]}

    def conv_t(name):  # (in, out, k) -> (k, in, out)
        return {"kernel": _folded_weight(tensors, f"{prefix}{name}.conv").permute(2, 0, 1),
                "bias": tensors[f"{prefix}{name}.conv.bias"]}

    def resnet(name):
        return {"block_0": conv(f"{name}.block.1"), "block_1": conv(f"{name}.block.3"),
                "shortcut": conv(f"{name}.shortcut")}

    def lstm(name):
        return {f"{part}_l{layer}": tensors[
                    f"{prefix}{name}.lstm.{part.replace('w_', 'weight_').replace('b_', 'bias_')}"
                    f"_l{layer}"]
                for layer in range(config.num_lstm_layers)
                for part in ("w_ih", "w_hh", "b_ih", "b_hh")}

    n_ratios, n_res = len(config.upsampling_ratios), config.num_residual_layers
    enc: Dict = {"conv_in": conv("encoder.layers.0")}
    li = 1
    for i in range(n_ratios):
        for j in range(n_res):
            enc[f"res_{i}_{j}"] = resnet(f"encoder.layers.{li}")
            li += 1
        li += 1  # the ELU
        enc[f"down_{i}"] = conv(f"encoder.layers.{li}")
        li += 1
    enc["lstm"] = lstm(f"encoder.layers.{li}")
    li += 2  # the LSTM and the ELU after it
    enc["conv_out"] = conv(f"encoder.layers.{li}")

    dec: Dict = {"conv_in": conv("decoder.layers.0"), "lstm": lstm("decoder.layers.1")}
    li = 3  # conv, LSTM, ELU
    for i in range(n_ratios):
        dec[f"up_{i}"] = conv_t(f"decoder.layers.{li}")
        li += 1
        for j in range(n_res):
            dec[f"res_{i}_{j}"] = resnet(f"decoder.layers.{li}")
            li += 1
        li += 1  # the ELU
    dec["conv_out"] = conv(f"decoder.layers.{li}")

    codebooks = torch.stack([tensors[f"{prefix}quantizer.layers.{k}.codebook.embed"]
                             for k in range(config.num_codebooks)])
    return {"encoder": enc, "quantizer": {"codebooks": codebooks}, "decoder": dec}
