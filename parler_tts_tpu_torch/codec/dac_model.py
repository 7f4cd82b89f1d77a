"""Descript Audio Codec (port of `parler_tts_tpu/codec/dac_model.py`): the
Snake-activation conv encoder, the residual vector quantizer (decode from
codes, and greedy encode to codes) and the transposed-conv decoder.

Public functions keep the JAX package's (B, T, C) layout; inside, the conv
stack runs channels-first (B, C, T) as PyTorch's convolutions want. Weights
are stored in PyTorch's layouts; each module's `from_jax` maps a JAX leaf
(conv kernels (K, C_in, C_out), snake alpha (1, 1, C)) onto its parameter,
and `to_jax` maps it back. Weight norm is folded into the kernels, as in the
JAX package.

The activations take the dtype of the latents, which is fp32: a codec whose
parameters were cast to bf16 (the pipeline's `codec_dtype`) computes in fp32
with bf16-rounded weights, as the JAX codec does after `cast_floating`
(its `from_codes` einsum returns fp32).

JAX runs ConvTranspose1d as an input-dilated conv with a flipped kernel; that
is exactly `conv_transpose1d` with weight[c_in, c_out, k] = kernel[k, c_in, c_out].
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import DACConfig
from ..models.layers import new_param


def snake(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Snake activation x + sin^2(alpha x) / (alpha + 1e-9), alpha per channel."""
    return x + torch.sin(alpha * x) ** 2 / (alpha + 1e-9)


class Snake1d(nn.Module):
    def __init__(self, channels: int, device=None):
        super().__init__()
        self.alpha = new_param(1, channels, 1, device=device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.alpha.fill_(1.0)

    def from_jax(self, leaf: str, arr: torch.Tensor) -> Tuple[str, torch.Tensor]:
        return leaf, arr.reshape(1, -1, 1)

    def to_jax(self, name: str, t: torch.Tensor) -> Tuple[str, torch.Tensor]:
        return name, t.reshape(1, 1, -1)

    def forward(self, x):  # (B, C, T)
        return snake(x, self.alpha.to(x.dtype))


class Conv1d(nn.Module):
    """Conv with symmetric zero padding; weight (C_out, C_in, K)."""

    def __init__(self, c_in: int, c_out: int, kernel_size: int, stride: int = 1,
                 padding: int = 0, dilation: int = 1, device=None):
        super().__init__()
        self.weight = new_param(c_out, c_in, kernel_size, device=device)
        self.bias = new_param(c_out, device=device)
        self.stride, self.padding, self.dilation = stride, padding, dilation

    def reset_parameters(self, generator: torch.Generator) -> None:
        fan_in = self.weight.shape[1] * self.weight.shape[2]
        self.weight.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=generator)
        self.bias.zero_()

    def from_jax(self, leaf: str, arr: torch.Tensor) -> Tuple[str, torch.Tensor]:
        return ("weight", arr.permute(2, 1, 0)) if leaf == "kernel" else (leaf, arr)

    def to_jax(self, name: str, t: torch.Tensor) -> Tuple[str, torch.Tensor]:
        return ("kernel", t.permute(2, 1, 0)) if name == "weight" else (name, t)

    def forward(self, x):
        return F.conv1d(x, self.weight.to(x.dtype), self.bias.to(x.dtype), self.stride,
                        self.padding, self.dilation)


class ConvTranspose1d(nn.Module):
    """Transposed conv, out_len = (T - 1) * stride - 2 * padding + K;
    weight (C_in, C_out, K)."""

    def __init__(self, c_in: int, c_out: int, kernel_size: int, stride: int = 1,
                 padding: int = 0, device=None):
        super().__init__()
        self.weight = new_param(c_in, c_out, kernel_size, device=device)
        self.bias = new_param(c_out, device=device)
        self.stride, self.padding = stride, padding

    def reset_parameters(self, generator: torch.Generator) -> None:
        fan_in = self.weight.shape[0] * self.weight.shape[2]
        self.weight.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=generator)
        self.bias.zero_()

    def from_jax(self, leaf: str, arr: torch.Tensor) -> Tuple[str, torch.Tensor]:
        return ("weight", arr.permute(1, 2, 0)) if leaf == "kernel" else (leaf, arr)

    def to_jax(self, name: str, t: torch.Tensor) -> Tuple[str, torch.Tensor]:
        return ("kernel", t.permute(2, 0, 1)) if name == "weight" else (name, t)

    def forward(self, x):
        return F.conv_transpose1d(x, self.weight.to(x.dtype), self.bias.to(x.dtype),
                                  self.stride, self.padding)


class ResidualUnit(nn.Module):
    def __init__(self, dim: int, dilation: int, device=None):
        super().__init__()
        self.snake1 = Snake1d(dim, device)
        self.conv1 = Conv1d(dim, dim, 7, padding=(6 * dilation) // 2, dilation=dilation,
                            device=device)
        self.snake2 = Snake1d(dim, device)
        self.conv2 = Conv1d(dim, dim, 1, device=device)

    def forward(self, x):
        return x + self.conv2(self.snake2(self.conv1(self.snake1(x))))


class EncoderBlock(nn.Module):
    """Three residual units (dilations 1, 3, 9) at dim // 2 channels, then a
    strided down conv (kernel 2 * stride) to `dim` channels."""

    def __init__(self, dim: int, stride: int, device=None):
        super().__init__()
        h = dim // 2
        self.res1 = ResidualUnit(h, 1, device)
        self.res2 = ResidualUnit(h, 3, device)
        self.res3 = ResidualUnit(h, 9, device)
        self.snake = Snake1d(h, device)
        self.down = Conv1d(h, dim, 2 * stride, stride=stride, padding=math.ceil(stride / 2),
                           device=device)

    def forward(self, x):
        return self.down(self.snake(self.res3(self.res2(self.res1(x)))))


class DACEncoder(nn.Module):
    def __init__(self, config: DACConfig, device=None):
        super().__init__()
        d = config.encoder_dim
        self.conv_in = Conv1d(1, d, 7, padding=3, device=device)
        blocks = []
        for stride in config.encoder_rates:
            d *= 2
            blocks.append(EncoderBlock(d, stride, device))
        self.block = nn.ModuleList(blocks)
        self.snake_out = Snake1d(d, device)
        self.conv_out = Conv1d(d, config.latent_dim, 3, padding=1, device=device)

    def forward(self, audio: torch.Tensor) -> torch.Tensor:
        """audio (B, T, 1) -> latents (B, T / hop, latent_dim)."""
        x = self.conv_in(audio.transpose(1, 2))
        for block in self.block:
            x = block(x)
        return self.conv_out(self.snake_out(x)).transpose(1, 2)


class DecoderBlock(nn.Module):
    def __init__(self, input_dim: int, output_dim: int, stride: int, device=None):
        super().__init__()
        self.snake = Snake1d(input_dim, device)
        self.up = ConvTranspose1d(input_dim, output_dim, 2 * stride, stride=stride,
                                  padding=math.ceil(stride / 2), device=device)
        self.res1 = ResidualUnit(output_dim, 1, device)
        self.res2 = ResidualUnit(output_dim, 3, device)
        self.res3 = ResidualUnit(output_dim, 9, device)

    def forward(self, x):
        return self.res3(self.res2(self.res1(self.up(self.snake(x)))))


class DACDecoder(nn.Module):
    def __init__(self, config: DACConfig, device=None):
        super().__init__()
        self.conv_in = Conv1d(config.latent_dim, config.decoder_dim, 7, padding=3,
                              device=device)
        blocks, dim = [], config.decoder_dim
        for i, stride in enumerate(config.decoder_rates):
            out_dim = config.decoder_dim // (2 ** (i + 1))
            blocks.append(DecoderBlock(dim, out_dim, stride, device))
            dim = out_dim
        self.block = nn.ModuleList(blocks)
        self.snake_out = Snake1d(dim, device)
        self.conv_out = Conv1d(dim, 1, 7, padding=3, device=device)

    def forward(self, latents: torch.Tensor) -> torch.Tensor:
        """latents (B, T', latent_dim) -> audio (B, T' * hop, 1) in [-1, 1]."""
        x = self.conv_in(latents.transpose(1, 2))
        for block in self.block:
            x = block(x)
        x = self.conv_out(self.snake_out(x))
        return torch.tanh(x).transpose(1, 2)


class ResidualVQ(nn.Module):
    """Residual vector quantizer: decode from codes, encode to codes. The
    in/out projections are 1x1 convs, stored as (K, in, out) kernels with
    the weight norm folded."""

    def __init__(self, config: DACConfig, device=None):
        super().__init__()
        k = config.num_codebooks
        self.codebooks = new_param(k, config.codebook_size, config.codebook_dim, device=device)
        self.in_proj_kernel = new_param(k, config.latent_dim, config.codebook_dim,
                                        device=device)
        self.in_proj_bias = new_param(k, config.codebook_dim, device=device)
        self.out_proj_kernel = new_param(k, config.codebook_dim, config.latent_dim,
                                         device=device)
        self.out_proj_bias = new_param(k, config.latent_dim, device=device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.codebooks.normal_(0.0, 1.0, generator=generator)
        std = 1.0 / math.sqrt(self.out_proj_kernel.shape[1])
        self.out_proj_kernel.normal_(0.0, std, generator=generator)
        self.out_proj_bias.zero_()
        self.in_proj_kernel.normal_(0.0, 1.0 / math.sqrt(self.in_proj_kernel.shape[1]),
                                    generator=generator)
        self.in_proj_bias.zero_()

    def from_codes(self, codes: torch.Tensor) -> torch.Tensor:
        """codes (B, K, T') -> fp32 latents (B, T', latent_dim):
        sum_k out_proj_k(codebook_k[codes_k]), the products summed in fp32."""
        k = self.codebooks.shape[0]
        offsets = (torch.arange(k, device=codes.device) * self.codebooks.shape[1])[None, :, None]
        z_p = F.embedding(codes + offsets, self.codebooks.reshape(-1, self.codebooks.shape[2]))
        z_q = torch.einsum("bktc,kcd->btd", z_p.float(), self.out_proj_kernel.float())
        return z_q + self.out_proj_bias.float().sum(dim=0)[None, None, :]

    def distances(self, residual: torch.Tensor, k: int) -> torch.Tensor:
        """(B, T', C) squared distances between the L2-normalised
        in-projection of `residual` (B, T', D) and codebook k's L2-normalised
        entries, with the JAX package's (and descript's `decode_latents`)
        1e-12 epsilons."""
        z_e = residual @ self.in_proj_kernel[k] + self.in_proj_bias[k]
        enc = z_e / (torch.linalg.vector_norm(z_e, dim=-1, keepdim=True) + 1e-12)
        cb = self.codebooks[k]
        cbn = cb / (torch.linalg.vector_norm(cb, dim=-1, keepdim=True) + 1e-12)
        return (enc.square().sum(dim=-1, keepdim=True) - 2.0 * enc @ cbn.t()
                + cbn.square().sum(dim=-1))

    def quantized(self, k: int, idx: torch.Tensor) -> torch.Tensor:
        """Codebook k's out-projected vectors for the codes `idx` (B, T'),
        which leave the residual."""
        return self.codebooks[k][idx] @ self.out_proj_kernel[k] + self.out_proj_bias[k]

    def encode(self, latents: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Greedy residual quantization: latents (B, T', D) -> (codes (B, K, T')
        int64, z_q (B, T', D)). Codebook k takes the entry nearest to the
        residual (`distances`; the first index wins a tie, as with
        `jnp.argmin`); its out-projection leaves the residual, and z_q sums
        them."""
        residual, codes, z_q = latents, [], 0
        for k in range(self.codebooks.shape[0]):
            idx = torch.argmin(self.distances(residual, k), dim=-1)  # (B, T')
            z_q_k = self.quantized(k, idx)
            residual = residual - z_q_k
            codes.append(idx)
            z_q = z_q + z_q_k
        return torch.stack(codes, dim=1), z_q


class DACModel(nn.Module):
    """The codec: encode audio (B, T, 1) float -> codes (B, K, T / hop) int64;
    decode codes (B, K, T') int -> audio (B, T' * hop, 1) float."""

    def __init__(self, config: DACConfig, device=None):
        super().__init__()
        self.config = config
        self.quantizer = ResidualVQ(config, device)
        self.decoder = DACDecoder(config, device)
        self.encoder = DACEncoder(config, device)

    def encode(self, audio: torch.Tensor) -> torch.Tensor:
        """audio (B, T, 1), T a multiple of hop_length -> codes (B, K, T / hop)."""
        return self.quantizer.encode(self.encoder(audio))[0]

    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.quantizer.from_codes(codes))
