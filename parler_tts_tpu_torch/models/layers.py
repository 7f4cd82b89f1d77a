"""Parameter-holding building blocks shared by the port's models.

Parameter names and layouts follow the flax modules of the JAX package
(`nn.Dense.kernel` (in, out), `nn.LayerNorm.scale`/`bias`,
`nn.Embed.embedding`), so `convert.py` maps a JAX parameter tree onto a port
module by name alone. Modules allocate their parameters on the given device
and dtype; `init_weights` fills them from a `torch.Generator`.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def new_param(*shape: int, device=None, dtype=torch.float32) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype), requires_grad=False)


class Dense(nn.Module):
    """y = x @ kernel (+ bias), kernel (in, out). `std=None` initialises
    lecun-normal (std 1/sqrt(in)), as flax's default."""

    def __init__(self, in_features: int, out_features: int, bias: bool = False,
                 std: Optional[float] = None, device=None, dtype=torch.float32):
        super().__init__()
        self.kernel = new_param(in_features, out_features, device=device, dtype=dtype)
        self.bias = new_param(out_features, device=device, dtype=dtype) if bias else None
        self.std = std if std is not None else 1.0 / math.sqrt(in_features)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.kernel.normal_(0.0, self.std, generator=generator)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x @ self.kernel
        return y + self.bias if self.bias is not None else y


class LayerNorm(nn.Module):
    """flax `nn.LayerNorm`: scale and bias over the last axis."""

    def __init__(self, features: int, eps: float = 1e-5, device=None, dtype=torch.float32):
        super().__init__()
        self.scale = new_param(features, device=device, dtype=dtype)
        self.bias = new_param(features, device=device, dtype=dtype)
        self.eps = eps

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.scale.fill_(1.0)
        self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, (x.shape[-1],), self.scale, self.bias, self.eps)


class Embed(nn.Module):
    """flax `nn.Embed`: an (num, features) table."""

    def __init__(self, num: int, features: int, std: float = 1.0, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.embedding = new_param(num, features, device=device, dtype=dtype)
        self.std = std

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.embedding.normal_(0.0, self.std, generator=generator)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.embedding)


def init_weights(root: nn.Module, generator: torch.Generator) -> None:
    """Fill every parameter of `root` from `generator`, module by module in
    registration order (each module with parameters defines `reset_parameters`)."""
    with torch.no_grad():
        for module in root.modules():
            reset = getattr(module, "reset_parameters", None)
            if reset is not None:
                reset(generator)
