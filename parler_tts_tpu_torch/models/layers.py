"""Parameter-holding building blocks shared by the port's models.

Parameter names and layouts follow the flax modules of the JAX package
(`nn.Dense.kernel` (in, out), `nn.LayerNorm.scale`/`bias`,
`nn.Embed.embedding`), so `convert.py` maps a JAX parameter tree onto a port
module by name alone. Modules allocate their parameters on the given device
in `param_dtype` (default: `dtype`) and compute in `dtype`, casting the
parameters at use as flax's `param_dtype`/`dtype` split does; with the
default the cast is a no-op. `init_weights` fills them from a
`torch.Generator`. Parameters are created with `requires_grad=False`;
a trainer turns it on (`nn.Module.requires_grad_`).

Dropout (flax `nn.Dropout`) draws its mask from a `torch.Generator` seeded
with an integer key. The models derive one key per call site with `fold_in`
from a per-step seed, the layer index and the site's name, so a layer run
again under `torch.utils.checkpoint` draws the same masks: checkpoint's
`preserve_rng_state` restores only the default generators, never these.
Over a mesh a mask is drawn for the global tensor and the rank keeps its
part (`parallel/rows.py`): its rows under data parallelism, and with `cols`
its columns of a tensor-parallel activation, and with `times` its time
rows of a sequence-parallel one, so the masks do not depend on the
partition.
"""

from __future__ import annotations

import hashlib
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.collectives import vocab_embedding
from ..parallel.rows import draw_sliced


def new_param(*shape: int, device=None, dtype=torch.float32) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype), requires_grad=False)


def fold_in(key: Optional[int], *data) -> Optional[int]:
    """A new dropout key from `key` and `data` (None stays None: deterministic)."""
    if key is None:
        return None
    digest = hashlib.blake2b(repr((key,) + data).encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little") >> 1


def dropout(x: torch.Tensor, rate: float, key: Optional[int],
            cols: Optional[Tuple[int, int]] = None,
            times: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """flax `nn.Dropout`: keep each element with probability 1 - rate and
    scale the kept ones by 1 / (1 - rate). `key=None` is deterministic.
    `cols` = (global width, first column): `x` holds those columns of the
    last dim of a wider activation, whose mask is drawn; `times` = (global
    length, first row) likewise for dim 1."""
    if key is None or rate == 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    gen = torch.Generator(device=x.device).manual_seed(key)
    keep = draw_sliced(lambda shape: torch.rand(shape, generator=gen, device=x.device),
                       x.shape, cols=cols, times=times) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


def bernoulli(p: float, key: int, device) -> torch.Tensor:
    """A () bool tensor, True with probability p, drawn on `device`."""
    gen = torch.Generator(device=device).manual_seed(key)
    return torch.rand((), generator=gen, device=device) < p


class Dense(nn.Module):
    """y = x @ kernel (+ bias), kernel (in, out), computed in `dtype`.
    `std=None` initialises lecun-normal (std 1/sqrt(in)), as flax's default."""

    def __init__(self, in_features: int, out_features: int, bias: bool = False,
                 std: Optional[float] = None, device=None, dtype=torch.float32,
                 param_dtype=None):
        super().__init__()
        pdt = param_dtype or dtype
        self.kernel = new_param(in_features, out_features, device=device, dtype=pdt)
        self.bias = new_param(out_features, device=device, dtype=pdt) if bias else None
        self.std = std if std is not None else 1.0 / math.sqrt(in_features)
        self.dtype = dtype

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.kernel.normal_(0.0, self.std, generator=generator)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x.to(self.dtype) @ self.kernel.to(self.dtype)
        return y + self.bias.to(self.dtype) if self.bias is not None else y


class LayerNorm(nn.Module):
    """flax `nn.LayerNorm`: scale and bias over the last axis. With fp32
    parameters under a lower compute dtype it normalises in fp32 with the
    fp32 scale and bias and casts the result, as flax does."""

    def __init__(self, features: int, eps: float = 1e-5, device=None, dtype=torch.float32,
                 param_dtype=None):
        super().__init__()
        pdt = param_dtype or dtype
        self.scale = new_param(features, device=device, dtype=pdt)
        self.bias = new_param(features, device=device, dtype=pdt)
        self.eps = eps
        self.dtype = dtype

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.scale.fill_(1.0)
        self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (x.shape[-1],)
        if x.dtype == self.scale.dtype:
            return F.layer_norm(x, shape, self.scale, self.bias, self.eps)
        return F.layer_norm(x.float(), shape, self.scale.float(), self.bias.float(),
                            self.eps).to(self.dtype)


class Embed(nn.Module):
    """flax `nn.Embed`: an (num, features) table, rows cast to `dtype`.
    With `tp` (a `parallel.collectives.Shard`) the module holds the rank's
    rows of the table and looks up vocab-parallel."""

    tp = None

    def __init__(self, num: int, features: int, std: float = 1.0, device=None,
                 dtype=torch.float32, param_dtype=None):
        super().__init__()
        self.embedding = new_param(num, features, device=device, dtype=param_dtype or dtype)
        self.std = std
        self.dtype = dtype

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.embedding.normal_(0.0, self.std, generator=generator)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        if self.tp is not None:
            return vocab_embedding(ids, self.embedding, self.tp).to(self.dtype)
        return F.embedding(ids, self.embedding).to(self.dtype)


def init_weights(root: nn.Module, generator: torch.Generator) -> None:
    """Fill every parameter of `root` from `generator`, module by module in
    registration order (each module with parameters defines `reset_parameters`)."""
    with torch.no_grad():
        for module in root.modules():
            reset = getattr(module, "reset_parameters", None)
            if reset is not None:
                reset(generator)
