"""The process mesh and the parameter partition rules (port of
`parler_tts_tpu/parallel/mesh.py`).

`make_mesh(n_data, n_model, n_seq)` lays the ranks out as a
`("data", "seq", "model")` DeviceMesh, model ranks contiguous, as the JAX
mesh reshapes its devices. A rank holds its own shard of each sharded
parameter and runs its own share of the compute; the collectives are
explicit (`collectives.py`). The rules are the JAX package's regexes on the
flax path of each parameter (`text_encoder.block.0.attention.q.kernel` is
`text_encoder/block_0/attention/q/kernel`), and a plan per parameter is a
tuple with one entry per dim: "model", "data" or None, what
`PartitionSpec` holds in JAX, with the same divisibility drops and the same
FSDP choice.

`shard_params(model, mesh, fsdp)` slices a full model in place to the
rank's shards and wires the `model` group into the modules that compute
over sharded heads, columns or vocab rows. Tensor parallelism needs every
attention's heads (and kv heads) and every MLP width divisible by the
`model` size; a vocabulary that is not stays whole on every rank, as the
divisibility rule leaves it replicated. Not ported: the `seq` axis
(sequence parallelism, ROADMAP item 23b), and `model` > 1 with int8
weights, the fused q|k|v projection or the fused decode step (23c: the JAX
rules match `kernel` leaves only).
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any, Dict, Iterable, Mapping, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from .collectives import Shard, all_gather_dim

Spec = Tuple[Optional[str], ...]


@dataclass
class Mesh:
    """The rank's place in a (data, seq, model) mesh and the device it
    computes on."""

    device_mesh: Any
    data: Shard
    model: Shard
    device: torch.device

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.data.size, "seq": 1, "model": self.model.size}

    def axis(self, name: str) -> Shard:
        return {"data": self.data, "model": self.model}[name]


def make_mesh(n_data: Optional[int] = None, n_model: int = 1, n_seq: int = 1,
              device=None) -> Mesh:
    """A ("data", "seq", "model") mesh over the initialised process group;
    `n_data` defaults to the world over n_model x n_seq. `device` is where
    the rank computes (default: `cuda:<current>` under NCCL, else `cpu`)."""
    if n_seq > 1:
        raise NotImplementedError(
            "the seq mesh axis (sequence parallelism) is not ported: ROADMAP item 23b")
    world = dist.get_world_size()
    if n_data is None:
        n_data = world // (n_model * n_seq)
    if n_data * n_seq * n_model != world:
        raise ValueError(f"mesh {n_data}x{n_seq}x{n_model} != {world} ranks")
    from torch.distributed.device_mesh import init_device_mesh

    nccl = dist.get_backend() == "nccl"
    if device is None:
        device = torch.device("cuda", torch.cuda.current_device()) if nccl else "cpu"
    dm = init_device_mesh("cuda" if nccl else "cpu", (n_data, n_seq, n_model),
                          mesh_dim_names=("data", "seq", "model"))
    rank = dist.get_rank()
    return Mesh(dm,
                data=Shard(dm["data"].get_group(), n_data, rank // (n_seq * n_model)),
                model=Shard(dm["model"].get_group(), n_model, rank % n_model),
                device=torch.device(device))


# ---------------------------------------------------------------------------
# the JAX package's rules, on the flax path of a parameter
_RULES: Tuple[Tuple[str, Spec], ...] = (
    # (K, vocab+1, D): embedding rows over model
    (r".*decoder/embed_tokens$", (None, "model", None)),
    # attention projections (D, H*Dh): heads (the output dim)
    (r".*(self_attn|encoder_attn)/(q_proj|k_proj|v_proj)/kernel$", (None, "model")),
    # out projection (H*Dh, D): the input (heads) dim, summed over model
    (r".*(self_attn|encoder_attn)/out_proj/kernel$", ("model", None)),
    # MLP: fc1 (D, F) and fc2 (F, D) over F
    (r".*fc1/kernel$", (None, "model")),
    (r".*fc2/kernel$", ("model", None)),
    # LM heads (K, D, V): vocab
    (r".*lm_heads$", (None, None, "model")),
    # T5 encoder attention and MLP
    (r".*attention/(q|k|v)/kernel$", (None, "model")),
    (r".*attention/o/kernel$", ("model", None)),
    (r".*ff/(wi|wi_0|wi_1)/kernel$", (None, "model")),
    (r".*ff/wo/kernel$", ("model", None)),
    (r".*shared_embedding$", ("model", None)),
    (r".*embed_prompts/embedding$", ("model", None)),
)


def flax_path(name: str) -> str:
    """A port parameter name as the JAX tree's path (`layers.3` ->
    `layers_3`, `block.0` -> `block_0`, dots -> slashes)."""
    return re.sub(r"(^|/)(layers|block)/(\d+)(?=/|$)", r"\1\2_\3", name.replace(".", "/"))


def param_partition_spec(name: str) -> Spec:
    """The rule's spec for a parameter (port name or flax path); () is
    replicated."""
    path = flax_path(name)
    for pattern, spec in _RULES:
        if re.match(pattern, path):
            return spec
    return ()


def _sizes(mesh) -> Mapping[str, int]:
    return mesh.shape if hasattr(mesh, "shape") else mesh


def _shapes(params) -> Iterable[Tuple[str, Tuple[int, ...]]]:
    if isinstance(params, nn.Module):
        params = params.named_parameters()
    elif isinstance(params, Mapping):
        params = params.items()
    for name, value in params:
        yield name, tuple(value.shape) if hasattr(value, "shape") else tuple(value)


def params_shardings(params, mesh) -> Dict[str, Spec]:
    """name -> plan for a model, (name, tensor) pairs or {name: shape}: the
    rule's spec, a dim whose size the axis does not divide dropped to None,
    padded with None to the leaf's rank."""
    sizes = _sizes(mesh)
    out = {}
    for name, shape in _shapes(params):
        dims = list(param_partition_spec(name))
        for i, axis in enumerate(dims):
            if axis is not None and i < len(shape) and shape[i] % sizes[axis]:
                dims[i] = None
        dims += [None] * (len(shape) - len(dims))
        out[name] = tuple(dims[:len(shape)])
    return out


def fsdp_params_shardings(params, mesh) -> Dict[str, Spec]:
    """The FSDP plan: as `params_shardings`, and a leaf of 2^13 elements or
    more also shards its largest free dim that `data` divides over `data`."""
    sizes = _sizes(mesh)
    out = {}
    for name, shape in _shapes(params):
        base = list(param_partition_spec(name))
        base += [None] * (len(shape) - len(base))
        numel = 1
        for n in shape:
            numel *= n
        if len(shape) >= 1 and numel >= 2 ** 13:
            for i in sorted(range(len(shape)), key=lambda i: -shape[i]):
                if base[i] is None and shape[i] % sizes["data"] == 0:
                    base[i] = "data"
                    break
        for i, axis in enumerate(base):
            if axis is not None and shape[i] % sizes[axis]:
                base[i] = None
        out[name] = tuple(base[:len(shape)])
    return out


def local_part(t: torch.Tensor, spec: Spec, mesh: Mesh, axes=("data", "model")) -> torch.Tensor:
    """The rank's shard of a full tensor under `spec` (over `axes`)."""
    for dim, axis in enumerate(spec):
        if axis in axes:
            t = t[(slice(None),) * dim + (mesh.axis(axis).span(t.shape[dim]),)]
    return t


def gather_full(t: torch.Tensor, spec: Spec, mesh: Mesh, axes=("data", "model")) -> torch.Tensor:
    """The full tensor of the rank's shard `t` under `spec`: all-gathered
    over each axis of `axes` that shards a dim."""
    for dim, axis in enumerate(spec):
        if axis in axes:
            t = all_gather_dim(t, dim, mesh.axis(axis))
    return t


def check_model_axis(model: nn.Module, n_model: int) -> None:
    """Tensor parallelism's demands on a `ParlerTTS`: float, unfused
    weights and a decoder embedding that stays whole (ROADMAP item 23c),
    and heads and MLP widths that `n_model` divides."""
    if n_model == 1:
        return
    if model.weight_quant:
        raise NotImplementedError(
            "tensor parallelism (model axis > 1) with int8 weights (weight_quant) is not "
            "ported: ROADMAP item 23c")
    if model.fused_qkv:
        raise NotImplementedError(
            "tensor parallelism (model axis > 1) with fused_qkv is not ported: ROADMAP item 23c")
    dcfg, tcfg = model.config.decoder, model.config.text_encoder
    if dcfg.embed_rows % n_model == 0:
        raise NotImplementedError(
            f"tensor parallelism over {n_model} ranks would shard the decoder's embed_tokens "
            f"({dcfg.embed_rows} rows a codebook, as the JAX rules do); a vocab-sharded "
            "decoder embedding is not ported: ROADMAP item 23c")
    widths = {
        "decoder attention heads": dcfg.num_attention_heads,
        "decoder key/value heads": dcfg.num_key_value_heads,
        "decoder cross-attention key/value heads": dcfg.num_cross_attention_key_value_heads,
        "decoder ffn_dim": dcfg.ffn_dim,
        "text encoder heads": tcfg.num_heads,
        "text encoder d_ff": tcfg.d_ff,
    }
    bad = {k: v for k, v in widths.items() if v % n_model}
    if bad:
        raise ValueError(f"model axis {n_model} does not divide the {bad}")


def shard_params(model: nn.Module, mesh: Mesh, fsdp: bool = False) -> nn.Module:
    """Slice a full `ParlerTTS` in place to the rank's shards under the
    plan (`fsdp_params_shardings` with `fsdp`), record the plan
    (`model.shard_specs`) and the mesh (`model.mesh`), and wire the model
    group into the modules that compute over sharded parameters. Returns
    `model`."""
    if getattr(model, "mesh", None) is not None:
        raise ValueError("the model is sharded already")
    check_model_axis(model, mesh.model.size)
    specs = (fsdp_params_shardings if fsdp else params_shardings)(model, mesh)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.data = local_part(p.data, specs[name], mesh).clone()
    model.mesh, model.shard_specs = mesh, specs
    if mesh.model.size > 1:
        _wire_model_axis(model, mesh.model, specs)
    return model


def _wire_model_axis(model: nn.Module, shard: Shard, specs: Mapping[str, Spec]) -> None:
    from ..models.decoder import Attention, DecoderLayer, ParlerForCausalLM
    from ..models.layers import Embed
    from ..models.t5_encoder import T5Encoder, T5FeedForward, T5SelfAttention

    def sharded(name):
        return "model" in specs[name]

    for name, m in model.named_modules():
        pre = f"{name}." if name else ""
        if isinstance(m, (Attention, DecoderLayer, T5SelfAttention, T5FeedForward)):
            m.tp = shard
        elif isinstance(m, T5Encoder):
            m.tp_heads = shard
            m.tp = shard if sharded(pre + "shared_embedding") else None
        elif isinstance(m, ParlerForCausalLM):
            m.tp = shard if sharded(pre + "lm_heads") else None
        elif isinstance(m, Embed):
            m.tp = shard if sharded(pre + "embedding") else None
