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
FSDP choice. No rule names `seq`: every parameter is replicated over it, as
in JAX, and a `seq` rank runs its share of the time rows of a training
sequence (`models/parler.py:ParlerTTS.forward`).

`shard_params(model, mesh, fsdp)` slices a full model in place to the
rank's shards and wires the `model` group into the modules that compute
over sharded heads, columns or vocab rows. Tensor parallelism needs every
attention's heads (and kv heads) and every MLP width divisible by the
`model` size; a vocabulary that is not stays whole on every rank, as the
divisibility rule leaves it replicated. The JAX rules match `kernel`
leaves only, and GSPMD keeps the int8 `{w_q, scale}` leaves and the fused
q|k|v kernel replicated and consistent there; the port's tensor
parallelism is explicit, so `_PORT_RULES` split those leaves as their float
counterparts are split (`w_q` as the kernel, a column-parallel `scale` by
its columns, a row-parallel one whole), and the fused kernel (D, (H + 2
H_kv) Dh) by each of its q, k and v parts: its plan entry is ("model",
(q, k, v widths)), which `local_part` and `gather_full` split part by part
(`spec_axes` reads any plan as axis names). The fused decode step
(kernel K3) takes no mesh, as the JAX package's fused path takes none.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any, Dict, Iterable, Mapping, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from .collectives import Shard, all_gather_dim

# a plan entry is an axis name, None, or (axis, part widths) for a dim that
# concatenates parts each split over the axis on its own
Spec = Tuple[Any, ...]


@dataclass
class Mesh:
    """The rank's place in a (data, seq, model) mesh and the device it
    computes on. `batch` is the data x seq group (the ranks that share this
    rank's model index): the sums over a training batch run over it."""

    device_mesh: Any
    data: Shard
    model: Shard
    device: torch.device
    seq: Shard
    batch: Shard

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.data.size, "seq": self.seq.size, "model": self.model.size}

    def axis(self, name: str) -> Shard:
        return {"data": self.data, "seq": self.seq, "model": self.model}[name]


def make_mesh(n_data: Optional[int] = None, n_model: int = 1, n_seq: int = 1,
              device=None) -> Mesh:
    """A ("data", "seq", "model") mesh over the initialised process group;
    `n_data` defaults to the world over n_model x n_seq. `device` is where
    the rank computes (default: `cuda:<current>` under NCCL, else `cpu`)."""
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
    data = Shard(dm["data"].get_group(), n_data, rank // (n_seq * n_model))
    seq = Shard(dm["seq"].get_group(), n_seq, rank // n_model % n_seq)
    if n_seq == 1 or n_data == 1:
        batch = data if n_seq == 1 else seq
    else:  # every rank makes every group, in one order
        groups = [dist.new_group(list(range(m, world, n_model))) for m in range(n_model)]
        batch = Shard(groups[rank % n_model], n_data * n_seq, rank // n_model)
    return Mesh(dm, data=data, model=Shard(dm["model"].get_group(), n_model, rank % n_model),
                device=torch.device(device), seq=seq, batch=batch)


def local_seq_slice(length: int, mesh: Mesh) -> slice:
    """The rank's `seq` share of a sequence of `length` time steps (a
    training batch's label columns), as JAX's `P("data", "seq")` input
    sharding cuts it; a length the axis does not divide is refused, as
    JAX refuses it."""
    n = mesh.seq.size
    if length % n:
        raise ValueError(f"{length} label columns not divisible by {n} seq ranks")
    return slice(mesh.seq.rank * length // n, (mesh.seq.rank + 1) * length // n)


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


def _fused_qkv(shape: Tuple[int, ...]) -> Spec:
    """The fused q|k|v kernel (D, D + 2 kv): q is D wide, as q_proj is
    (D, D); a rank holds its share of each of q, k and v, in that order."""
    d = shape[0]
    kv = (shape[1] - d) // 2
    return (None, ("model", (d, kv, kv)))


# leaves the JAX rules leave replicated (GSPMD keeps them consistent) that the
# port's explicit tensor parallelism splits as their float counterparts
_PORT_RULES: Tuple[Tuple[str, Spec], ...] = (
    (r".*(self_attn|encoder_attn)/(q_proj|k_proj|v_proj)/w_q$", (None, "model")),
    (r".*(self_attn|encoder_attn)/(q_proj|k_proj|v_proj)/scale$", ("model",)),
    (r".*(self_attn|encoder_attn)/out_proj/w_q$", ("model", None)),
    (r".*fc1/w_q$", (None, "model")),
    (r".*fc1/scale$", ("model",)),
    (r".*fc2/w_q$", ("model", None)),
    (r".*self_attn/qkv_proj/kernel$", _fused_qkv),
)


def flax_path(name: str) -> str:
    """A port parameter name as the JAX tree's path (`layers.3` ->
    `layers_3`, `block.0` -> `block_0`, dots -> slashes)."""
    return re.sub(r"(^|/)(layers|block)/(\d+)(?=/|$)", r"\1\2_\3", name.replace(".", "/"))


def param_partition_spec(name: str, shape: Optional[Tuple[int, ...]] = None) -> Spec:
    """The rule's spec for a parameter (port name or flax path); () is
    replicated. The JAX package's rules first, then the port's own; a rule
    that is a function reads its spec off `shape`, which it then needs."""
    path = flax_path(name)
    for pattern, spec in _RULES + _PORT_RULES:
        if re.match(pattern, path):
            if callable(spec):
                if shape is None:
                    raise ValueError(f"the plan of {name} needs its shape")
                spec = spec(shape)
            return spec
    return ()


def axis_of(entry) -> Optional[str]:
    """The mesh axis of a plan entry (None when replicated)."""
    return entry[0] if isinstance(entry, tuple) else entry


def spec_axes(spec: Spec) -> Tuple[Optional[str], ...]:
    """A plan as the axis name of each dim."""
    return tuple(axis_of(e) for e in spec)


def _parts(entry, size: int) -> Tuple[int, ...]:
    """The widths a dim of `size` splits part by part under `entry`."""
    return entry[1] if isinstance(entry, tuple) else (size,)


def _divides(entry, size: int, n: int) -> bool:
    return all(w % n == 0 for w in _parts(entry, size))


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
        dims = list(param_partition_spec(name, shape))
        for i, entry in enumerate(dims):
            if (entry is not None and i < len(shape)
                    and not _divides(entry, shape[i], sizes[axis_of(entry)])):
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
        base = list(param_partition_spec(name, shape))
        base += [None] * (len(shape) - len(base))
        numel = 1
        for n in shape:
            numel *= n
        if len(shape) >= 1 and numel >= 2 ** 13:
            for i in sorted(range(len(shape)), key=lambda i: -shape[i]):
                if base[i] is None and shape[i] % sizes["data"] == 0:
                    base[i] = "data"
                    break
        for i, entry in enumerate(base):
            if entry is not None and not _divides(entry, shape[i], sizes[axis_of(entry)]):
                base[i] = None
        out[name] = tuple(base[:len(shape)])
    return out


def local_part(t: torch.Tensor, spec: Spec, mesh: Mesh, axes=("data", "model")) -> torch.Tensor:
    """The rank's shard of a full tensor under `spec` (over `axes`); a
    dim of parts holds the rank's share of each part, in order."""
    for dim, entry in enumerate(spec):
        if axis_of(entry) in axes:
            shard = mesh.axis(axis_of(entry))
            parts = t.split(list(_parts(entry, t.shape[dim])), dim=dim)
            t = torch.cat([p.narrow(dim, shard.span(p.shape[dim]).start, p.shape[dim] // shard.size)
                           for p in parts], dim=dim)
    return t


def gather_full(t: torch.Tensor, spec: Spec, mesh: Mesh, axes=("data", "model")) -> torch.Tensor:
    """The full tensor of the rank's shard `t` under `spec`: all-gathered
    over each axis of `axes` that shards a dim."""
    for dim, entry in enumerate(spec):
        if axis_of(entry) in axes:
            shard = mesh.axis(axis_of(entry))
            t = all_gather_dim(t, dim, shard)
            # parts: rank-major [q_r k_r v_r]... -> [q_0..q_n k_0..k_n v_0..v_n]
            if isinstance(entry, tuple):
                parts = entry[1]
                ranks = [r.split([w // shard.size for w in parts], dim=dim)
                         for r in t.chunk(shard.size, dim=dim)]
                t = torch.cat([r[i] for i in range(len(parts)) for r in ranks], dim=dim)
    return t


def check_model_axis(model: nn.Module, n_model: int) -> None:
    """Tensor parallelism's demands on a `ParlerTTS`: heads and MLP widths
    that `n_model` divides, and not both int8 weights and the fused q|k|v
    projection (the JAX pipeline refuses that pair, and the port builds no
    such model to serve)."""
    if n_model == 1:
        return
    if model.weight_quant and model.fused_qkv:
        raise ValueError("fused_qkv does not support weight_quant models")
    dcfg, tcfg = model.config.decoder, model.config.text_encoder
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
    from ..models.decoder import Attention, DecoderLayer, ParlerDecoder, ParlerForCausalLM
    from ..models.layers import Embed
    from ..models.t5_encoder import T5Encoder, T5FeedForward, T5SelfAttention

    def sharded(name):
        return "model" in spec_axes(specs[name])

    for name, m in model.named_modules():
        pre = f"{name}." if name else ""
        if isinstance(m, (Attention, DecoderLayer, T5SelfAttention, T5FeedForward)):
            m.tp = shard
        elif isinstance(m, T5Encoder):
            m.tp_heads = shard
            m.tp = shard if sharded(pre + "shared_embedding") else None
        elif isinstance(m, ParlerForCausalLM):
            m.tp = shard if sharded(pre + "lm_heads") else None
        elif isinstance(m, ParlerDecoder):
            m.tp = shard if sharded(pre + "embed_tokens") else None
        elif isinstance(m, Embed):
            m.tp = shard if sharded(pre + "embedding") else None
