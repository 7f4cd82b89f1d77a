"""Carry parameter trees of the JAX package into the port's modules, and back.

A tree is a nested dict under the flax names whose leaves are numpy arrays
(the JAX package's trees) or tensors (the HF name maps' output, which views
the checkpoint's own bf16 or fp32 tensors). The port's modules use the flax
parameter names, so a JAX leaf `decoder/decoder/layers_3/self_attn/q_proj/kernel`
lands in `decoder.decoder.layers.3.self_attn.q_proj.kernel`. A module that
stores a parameter in another layout (the codec's convs) maps the leaf
itself with `from_jax(leaf, tensor) -> (name, tensor)`, and back with
`to_jax(name, tensor) -> (leaf, tensor)`. Every leaf is shape- and
dtype-checked (an integer leaf, such as the int8 `w_q` of a quantized tree,
only into a parameter of its own dtype; a float leaf only into a float
parameter, of any float dtype, so fp32 trees load into bf16 or fp32
parameters), and every parameter of the port's module must receive a leaf.
`to_jax_tree` goes the other way, for parameters and their gradients;
`tensor_tree` gives a module's own tensors under the flax names and layouts.

A model sliced to a rank's shards (`parallel/mesh.py:shard_params`) loads
the full tree by taking each leaf's shard under its plan, and
`to_jax_tree(named, model=)` all-gathers each tensor of such a model to
its full shape first, on every rank, so checkpoints and exports keep the
full layout whatever the mesh.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Iterable, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from .parallel.mesh import gather_full, local_part

_INDEXED = re.compile(r"^(layers|block)_(\d+)$")

Path = Tuple[str, ...]


def as_tensor(leaf) -> torch.Tensor:
    """A tree leaf as a tensor: tensors as they are, writable arrays without
    a copy (a read-only array, such as one that views a JAX array, is copied)."""
    if isinstance(leaf, torch.Tensor):
        return leaf
    arr = np.asarray(leaf)
    return torch.from_numpy(arr if arr.flags.writeable else arr.copy())


def _flatten(tree: Mapping[str, Any], prefix: Path = ()) -> Dict[Path, Any]:
    flat = {}
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            flat.update(_flatten(value, path))
        else:
            flat[path] = value
    return flat


def _load(root: nn.Module, tree: Mapping[str, Any]) -> None:
    modules = dict(root.named_modules())
    params = dict(root.named_parameters())
    specs = getattr(root, "shard_specs", None)
    loaded = set()
    for path, leaf in _flatten(tree).items():
        arr = as_tensor(leaf)
        parts = [".".join(m.groups()) if (m := _INDEXED.match(p)) else p for p in path]
        mod_name, leaf = ".".join(parts[:-1]), parts[-1]
        module = modules.get(mod_name)
        if module is None:
            raise KeyError(f"JAX leaf {'/'.join(path)}: no module {mod_name!r} in the port")
        from_jax = getattr(module, "from_jax", None)
        if from_jax is not None:
            leaf, arr = from_jax(leaf, arr)
        name = f"{mod_name}.{leaf}" if mod_name else leaf
        param = params.get(name)
        if param is None:
            raise KeyError(f"JAX leaf {'/'.join(path)}: no parameter {name!r} in the port")
        if specs is not None:
            arr = local_part(arr, specs[name], root.mesh)
        if tuple(arr.shape) != tuple(param.shape):
            raise ValueError(
                f"JAX leaf {'/'.join(path)}: shape {tuple(arr.shape)} != "
                f"{name} {tuple(param.shape)}"
            )
        leaf_int = not arr.dtype.is_floating_point
        if leaf_int != (not param.dtype.is_floating_point) or (
                leaf_int and arr.dtype != param.dtype):
            raise TypeError(
                f"JAX leaf {'/'.join(path)}: dtype {arr.dtype} does not fit {name} {param.dtype}"
            )
        with torch.no_grad():
            param.copy_(arr)
        loaded.add(name)
    missing = sorted(set(params) - loaded)
    if missing:
        raise KeyError(f"port parameters with no JAX leaf: {missing}")


def _tree(named: Iterable[Tuple[str, torch.Tensor]], modules: Mapping[str, nn.Module]
          ) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for name, tensor in named:
        parts = name.split(".")
        mod_name, leaf = ".".join(parts[:-1]), parts[-1]
        tensor = tensor.detach()
        to_jax = getattr(modules.get(mod_name), "to_jax", None)
        if to_jax is not None:
            leaf, tensor = to_jax(leaf, tensor)
        path = []
        for part in parts[:-1]:
            if part.isdigit() and path and path[-1] in ("layers", "block"):
                path[-1] = f"{path[-1]}_{part}"
            else:
                path.append(part)
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = tensor
    return tree


def numpy_tree(tree: Mapping[str, Any]) -> Dict[str, Any]:
    """A nested dict of tensors (on any device) -> the same dict of numpy
    arrays on the host, fp32 for floats: the leaves the JAX package pickles."""
    return {k: numpy_tree(v) if isinstance(v, Mapping) else
            (v.cpu().float() if v.is_floating_point() else v.cpu()).numpy()
            for k, v in tree.items()}


def tensor_tree(module: nn.Module) -> Dict[str, Any]:
    """`module`'s parameters under the flax names and layouts (each
    module's `to_jax` applied), as the module's own tensors: on its device,
    in its dtypes, sharing its storage where no layout change is needed."""
    return _tree(module.named_parameters(), dict(module.named_modules()))


def to_jax_tree(named: Iterable[Tuple[str, torch.Tensor]], model: nn.Module = None
                ) -> Dict[str, Any]:
    """The reverse of `load_jax_params` for modules that keep the flax
    layouts (not the codec): (port name, tensor) pairs, such as
    `model.named_parameters()` or their gradients, -> a nested dict of numpy
    arrays under the flax names (`layers.3` -> `layers_3`), fp32 for floats.
    With a sharded `model` the tensors are its shards, all-gathered to their
    full shapes (a collective: every rank of the mesh calls it)."""
    specs = getattr(model, "shard_specs", None)
    if specs is not None:
        named = [(n, gather_full(t.detach(), specs[n], model.mesh)) for n, t in named]
    return numpy_tree(_tree(named, {}))


def dac_to_jax_tree(dac: nn.Module) -> Dict[str, Any]:
    """The reverse of `load_jax_dac_params`: a codec's parameters (`DACModel`
    or `EncodecCodec`) as the JAX codec's tree (names and layouts; encoder,
    quantizer and decoder), numpy fp32."""
    return numpy_tree(tensor_tree(dac))


def load_jax_params(model: nn.Module, params: Mapping[str, Any]) -> None:
    """`ParlerTTS` (or any port module named like its flax twin) <- a flax-named
    tree of arrays or tensors, copied into the module's parameters on their
    device and in their dtypes."""
    _load(model, params)


def load_jax_dac_params(dac: nn.Module, dac_params: Mapping[str, Any]) -> None:
    """A codec (`DACModel` or `EncodecCodec`) <- the JAX codec's params, every
    leaf (encoder, quantizer, decoder)."""
    _load(dac, dac_params)
