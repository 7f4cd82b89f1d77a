"""Carry parameter trees of the JAX package, as numpy, into the port's modules.

The port's modules use the flax parameter names, so a JAX leaf
`decoder/decoder/layers_3/self_attn/q_proj/kernel` lands in
`decoder.decoder.layers.3.self_attn.q_proj.kernel`. A module that stores a
parameter in another layout (the codec's convs) maps the leaf itself with
`from_jax(leaf, array) -> (name, array)`. Every leaf is shape- and
dtype-checked (an integer leaf, such as the int8 `w_q` of a quantized tree,
only into a parameter of its own dtype; a float leaf only into a float
parameter, of any float dtype, so fp32 trees load into bf16 or fp32
parameters), and every parameter of the port's module must receive a leaf.
`to_jax_tree` goes the other way, for parameters and their gradients.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, Iterable, Mapping, Tuple

import numpy as np
import torch
from torch import nn

_INDEXED = re.compile(r"^(layers|block)_(\d+)$")

Path = Tuple[str, ...]


def _flatten(tree: Mapping[str, Any], prefix: Path = ()) -> Dict[Path, np.ndarray]:
    flat = {}
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            flat.update(_flatten(value, path))
        else:
            flat[path] = np.asarray(value)
    return flat


def _load(root: nn.Module, tree: Mapping[str, Any], skip: Callable[[Path], bool]) -> None:
    modules = dict(root.named_modules())
    params = dict(root.named_parameters())
    loaded = set()
    for path, arr in _flatten(tree).items():
        if skip(path):
            continue
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
        if tuple(arr.shape) != tuple(param.shape):
            raise ValueError(
                f"JAX leaf {'/'.join(path)}: shape {tuple(arr.shape)} != "
                f"{name} {tuple(param.shape)}"
            )
        leaf_int = np.issubdtype(arr.dtype, np.integer)
        if leaf_int != (not param.dtype.is_floating_point) or (
                leaf_int and torch.from_numpy(np.zeros(0, arr.dtype)).dtype != param.dtype):
            raise TypeError(
                f"JAX leaf {'/'.join(path)}: dtype {arr.dtype} does not fit {name} {param.dtype}"
            )
        with torch.no_grad():
            param.copy_(torch.from_numpy(np.array(arr)).to(param.dtype))
        loaded.add(name)
    missing = sorted(set(params) - loaded)
    if missing:
        raise KeyError(f"port parameters with no JAX leaf: {missing}")


def to_jax_tree(named: Iterable[Tuple[str, torch.Tensor]]) -> Dict[str, Any]:
    """The reverse of `load_jax_params` for modules that keep the flax
    layouts (not the codec): (port name, tensor) pairs, such as
    `model.named_parameters()` or their gradients, -> a nested dict of numpy
    arrays under the flax names (`layers.3` -> `layers_3`), fp32 for floats."""
    tree: Dict[str, Any] = {}
    for name, tensor in named:
        parts = name.split(".")
        path = []
        for part in parts[:-1]:
            if part.isdigit() and path and path[-1] in ("layers", "block"):
                path[-1] = f"{path[-1]}_{part}"
            else:
                path.append(part)
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        t = tensor.detach().cpu()
        node[parts[-1]] = (t.float() if t.is_floating_point() else t).numpy()
    return tree


def load_jax_params(model: nn.Module, params_np: Mapping[str, Any]) -> None:
    """`ParlerTTS` (or any port module named like its flax twin) <- JAX params."""
    _load(model, params_np, skip=lambda path: False)


# the encode side of the codec (voice steering) is not ported yet
def _dac_encode_side(path: Path) -> bool:
    return path[0] == "encoder" or path in (
        ("quantizer", "in_proj_kernel"), ("quantizer", "in_proj_bias"),
    )


def load_jax_dac_params(dac: nn.Module, dac_params_np: Mapping[str, Any]) -> None:
    """`DACModel` <- JAX DAC params (decode side; encode-side leaves are skipped)."""
    _load(dac, dac_params_np, skip=_dac_encode_side)
