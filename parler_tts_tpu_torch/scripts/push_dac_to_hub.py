"""Convert descript-DAC weights (`.pth` or `.safetensors`) into the JAX
codec's tree, `dac_params.pkl` (port of
`helpers/push_to_hub_scripts/push_dac_to_hub.py`):

    python -m parler_tts_tpu_torch.scripts.push_dac_to_hub WEIGHTS OUT_DIR \\
        [--prefix model.] [--push-to REPO] [--device cuda]

A `.safetensors` file is read by the port's own reader, a `.pth` by
`torch.load(weights_only=True)` (its `state_dict` when it holds one). The
weight norm is folded in float64 on the device under `DACConfig()`'s layout
(`codec/convert.py`), and the tree is pickled as numpy fp32 under the flax
names; `dac_params.pkl` beside a native checkpoint's `params.pkl` is its
codec. `--push-to` uploads the directory; a failed push is logged and
skipped.
"""

from __future__ import annotations

import argparse
import os
import pickle
from typing import Dict

import torch

from ..codec.convert import convert_dac_params
from ..config import DACConfig
from ..convert import numpy_tree
from ..runtime.checkpoint import read_safetensors
from ..runtime.generate import resolve_device
from ..utils.hf_export import push_folder


def read_weights(path: str) -> Dict[str, torch.Tensor]:
    """The state dict of a descript `.pth` (tensors only) or `.safetensors`."""
    if path.endswith(".safetensors"):
        return read_safetensors(path)
    blob = torch.load(path, map_location="cpu", weights_only=True)
    state = blob.get("state_dict", blob)
    return {k: v for k, v in state.items() if isinstance(v, torch.Tensor)}


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("weights", type=str, help="descript .pth or .safetensors weights")
    parser.add_argument("output_dir", type=str)
    parser.add_argument("--prefix", type=str, default="",
                        help="key prefix inside the state dict (e.g. 'model.')")
    parser.add_argument("--push-to", type=str, default=None)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    dev = resolve_device(args.device)
    tensors = {k: v.to(dev) for k, v in read_weights(args.weights).items()}
    params = numpy_tree(convert_dac_params(tensors, DACConfig(), prefix=args.prefix))
    os.makedirs(args.output_dir, exist_ok=True)
    with open(os.path.join(args.output_dir, "dac_params.pkl"), "wb") as f:
        pickle.dump(params, f, protocol=4)
    n = sum(leaf.size for leaf in _leaves(params))
    print(f"converted {n / 1e6:.1f}M params -> {args.output_dir}")
    if args.push_to:
        push_folder(args.output_dir, args.push_to)
    return params


def _leaves(tree):
    for value in tree.values():
        if isinstance(value, dict):
            yield from _leaves(value)
        else:
            yield value


if __name__ == "__main__":
    main()
