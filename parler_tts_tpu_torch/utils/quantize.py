"""Int8 weight-only quantization for serving (port of
`parler_tts_tpu/utils/quantize.py`).

Symmetric per-output-channel scales:

    scale[o] = max(max_i |w[i, o]| / 127, 1e-12)      (fp32)
    w_q[i, o] = clip(round_half_even(w[i, o] / scale[o]), -127, 127)   (int8)

Two forms with the same arithmetic, bit for bit: `quantize_kernel`,
`quantize_stacked_heads` (a scale per LM head and column) and
`quantize_decoder_params` take numpy arrays and trees (the JAX package's
parameter trees, as numpy); `quantize_kernel_torch` quantizes a float kernel
on its own device (`models.decoder.QuantDense` initialises through it, and
`quantize_decoder_params_torch` quantizes a loaded tree through it). Only the decoder
layers' attention projections and MLP are quantized; embeddings, layer norms
and the LM heads stay in their float dtype.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from ..convert import as_tensor

QUANT_DENSE_NAMES = frozenset({"q_proj", "k_proj", "v_proj", "out_proj", "fc1", "fc2"})


def quantize_kernel(w: np.ndarray) -> Dict[str, np.ndarray]:
    """(in, out) float kernel -> {'w_q': int8 (in, out), 'scale': (out,) fp32}."""
    w = np.asarray(w, np.float32)
    scale = np.maximum(np.abs(w).max(axis=0) / np.float32(127.0), np.float32(1e-12))
    w_q = np.clip(np.round(w / scale[None, :]), -127, 127).astype(np.int8)
    return {"w_q": w_q, "scale": scale.astype(np.float32)}


def quantize_stacked_heads(w: np.ndarray) -> Dict[str, np.ndarray]:
    """(K, D, V) stacked LM heads -> {'w_q': int8 (K, D, V), 'scale': (K, 1, V)
    fp32}: a scale per head and output column, the arithmetic of
    `quantize_kernel`."""
    w = np.asarray(w, np.float32)
    scale = np.maximum(np.abs(w).max(axis=1, keepdims=True) / np.float32(127.0),
                       np.float32(1e-12))
    w_q = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
    return {"w_q": w_q, "scale": scale.astype(np.float32)}


def dequantize_for_reference(qtree: Mapping[str, Any]) -> torch.Tensor:
    """{'w_q', 'scale'} (arrays or tensors) -> the fp32 kernel w_q * scale,
    on the leaves' device: the float weights a quantized result is held to."""
    return as_tensor(qtree["w_q"]).float() * as_tensor(qtree["scale"]).float()


def quantize_kernel_torch(w: torch.Tensor):
    """Torch form of `quantize_kernel`, on w's device: (w_q int8, scale fp32)."""
    w = w.float()
    scale = (w.abs().amax(dim=0) / 127.0).clamp_min(1e-12)
    # torch.round rounds half to even, as np.round does
    w_q = torch.round(w / scale[None, :]).clamp(-127, 127).to(torch.int8)
    return w_q, scale


def _map_layer_kernels(tree: Mapping[str, Any], fn, leaf_fn, path=()) -> Dict[str, Any]:
    out = {}
    for key, value in tree.items():
        if (key in QUANT_DENSE_NAMES and isinstance(value, Mapping) and "kernel" in value
                and any(p.startswith("layers_") for p in path)):
            out[key] = fn(value["kernel"])
        elif isinstance(value, Mapping):
            out[key] = _map_layer_kernels(value, fn, leaf_fn, path + (key,))
        else:
            out[key] = leaf_fn(value)
    return out


def quantize_decoder_params(params: Mapping[str, Any]) -> Dict[str, Any]:
    """A `ParlerTTS` (or decoder) parameter tree, as numpy, in the layout of a
    `weight_quant=True` model: every q/k/v/out/fc1/fc2 `{'kernel'}` under a
    `layers_<i>` node becomes `{'w_q', 'scale'}`."""
    return _map_layer_kernels(params, lambda k: quantize_kernel(np.asarray(k)), np.asarray)


def quantize_decoder_params_torch(params: Mapping[str, Any], device) -> Dict[str, Any]:
    """`quantize_decoder_params` on `device`: each kernel (an array or a
    tensor, of any float dtype) is moved there and quantized there by
    `quantize_kernel_torch`; the other leaves are left as they are."""

    def quant(kernel):
        k = kernel if isinstance(kernel, torch.Tensor) else torch.from_numpy(np.asarray(kernel))
        w_q, scale = quantize_kernel_torch(k.to(device))
        return {"w_q": w_q, "scale": scale}

    return _map_layer_kernels(params, quant, lambda leaf: leaf)

