"""HF/torch Parler-TTS decoder tensors -> the flax-named decoder tree (port of
`parler_tts_tpu/utils/hf_bridge.py`).

  - K separate codebook embedding tables -> one (K, vocab+1, D) tensor
  - per-codebook or fused LM heads       -> one (K, D, V) tensor
  - torch Linear (out, in) weights       -> (in, out) kernels

Tensors in, tensors out (`convert.load_jax_params` takes the tree): the
kernels are transposed views of the checkpoint's tensors, not copies.
`torch_state_dict_to_numpy` copies a state dict to the host as numpy.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from ..config import DecoderConfig


def _ln(tensors: Mapping[str, torch.Tensor], prefix: str) -> Dict[str, torch.Tensor]:
    return {"scale": tensors[prefix + ".weight"], "bias": tensors[prefix + ".bias"]}


def _attn(tensors: Mapping[str, torch.Tensor], prefix: str) -> Dict:
    return {name: {"kernel": tensors[f"{prefix}.{name}.weight"].t()}
            for name in ("q_proj", "k_proj", "v_proj", "out_proj")}


def convert_decoder_params(tensors: Mapping[str, torch.Tensor], config: DecoderConfig,
                           prefix: str = "model.decoder.", lm_head_prefix: str = "") -> Dict:
    """A `ParlerTTSForCausalLM` state dict -> the `ParlerForCausalLM` tree.

    `prefix` locates the decoder stack (`decoder.model.decoder.` inside the
    composite checkpoint), `lm_head_prefix` the LM heads (`decoder.`)."""
    k = config.num_codebooks
    embed = torch.stack([tensors[f"{prefix}embed_tokens.{i}.weight"] for i in range(k)])
    fused_key = f"{lm_head_prefix}lm_heads.weight"
    if fused_key in tensors:
        # fused head: (K*V, D), row k*V + v
        lm_heads = tensors[fused_key].reshape(k, config.vocab_size,
                                              config.hidden_size).permute(0, 2, 1)
    else:
        lm_heads = torch.stack([tensors[f"{lm_head_prefix}lm_heads.{i}.weight"].t()
                                for i in range(k)])
    decoder: Dict = {"embed_tokens": embed, "layer_norm": _ln(tensors, f"{prefix}layer_norm")}
    for i in range(config.num_hidden_layers):
        lp = f"{prefix}layers.{i}."
        decoder[f"layers_{i}"] = {
            "self_attn": _attn(tensors, lp + "self_attn"),
            "self_attn_layer_norm": _ln(tensors, lp + "self_attn_layer_norm"),
            "encoder_attn": _attn(tensors, lp + "encoder_attn"),
            "encoder_attn_layer_norm": _ln(tensors, lp + "encoder_attn_layer_norm"),
            "fc1": {"kernel": tensors[lp + "fc1.weight"].t()},
            "fc2": {"kernel": tensors[lp + "fc2.weight"].t()},
            "final_layer_norm": _ln(tensors, lp + "final_layer_norm"),
        }
    return {"decoder": decoder, "lm_heads": lm_heads}


def torch_state_dict_to_numpy(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """A state dict's tensors, detached, as host numpy arrays in their dtypes."""
    return {k: v.detach().cpu().numpy() for k, v in state_dict.items()}
