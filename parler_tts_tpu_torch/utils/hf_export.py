"""The flax-named trees -> HF/torch Parler-TTS tensors (port of
`parler_tts_tpu/utils/hf_export.py`), the inverse of the HF name maps
(`utils/hf_bridge.py`, `models/t5_encoder.py`, `models/parler.py`): stacked
tables and heads are unstacked per codebook and (in, out) kernels become
torch's (out, in). Leaves may be arrays or tensors; the outputs are tensors
in the leaves' dtypes (views where only the layout changes). `push_folder`
uploads an exported directory to the hub."""

from __future__ import annotations

import logging
from typing import Dict, Mapping

import torch

from ..config import ParlerTTSConfig, T5Config
from ..convert import as_tensor

logger = logging.getLogger(__name__)


def _t(w) -> torch.Tensor:
    return as_tensor(w).t()


def _ln(tree: Mapping, out: Dict[str, torch.Tensor], prefix: str) -> None:
    out[prefix + ".weight"] = as_tensor(tree["scale"])
    out[prefix + ".bias"] = as_tensor(tree["bias"])


def export_decoder_to_hf_tensors(params: Mapping, config, prefix: str = "model.decoder.",
                                 lm_head_prefix: str = "") -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    dec = params["decoder"]
    embed = as_tensor(dec["embed_tokens"])  # (K, rows, D)
    for k in range(config.num_codebooks):
        out[f"{prefix}embed_tokens.{k}.weight"] = embed[k]
    _ln(dec["layer_norm"], out, f"{prefix}layer_norm")
    for i in range(config.num_hidden_layers):
        lp, layer = f"{prefix}layers.{i}", dec[f"layers_{i}"]
        for attn in ("self_attn", "encoder_attn"):
            for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
                out[f"{lp}.{attn}.{name}.weight"] = _t(layer[attn][name]["kernel"])
            _ln(layer[f"{attn}_layer_norm"], out, f"{lp}.{attn}_layer_norm")
        out[f"{lp}.fc1.weight"] = _t(layer["fc1"]["kernel"])
        out[f"{lp}.fc2.weight"] = _t(layer["fc2"]["kernel"])
        _ln(layer["final_layer_norm"], out, f"{lp}.final_layer_norm")
    heads = as_tensor(params["lm_heads"])  # (K, D, V)
    for k in range(config.num_codebooks):
        out[f"{lm_head_prefix}lm_heads.{k}.weight"] = heads[k].t()
    return out


def export_t5_to_hf_tensors(params: Mapping, config: T5Config, prefix: str = ""
                            ) -> Dict[str, torch.Tensor]:
    shared = as_tensor(params["shared_embedding"])
    out: Dict[str, torch.Tensor] = {
        prefix + "shared.weight": shared,
        prefix + "encoder.embed_tokens.weight": shared,
        prefix + "encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight":
            as_tensor(params["relative_attention_bias"]),
        prefix + "encoder.final_layer_norm.weight":
            as_tensor(params["final_layer_norm"]["weight"]),
    }
    ff = ("wi_0", "wi_1", "wo") if config.is_gated_act else ("wi", "wo")
    for i in range(config.num_layers):
        bp, block = f"{prefix}encoder.block.{i}.", params[f"block_{i}"]
        for name in ("q", "k", "v", "o"):
            out[bp + f"layer.0.SelfAttention.{name}.weight"] = _t(
                block["attention"][name]["kernel"])
        out[bp + "layer.0.layer_norm.weight"] = as_tensor(block["ln_attn"]["weight"])
        for name in ff:
            out[bp + f"layer.1.DenseReluDense.{name}.weight"] = _t(block["ff"][name]["kernel"])
        out[bp + "layer.1.layer_norm.weight"] = as_tensor(block["ln_ff"]["weight"])
    return out


def export_composite_to_hf_tensors(params: Mapping, config: ParlerTTSConfig
                                   ) -> Dict[str, torch.Tensor]:
    """A `ParlerTTS` tree -> the composite checkpoint's `text_encoder.*`,
    `decoder.*`, `embed_prompts.*` and (when the model projects the encoder
    states) `enc_to_dec_proj.*` tensors."""
    out = export_t5_to_hf_tensors(params["text_encoder"], config.text_encoder, "text_encoder.")
    out.update(export_decoder_to_hf_tensors(
        params["decoder"], config.decoder, prefix="decoder.model.decoder.",
        lm_head_prefix="decoder."))
    out["embed_prompts.weight"] = as_tensor(params["embed_prompts"]["embedding"])
    if "enc_to_dec_proj" in params:
        out["enc_to_dec_proj.weight"] = _t(params["enc_to_dec_proj"]["kernel"])
        out["enc_to_dec_proj.bias"] = as_tensor(params["enc_to_dec_proj"]["bias"])
    return out


def push_folder(folder: str, repo_id: str) -> None:
    """Upload `folder` to the hub repo `repo_id`, created if missing. A push
    that fails (no `huggingface_hub`, no network) is logged and skipped, as
    the JAX package skips it: the exported directory is the result."""
    try:
        from huggingface_hub import HfApi

        api = HfApi()
        api.create_repo(repo_id, exist_ok=True)
        api.upload_folder(folder_path=folder, repo_id=repo_id)
        logger.info("pushed %s to hub repo %s", folder, repo_id)
    except Exception as e:  # noqa: BLE001 - a push is optional, as in the JAX package
        logger.warning("hub push skipped: %s", e)
