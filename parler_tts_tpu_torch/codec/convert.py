"""descript-DAC checkpoint tensors <-> the JAX codec's parameter tree (port
of `parler_tts_tpu/codec/convert.py`): encoder, quantizer and decoder.

The torch weight-norm parametrization is folded into plain kernels, in
float64 (w = g * v / ||v||, the norm over every dim but 0, torch's
weight_norm with dim=0), from either form a checkpoint holds:
`parametrizations.weight.original{0,1}` or `weight_g`/`weight_v`. Names
follow descript's `DAC` module tree (`decoder.model.N...`,
`quantizer.quantizers.K...`, `encoder.block.N...`) under the `model.` prefix
of the DAC wrapper.

Tensors in, tensors out: the tree's leaves view the checkpoint's tensors
where only the layout changes, and the folded kernels are new fp32 (or the
checkpoint's dtype) tensors.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch

from ..config import DACConfig
from ..convert import as_tensor


def _folded_weight(tensors: Mapping[str, torch.Tensor], prefix: str) -> torch.Tensor:
    """`{prefix}.weight`, folding the weight norm if it is parametrized."""
    if f"{prefix}.parametrizations.weight.original0" in tensors:
        g = tensors[f"{prefix}.parametrizations.weight.original0"]
        v = tensors[f"{prefix}.parametrizations.weight.original1"]
    elif f"{prefix}.weight_g" in tensors:
        g, v = tensors[f"{prefix}.weight_g"], tensors[f"{prefix}.weight_v"]
    else:
        return tensors[f"{prefix}.weight"]
    v64 = v.double()
    norm = v64.square().sum(dim=tuple(range(1, v.dim())), keepdim=True).sqrt()
    return (g.double() * (v64 / norm)).to(v.dtype)


def _conv(tensors, prefix) -> Dict[str, torch.Tensor]:
    """torch Conv1d (out, in, k) -> (k, in, out)."""
    return {"kernel": _folded_weight(tensors, prefix).permute(2, 1, 0),
            "bias": tensors[f"{prefix}.bias"]}


def _conv_transpose(tensors, prefix) -> Dict[str, torch.Tensor]:
    """torch ConvTranspose1d (in, out, k) -> (k, in, out)."""
    return {"kernel": _folded_weight(tensors, prefix).permute(2, 0, 1),
            "bias": tensors[f"{prefix}.bias"]}


def _snake(tensors, prefix) -> Dict[str, torch.Tensor]:
    """torch alpha (1, C, 1) -> (1, 1, C)."""
    return {"alpha": tensors[f"{prefix}.alpha"].permute(0, 2, 1)}


def _residual_unit(tensors, prefix) -> Dict:
    return {
        "snake1": _snake(tensors, f"{prefix}.block.0"),
        "conv1": _conv(tensors, f"{prefix}.block.1"),
        "snake2": _snake(tensors, f"{prefix}.block.2"),
        "conv2": _conv(tensors, f"{prefix}.block.3"),
    }


def convert_dac_params(tensors: Mapping[str, torch.Tensor], config: DACConfig,
                       prefix: str = "model.") -> Dict:
    """descript-DAC state dict -> the JAX `DACModel` tree (`encoder`,
    `quantizer` codebooks and in/out projections, `decoder`). `prefix` is
    `model.` for a bare DAC wrapper checkpoint and `audio_encoder.model.`
    inside the composite Parler checkpoint."""
    p = prefix
    encoder: Dict = {"conv_in": _conv(tensors, f"{p}encoder.block.0")}
    for i in range(len(config.encoder_rates)):
        bp = f"{p}encoder.block.{1 + i}"
        encoder[f"block_{i}"] = {
            "res1": _residual_unit(tensors, f"{bp}.block.0"),
            "res2": _residual_unit(tensors, f"{bp}.block.1"),
            "res3": _residual_unit(tensors, f"{bp}.block.2"),
            "snake": _snake(tensors, f"{bp}.block.3"),
            "down": _conv(tensors, f"{bp}.block.4"),
        }
    n_enc = 1 + len(config.encoder_rates)
    encoder["snake_out"] = _snake(tensors, f"{p}encoder.block.{n_enc}")
    encoder["conv_out"] = _conv(tensors, f"{p}encoder.block.{n_enc + 1}")

    decoder: Dict = {"conv_in": _conv(tensors, f"{p}decoder.model.0")}
    for i in range(len(config.decoder_rates)):
        bp = f"{p}decoder.model.{1 + i}"
        decoder[f"block_{i}"] = {
            "snake": _snake(tensors, f"{bp}.block.0"),
            "up": _conv_transpose(tensors, f"{bp}.block.1"),
            "res1": _residual_unit(tensors, f"{bp}.block.2"),
            "res2": _residual_unit(tensors, f"{bp}.block.3"),
            "res3": _residual_unit(tensors, f"{bp}.block.4"),
        }
    n_dec = 1 + len(config.decoder_rates)
    decoder["snake_out"] = _snake(tensors, f"{p}decoder.model.{n_dec}")
    decoder["conv_out"] = _conv(tensors, f"{p}decoder.model.{n_dec + 1}")

    cbs, ipk, ipb, opk, opb = [], [], [], [], []
    for k in range(config.num_codebooks):
        qp = f"{p}quantizer.quantizers.{k}"
        cbs.append(tensors[f"{qp}.codebook.weight"])
        ipk.append(_folded_weight(tensors, f"{qp}.in_proj")[:, :, 0].t())   # (latent, d_cb)
        ipb.append(tensors[f"{qp}.in_proj.bias"])
        opk.append(_folded_weight(tensors, f"{qp}.out_proj")[:, :, 0].t())  # (d_cb, latent)
        opb.append(tensors[f"{qp}.out_proj.bias"])
    quantizer = {
        "codebooks": torch.stack(cbs),
        "in_proj_kernel": torch.stack(ipk),
        "in_proj_bias": torch.stack(ipb),
        "out_proj_kernel": torch.stack(opk),
        "out_proj_bias": torch.stack(opb),
    }
    return {"encoder": encoder, "quantizer": quantizer, "decoder": decoder}


# --------------------------------------------------------------------- export
def _split_weight_norm(w: torch.Tensor, v_scale: float = 1.0):
    """A torch-layout weight -> (weight_g, weight_v) whose weight-norm fold
    g * v / ||v|| gives `w` back; `v_scale` != 1 makes the fold do real work."""
    g = w.double().square().sum(dim=tuple(range(1, w.dim())), keepdim=True).sqrt()
    return g.to(w.dtype), (w * v_scale).to(w.dtype)


def export_dac_params(params: Mapping, config: DACConfig, prefix: str = "model.",
                      weight_norm: bool = True, v_scale: float = 1.0
                      ) -> Dict[str, torch.Tensor]:
    """The inverse of `convert_dac_params`: a JAX-named DAC tree (arrays or
    tensors) -> descript-DAC tensors, weight-norm parametrized as
    `weight_g`/`weight_v` when `weight_norm`: encoder, quantizer and
    decoder."""
    out: Dict[str, torch.Tensor] = {}

    def put_conv(name: str, leaf: Mapping, dims):
        w = as_tensor(leaf["kernel"]).permute(*dims).contiguous()
        if weight_norm:
            out[f"{name}.weight_g"], out[f"{name}.weight_v"] = _split_weight_norm(w, v_scale)
        else:
            out[f"{name}.weight"] = w
        out[f"{name}.bias"] = as_tensor(leaf["bias"])

    def conv(name, leaf):  # (k, in, out) -> (out, in, k)
        put_conv(name, leaf, (2, 1, 0))

    def conv_t(name, leaf):  # (k, in, out) -> (in, out, k)
        put_conv(name, leaf, (1, 2, 0))

    def snake(name, leaf):
        out[f"{name}.alpha"] = as_tensor(leaf["alpha"]).permute(0, 2, 1).contiguous()

    def res_unit(name, leaf):
        snake(f"{name}.block.0", leaf["snake1"])
        conv(f"{name}.block.1", leaf["conv1"])
        snake(f"{name}.block.2", leaf["snake2"])
        conv(f"{name}.block.3", leaf["conv2"])

    p, enc = prefix, params["encoder"]
    conv(f"{p}encoder.block.0", enc["conv_in"])
    for i in range(len(config.encoder_rates)):
        bp, blk = f"{p}encoder.block.{1 + i}", enc[f"block_{i}"]
        res_unit(f"{bp}.block.0", blk["res1"])
        res_unit(f"{bp}.block.1", blk["res2"])
        res_unit(f"{bp}.block.2", blk["res3"])
        snake(f"{bp}.block.3", blk["snake"])
        conv(f"{bp}.block.4", blk["down"])
    n_enc = 1 + len(config.encoder_rates)
    snake(f"{p}encoder.block.{n_enc}", enc["snake_out"])
    conv(f"{p}encoder.block.{n_enc + 1}", enc["conv_out"])

    dec = params["decoder"]
    conv(f"{p}decoder.model.0", dec["conv_in"])
    for i in range(len(config.decoder_rates)):
        bp, blk = f"{p}decoder.model.{1 + i}", dec[f"block_{i}"]
        snake(f"{bp}.block.0", blk["snake"])
        conv_t(f"{bp}.block.1", blk["up"])
        res_unit(f"{bp}.block.2", blk["res1"])
        res_unit(f"{bp}.block.3", blk["res2"])
        res_unit(f"{bp}.block.4", blk["res3"])
    n_dec = 1 + len(config.decoder_rates)
    snake(f"{p}decoder.model.{n_dec}", dec["snake_out"])
    conv(f"{p}decoder.model.{n_dec + 1}", dec["conv_out"])

    q = {name: as_tensor(leaf) for name, leaf in params["quantizer"].items()}
    for k in range(config.num_codebooks):
        qp = f"{p}quantizer.quantizers.{k}"
        out[f"{qp}.codebook.weight"] = q["codebooks"][k]
        for proj in ("in_proj", "out_proj"):  # (d_cb, latent, 1) and (latent, d_cb, 1)
            w = q[f"{proj}_kernel"][k].t()[:, :, None].contiguous()
            if weight_norm:
                out[f"{qp}.{proj}.weight_g"], out[f"{qp}.{proj}.weight_v"] = \
                    _split_weight_norm(w, v_scale)
            else:
                out[f"{qp}.{proj}.weight"] = w
        for proj in ("in_proj", "out_proj"):
            out[f"{qp}.{proj}.bias"] = q[f"{proj}_bias"][k]
    return out
