"""The port's Encodec codec (`parler_tts_tpu_torch/codec/encodec_model.py`)
against the JAX package's flax modules, fp32 on the CPU, module by module and
end to end, on a small geometry (16 kHz, 8 filters, hidden 16, ratios 4 x 4,
4 codebooks of 64), causal and not, mono and normalised stereo.

Weights come from the port's own init, drawn from a seed and carried to the
JAX modules as a flax-named numpy tree (the converters are held on a
synthetic HF-named state dict in the `weight_g` / `weight_v` form).

Tolerances: every float output within 1e-5 of the JAX output's norm
(||port - jax|| / ||jax||); codes fed the same latents are equal exactly,
and the codes of a whole encode are equal too (the distance formula and
argmin order are JAX's); converted trees equal leaf for leaf.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parler_tts_tpu.codec import encodec_model as je
from parler_tts_tpu.codec import registry as jreg
from parler_tts_tpu_torch.codec import encodec_model as te
from parler_tts_tpu_torch.codec import registry as treg
from parler_tts_tpu_torch.codec.dac_model import DACModel
from parler_tts_tpu_torch.config import DACConfig
from parler_tts_tpu_torch.convert import dac_to_jax_tree, load_jax_dac_params, load_jax_params

REL = 1e-5

SMALL = dict(sampling_rate=16000, num_filters=8, hidden_size=16, upsampling_ratios=(4, 4),
             codebook_size=64, codebook_dim=16, num_codebooks=4)


def configs(**kw):
    """(JAX config, port config) with the same fields."""
    fields = dict(SMALL, **kw)
    return je.EncodecCodecConfig(**fields), te.EncodecCodecConfig(**fields)


def norm_rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def host(tree):
    return jax.tree.map(np.asarray, tree)


def jax_codec(jcfg, seed=0):
    """A JAX codec and a params tree for it, drawn by the port's init from a
    seed (a flax init would compile the whole codec) and carried across as
    numpy under the flax names."""
    tcfg = te.EncodecCodecConfig(**dataclasses.asdict(jcfg))
    codec = treg.init_codec_params(te.EncodecCodec(tcfg), torch.Generator().manual_seed(seed))
    return je.EncodecCodec(jcfg), dac_to_jax_tree(codec)


def port_codec(tcfg, params):
    codec = te.EncodecCodec(tcfg)
    load_jax_dac_params(codec, params)
    return codec.eval()


def audio(b, t, c, seed=0, scale=0.2):
    return (np.random.default_rng(seed).normal(size=(b, t, c)) * scale).astype(np.float32)


# --------------------------------------------------------------- modules
CONV_CASES = {
    # name: (config fields, c_in, c_out, kernel, stride, dilation, T)
    "causal_reflect": (dict(), 3, 5, 7, 1, 1, 37),
    "causal_strided": (dict(), 3, 5, 8, 4, 1, 41),
    "causal_dilated": (dict(), 3, 5, 3, 1, 2, 29),
    "noncausal_reflect": (dict(use_causal_conv=False), 3, 5, 7, 1, 1, 37),
    "noncausal_strided": (dict(use_causal_conv=False), 3, 5, 10, 5, 1, 43),
    "reflect_too_short": (dict(), 3, 5, 7, 1, 1, 3),
    "reflect_too_short_noncausal": (dict(use_causal_conv=False), 3, 5, 7, 1, 1, 2),
    "constant_pad": (dict(pad_mode="constant"), 3, 5, 7, 2, 1, 23),
}


@pytest.mark.parametrize("name", list(CONV_CASES))
def test_conv1d_matches_jax(name):
    fields, c_in, c_out, k, stride, dilation, t = CONV_CASES[name]
    jcfg, tcfg = configs(**fields)
    x = audio(2, t, c_in, seed=1)
    jmod = je.EncodecConv1d(jcfg, c_out, k, stride=stride, dilation=dilation)
    params = host(jmod.init(jax.random.key(3), jnp.asarray(x))["params"])
    params["bias"] = np.random.default_rng(4).normal(size=c_out).astype(np.float32)
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
    tmod = te.EncodecConv1d(tcfg, c_in, c_out, k, stride=stride, dilation=dilation)
    load_jax_params(tmod, params)
    got = tmod(torch.from_numpy(x).transpose(1, 2)).transpose(1, 2).numpy()
    assert got.shape == want.shape
    assert norm_rel(got, want) < REL


@pytest.mark.parametrize("causal,ratio,k,stride", [
    (True, 1.0, 8, 4), (True, 0.5, 10, 5), (False, 1.0, 8, 4), (False, 1.0, 7, 2)])
def test_conv_transpose1d_trims_as_jax(causal, ratio, k, stride):
    jcfg, tcfg = configs(use_causal_conv=causal, trim_right_ratio=ratio)
    x = audio(2, 9, 6, seed=2)
    jmod = je.EncodecConvTranspose1d(jcfg, 4, k, stride=stride)
    params = host(jmod.init(jax.random.key(5), jnp.asarray(x))["params"])
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
    tmod = te.EncodecConvTranspose1d(tcfg, 6, 4, k, stride=stride)
    load_jax_params(tmod, params)
    got = tmod(torch.from_numpy(x).transpose(1, 2)).transpose(1, 2).numpy()
    assert got.shape == want.shape == (2, 9 * stride, 4)
    assert norm_rel(got, want) < REL


def test_resnet_block_matches_jax():
    jcfg, tcfg = configs()
    x = audio(2, 19, 8, seed=3)
    jmod = je.EncodecResnetBlock(jcfg, 8, (2, 1))
    params = host(jmod.init(jax.random.key(6), jnp.asarray(x))["params"])
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
    tmod = te.EncodecResnetBlock(tcfg, 8, (2, 1))
    load_jax_params(tmod, params)
    got = tmod(torch.from_numpy(x).transpose(1, 2)).transpose(1, 2).numpy()
    assert norm_rel(got, want) < REL


@pytest.mark.parametrize("layers", [1, 2])
def test_lstm_matches_jax_scan(layers):
    jcfg, tcfg = configs(num_lstm_layers=layers)
    x = audio(2, 23, 16, seed=4, scale=1.0)
    jmod = je.EncodecLSTM(jcfg, 16)
    params = host(jmod.init(jax.random.key(7), jnp.asarray(x))["params"])
    rng = np.random.default_rng(8)
    params = {k: (v + rng.normal(size=v.shape) * 0.1).astype(np.float32)
              for k, v in params.items()}  # non-zero biases
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
    tmod = te.EncodecLSTM(tcfg, 16)
    load_jax_params(tmod, params)
    got = tmod(torch.from_numpy(x)).detach().numpy()
    assert norm_rel(got, want) < REL


# ------------------------------------------------------------- the codec
@pytest.fixture(scope="module")
def codec_pair():
    jcfg, tcfg = configs()
    jcodec, params = jax_codec(jcfg)
    return jcfg, jcodec, params, port_codec(tcfg, params)


def test_rvq_codes_are_exact_on_the_same_latents(codec_pair):
    jcfg, jcodec, params, tcodec = codec_pair
    latents = np.random.default_rng(9).normal(size=(2, 31, 16)).astype(np.float32) * 2
    want = np.asarray(jcodec.apply({"params": params}, jnp.asarray(latents),
                                   method=lambda m, z: m.quantizer.encode(z)))
    got = tcodec.quantizer.encode(torch.from_numpy(latents)).numpy()
    np.testing.assert_array_equal(got, want)
    dec_want = np.asarray(jcodec.apply({"params": params}, jnp.asarray(want),
                                       method=lambda m, c: m.quantizer.from_codes(c)))
    dec_got = tcodec.quantizer.from_codes(torch.from_numpy(got)).numpy()
    assert norm_rel(dec_got, dec_want) < REL


@pytest.mark.parametrize("causal", [True, False])
def test_encode_and_decode_match_jax(causal):
    jcfg, tcfg = configs(use_causal_conv=causal)
    jcodec, params = jax_codec(jcfg, seed=1)
    tcodec = port_codec(tcfg, params)
    x = audio(2, 16 * 37, 1, seed=5)
    lat_want = np.asarray(jcodec.apply({"params": params}, jnp.asarray(x),
                                       method=lambda m, a: m.encoder(a)))
    with torch.inference_mode():
        lat_got = tcodec.encoder(torch.from_numpy(x)).numpy()
        codes = tcodec.encode(torch.from_numpy(x)).numpy()
    assert norm_rel(lat_got, lat_want) < REL
    codes_want = np.asarray(jcodec.apply({"params": params}, jnp.asarray(x), method="encode"))
    np.testing.assert_array_equal(codes, codes_want)
    want = np.asarray(jcodec.apply({"params": params}, jnp.asarray(codes_want),
                                   method="decode"))
    with torch.inference_mode():
        got = tcodec.decode(torch.from_numpy(codes)).numpy()
    assert got.shape == want.shape == (2, 37 * 16, 1)
    assert norm_rel(got, want) < REL


def test_normalize_stereo_scales_and_decode_match_jax():
    jcfg, tcfg = configs(audio_channels=2, normalize=True)
    jcodec, params = jax_codec(jcfg, seed=2)
    tcodec = port_codec(tcfg, params)
    x = audio(2, 16 * 21, 2, seed=6)
    x[1] *= 7.0  # scales that differ by row
    codes_want, scales_want = jcodec.apply({"params": params}, jnp.asarray(x),
                                           method="encode_with_scale")
    with torch.inference_mode():
        codes, scales = tcodec.encode_with_scale(torch.from_numpy(x))
        np.testing.assert_array_equal(tcodec.encode(torch.from_numpy(x)).numpy(),
                                      np.asarray(codes_want))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(codes_want))
    np.testing.assert_allclose(scales.numpy(), np.asarray(scales_want), rtol=1e-6)
    want = np.asarray(jcodec.apply({"params": params}, codes_want, scales_want,
                                   method="decode"))
    with torch.inference_mode():
        got = tcodec.decode(codes, scales).numpy()
    assert got.shape == want.shape == (2, 21 * 16, 2)
    assert norm_rel(got, want) < REL
    # the round trip through __call__ re-applies the scale, as JAX's does
    rt_want = np.asarray(jcodec.apply({"params": params}, jnp.asarray(x)))
    with torch.inference_mode():
        rt = tcodec(torch.from_numpy(x)).numpy()
    assert norm_rel(rt, rt_want) < REL


def test_codec_tree_round_trips(codec_pair):
    _, _, params, tcodec = codec_pair
    back = dac_to_jax_tree(tcodec)
    flat_a, flat_b = jax.tree_util.tree_leaves_with_path(params), dict(
        jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)


# -------------------------------------------------------------- convert
def hf_state_dict(tree, cfg, prefix=""):
    """A synthetic HF-named `EncodecModel` state dict from a JAX-named tree:
    every conv weight-norm parametrized as `weight_g` / `weight_v`, with v
    scaled by 1.7 so the fold does real work; the ELU modules own layer
    indices, as in HF's `layers` lists."""
    out = {}

    def conv(name, leaf, dims=(2, 1, 0)):
        w = torch.from_numpy(np.asarray(leaf["kernel"])).permute(*dims).contiguous()
        g = w.double().square().sum(dim=(1, 2), keepdim=True).sqrt().float()
        out[f"{prefix}{name}.conv.weight_g"], out[f"{prefix}{name}.conv.weight_v"] = g, w * 1.7
        out[f"{prefix}{name}.conv.bias"] = torch.from_numpy(np.asarray(leaf["bias"]))

    def resnet(name, leaf):
        conv(f"{name}.block.1", leaf["block_0"])
        conv(f"{name}.block.3", leaf["block_1"])
        conv(f"{name}.shortcut", leaf["shortcut"])

    def lstm(name, leaf):
        for key, value in leaf.items():
            hf = key.replace("w_", "weight_").replace("b_", "bias_")
            out[f"{prefix}{name}.lstm.{hf}"] = torch.from_numpy(np.asarray(value))

    enc, dec, n = tree["encoder"], tree["decoder"], len(cfg.upsampling_ratios)
    conv("encoder.layers.0", enc["conv_in"])
    li = 1
    for i in range(n):
        resnet(f"encoder.layers.{li}", enc[f"res_{i}_0"])
        conv(f"encoder.layers.{li + 2}", enc[f"down_{i}"])
        li += 3
    lstm(f"encoder.layers.{li}", enc["lstm"])
    conv(f"encoder.layers.{li + 2}", enc["conv_out"])
    conv("decoder.layers.0", dec["conv_in"])
    lstm("decoder.layers.1", dec["lstm"])
    li = 3
    for i in range(n):
        conv(f"decoder.layers.{li}", dec[f"up_{i}"], dims=(1, 2, 0))
        resnet(f"decoder.layers.{li + 1}", dec[f"res_{i}_0"])
        li += 3
    conv(f"decoder.layers.{li}", dec["conv_out"])
    for k, cb in enumerate(np.asarray(tree["quantizer"]["codebooks"])):
        out[f"{prefix}quantizer.layers.{k}.codebook.embed"] = torch.from_numpy(cb)
    return out


def leaves(tree):
    return dict(jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, tree)))


def test_convert_encodec_params_matches_jax(codec_pair):
    jcfg, _, params, _ = codec_pair
    _, tcfg = configs()
    sd = hf_state_dict(params, tcfg)
    want = je.convert_encodec_params({k: v.numpy() for k, v in sd.items()}, jcfg, prefix="")
    got = leaves(te.convert_encodec_params(sd, tcfg, prefix=""))
    want = leaves(want)
    assert got.keys() == want.keys() == leaves(params).keys()
    for path, leaf in want.items():
        np.testing.assert_allclose(got[path], leaf, rtol=1e-6, atol=1e-7,
                                   err_msg=jax.tree_util.keystr(path))
        np.testing.assert_allclose(got[path], leaves(params)[path], rtol=1e-5, atol=1e-6)
    codec = te.EncodecCodec(tcfg)
    load_jax_dac_params(codec, te.convert_encodec_params(sd, tcfg, prefix=""))


# -------------------------------------------------------------- registry
def test_registry_dispatches_like_jax():
    jcfg, tcfg = configs(audio_channels=2)
    dac = DACConfig(num_codebooks=4, codebook_size=64)
    assert treg.codec_kind(tcfg) == jreg.codec_kind(jcfg) == "encodec"
    assert treg.codec_kind(dac) == "dac"
    assert treg.codec_channels(tcfg) == jreg.codec_channels(jcfg) == 2
    assert treg.codec_channels(dac) == 1
    assert isinstance(treg.build_codec(tcfg), te.EncodecCodec)
    assert isinstance(treg.build_codec(dac), DACModel)
    assert tcfg.hop_length == jcfg.hop_length == 16
    assert tcfg.frame_rate == jcfg.frame_rate == 1000
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(te.EncodecCodecConfig()) == dataclasses.asdict(
        je.EncodecCodecConfig())
    # an Encodec state dict sits directly under audio_encoder., DAC's under .model.
    _, small = configs()
    init = treg.init_codec_params(treg.build_codec(small), torch.Generator().manual_seed(0))
    assert all(torch.isfinite(p).all() for p in init.parameters())
    tree = dac_to_jax_tree(init)
    sd = hf_state_dict(tree, small, prefix="audio_encoder.")
    got = leaves(treg.convert_codec_params(sd, small))
    for path, leaf in leaves(tree).items():
        np.testing.assert_allclose(got[path], leaf, rtol=1e-5, atol=1e-6)
