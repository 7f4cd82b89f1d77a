"""The port's models against the JAX package's, with weights carried by
`parler_tts_tpu_torch.convert`: T5 encoder states, decoder prefill and
incremental (kernel K1) logits, the DAC decode waveform. fp32 on the CPU.
Tolerances: T5 states 1e-5; decoder logits 2e-4 (COMPONENTS.md row 5);
waveform 1e-5 (row 14)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parler_tts_tpu import config as jc
from parler_tts_tpu.codec.dac_model import ConvTranspose1d as JConvT
from parler_tts_tpu.codec.dac_model import DACModel as JDAC
from parler_tts_tpu.models.decoder import DecoderCache as JCache
from parler_tts_tpu.models.decoder import ParlerForCausalLM as JLM
from parler_tts_tpu.models.t5_encoder import T5Encoder as JT5
from parler_tts_tpu.ops.masks import causal_self_attention_bias, padding_cross_attention_bias
from parler_tts_tpu_torch import config as tc
from parler_tts_tpu_torch.codec.dac_model import ConvTranspose1d, DACModel
from parler_tts_tpu_torch.codec.encodec_model import EncodecCodecConfig
from parler_tts_tpu_torch.convert import load_jax_dac_params, load_jax_params
from parler_tts_tpu_torch.models.decoder import DecoderCache, ParlerForCausalLM
from parler_tts_tpu_torch.models.t5_encoder import T5Encoder
from parler_tts_tpu_torch.ops import masks as tmasks


def port_config(cfg):
    """The port's config with the same fields as a JAX package config."""
    d = dataclasses.asdict(cfg)
    if isinstance(cfg, jc.ParlerTTSConfig):
        return tc.ParlerTTSConfig(
            text_encoder=tc.T5Config(**d.pop("text_encoder")),
            audio_encoder=port_config(cfg.audio_encoder),
            decoder=tc.DecoderConfig(**d.pop("decoder")),
            **{k: v for k, v in d.items() if k != "audio_encoder"},
        )
    if getattr(cfg, "codec_type", None) == "encodec":
        return EncodecCodecConfig(**d)
    return getattr(tc, type(cfg).__name__)(**d)


def host(tree):
    return jax.tree.map(np.asarray, tree)


def t(x):
    return torch.from_numpy(np.array(x))


def output_in_unit_range(dac_params):
    """Scale the codec's last conv so its pre-tanh signal spans about +-1, as
    a trained codec's does. With lecun-init weights it reaches +-33 there,
    where fp32 rounding alone moves the waveform by ~6e-5 in both packages
    (measured against a float64 run of the port)."""
    params = host(dac_params)
    params["decoder"]["conv_out"]["kernel"] = params["decoder"]["conv_out"]["kernel"] / 32.0
    return params


# ------------------------------------------------------------------- T5
T5_CFG = jc.T5Config(vocab_size=120, d_model=48, d_kv=12, d_ff=96, num_layers=2,
                     num_heads=4, relative_attention_num_buckets=8,
                     relative_attention_max_distance=20, dropout_rate=0.0)


@pytest.mark.parametrize("gated", [True, False])
def test_t5_encoder_states(gated):
    cfg = dataclasses.replace(T5_CFG, feed_forward_proj="gated-gelu" if gated else "relu")
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 120, (2, 11)).astype(np.int32)
    mask = np.ones((2, 11), np.int32)
    mask[1, 7:] = 0
    jm = JT5(cfg)
    params = jm.init(jax.random.key(1), jnp.asarray(ids), jnp.asarray(mask))["params"]
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(ids), jnp.asarray(mask)))
    port = T5Encoder(port_config(cfg))
    load_jax_params(port, host(params))
    with torch.no_grad():
        got = port(t(ids).long(), t(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


# -------------------------------------------------------------- decoder
def dec_config(n_kv, rope):
    return jc.DecoderConfig(
        vocab_size=64, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=n_kv, ffn_dim=128, num_codebooks=3,
        max_position_embeddings=64, pad_token_id=60, bos_token_id=61, eos_token_id=60,
        rope_embeddings=rope, dropout=0.0,
    )


@pytest.mark.parametrize("rope", [False, True], ids=["sinusoidal", "rope"])
@pytest.mark.parametrize("n_kv", [4, 2, 1], ids=["mha", "gqa", "mqa"])
def test_decoder_prefill_and_incremental_logits(n_kv, rope):
    """Prefill through the bias path, then decode steps through K1 (the
    JAX model with use_flash_decode=True runs its Pallas kernel in interpret
    mode); left-padded row 0 makes its `starts` > 0."""
    cfg = dec_config(n_kv, rope)
    b, s_pre, n_steps, s_enc, s_max = 2, 5, 4, 6, 16
    rng = np.random.default_rng(n_kv * 2 + rope)
    ids = rng.integers(0, 62, (b, 3, s_pre + n_steps)).astype(np.int32)
    enc = rng.normal(size=(b, s_enc, 64)).astype(np.float32)
    enc_mask = np.ones((b, s_enc), np.int32)
    enc_mask[0, 4:] = 0
    kv_valid = np.ones((b, s_max), bool)
    kv_valid[0, :2] = False
    starts = np.array([2, 0], np.int32)

    jm = JLM(cfg, use_flash_decode=True)
    emb_init = jnp.zeros((b, s_pre, 64))
    pos_init = jnp.broadcast_to(jnp.arange(s_pre), (b, s_pre))
    params = jm.init(jax.random.key(3), emb_init, pos_init, self_attn_bias=None,
                     encoder_hidden_states=jnp.asarray(enc))["params"]
    port = ParlerForCausalLM(port_config(cfg))
    load_jax_params(port, host(params))

    def japply(*a, **kw):
        return jm.apply({"params": params}, *a, **kw)

    jcache = JCache.zeros(cfg, b, s_max, s_enc, jnp.float32, flat_self=True)
    ck, cv = japply(jnp.asarray(enc), method="precompute_cross_kv")
    jcache = jcache.replace(cross_k=ck, cross_v=cv)
    tcache = DecoderCache.zeros(port_config(cfg), b, s_max, s_enc, torch.float32)
    with torch.no_grad():
        tcache.cross_k, tcache.cross_v = port.precompute_cross_kv(t(enc))
    kv_valid_j = jnp.asarray(kv_valid)

    def step(lo, hi, flash):
        nonlocal jcache
        ids_j = jnp.asarray(ids[:, :, lo:hi])
        pos = np.broadcast_to(np.arange(lo, hi), (b, hi - lo))
        emb = japply(ids_j, method="embed_ids")
        bias = causal_self_attention_bias(jnp.asarray(pos), kv_valid_j)
        xbias = padding_cross_attention_bias(jnp.asarray(enc_mask), hi - lo)
        lengths = (jnp.asarray(starts), jnp.int32(hi)) if flash else None
        want, jcache = japply(emb, jnp.asarray(pos), self_attn_bias=bias,
                              cross_attn_bias=xbias, cache=jcache, decode_lengths=lengths)
        with torch.no_grad():
            temb = port.embed_ids(t(ids[:, :, lo:hi]).long())
            np.testing.assert_allclose(temb.numpy(), np.asarray(emb), atol=1e-6, rtol=0)
            got = port(
                temb, t(pos).long(),
                self_attn_bias=None if flash else tmasks.causal_self_attention_bias(
                    t(pos).long(), t(kv_valid)),
                cross_attn_bias=tmasks.padding_cross_attention_bias(t(enc_mask), hi - lo),
                cache=tcache, decode_lengths=(t(starts), hi) if flash else None,
            )
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=2e-4)

    step(0, s_pre, flash=False)
    for i in range(s_pre, s_pre + n_steps):
        step(i, i + 1, flash=True)
    assert tcache.index == s_pre + n_steps
    np.testing.assert_allclose(tcache.self_k.numpy(), np.asarray(jcache.self_k),
                               atol=1e-5, rtol=1e-5)


# ------------------------------------------------------------------ DAC
DAC_CFG = jc.DACConfig(num_codebooks=4, codebook_size=32, codebook_dim=4, latent_dim=64,
                       encoder_dim=4, encoder_rates=(2, 4, 4), decoder_dim=96,
                       decoder_rates=(4, 4, 2), sampling_rate=16000, frame_rate=500)


def dac_init(jdac):
    """The whole codec's params (encoder, quantizer, decoder), as the port
    loads them: flax draws each module's params from its own path, so the
    decode side's values are those of an init through `decode` alone."""
    audio = jnp.zeros((1, 2 * DAC_CFG.hop_length, 1))
    return jdac.init(jax.random.key(0), audio)["params"]


@pytest.mark.parametrize("stride", [2, 4, 8])
def test_conv_transpose_is_torch_conv_transpose1d_with_permuted_weight(stride):
    """JAX's flipped-kernel input-dilated conv == F.conv_transpose1d with
    weight[c_in, c_out, k] = kernel[k, c_in, c_out]."""
    rng = np.random.default_rng(stride)
    x = rng.normal(size=(2, 9, 6)).astype(np.float32)  # (B, T, C_in)
    jm = JConvT(5, 2 * stride, stride=stride, padding=(stride + 1) // 2)
    params = jm.init(jax.random.key(stride), jnp.asarray(x))["params"]
    params = host(params)
    params["bias"] = rng.normal(size=5).astype(np.float32)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    port = ConvTranspose1d(6, 5, 2 * stride, stride=stride, padding=(stride + 1) // 2)
    load_jax_params(port, params)
    with torch.no_grad():
        got = port(t(x).transpose(1, 2)).transpose(1, 2).numpy()
    assert got.shape == want.shape == (2, 9 * stride, 5)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_dac_decode_waveform():
    rng = np.random.default_rng(0)
    codes = rng.integers(0, DAC_CFG.codebook_size, (2, 4, 12)).astype(np.int32)
    jdac = JDAC(DAC_CFG)
    params = output_in_unit_range(dac_init(jdac))
    want = np.asarray(jdac.apply({"params": params}, jnp.asarray(codes), method="decode"))
    port = DACModel(port_config(DAC_CFG))
    load_jax_dac_params(port, params)
    with torch.no_grad():
        got = port.decode(t(codes).long()).numpy()
    assert got.shape == want.shape == (2, 12 * DAC_CFG.hop_length, 1)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)


def test_dac_decode_waveform_at_init_weights():
    """The same decode at the unscaled lecun-init weights, whose pre-tanh
    signal reaches +-33. There fp32 rounding moves each package's waveform by
    up to ~1.2e-4 from a float64 run, and the two packages differ by 1.3e-4 at
    most and 9e-6 in norm, relative to the waveform's norm (measured)."""
    rng = np.random.default_rng(0)
    codes = rng.integers(0, DAC_CFG.codebook_size, (2, 4, 12)).astype(np.int32)
    jdac = JDAC(DAC_CFG)
    params = host(dac_init(jdac))
    want = np.asarray(jdac.apply({"params": params}, jnp.asarray(codes), method="decode"))
    port = DACModel(port_config(DAC_CFG))
    load_jax_dac_params(port, params)
    with torch.no_grad():
        got = port.decode(t(codes).long()).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=5e-4, rtol=0)
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 4e-5


def test_converter_checks_every_leaf():
    jdac = JDAC(DAC_CFG)
    params = host(dac_init(jdac))
    port = DACModel(port_config(DAC_CFG))
    bad = jax.tree.map(lambda x: x, params)
    bad["quantizer"]["codebooks"] = bad["quantizer"]["codebooks"][:, :-1]
    with pytest.raises(ValueError, match="shape"):
        load_jax_dac_params(port, bad)
    missing = jax.tree.map(lambda x: x, params)
    del missing["decoder"]["conv_out"]
    with pytest.raises(KeyError, match="no JAX leaf"):
        load_jax_dac_params(port, missing)
    extra = jax.tree.map(lambda x: x, params)
    extra["decoder"]["conv_extra"] = {"kernel": np.zeros((1, 1, 1), np.float32)}
    with pytest.raises(KeyError, match="no module"):
        load_jax_dac_params(port, extra)
