"""The whole serving slice of the port against the JAX package: greedy token
generation (`make_generate` with a float32 cache and the flash-decode model
vs the port's `generate_codes`) must give identical delayed ids, codes,
lengths and steps; the waveform of `generate` must match the JAX codec's
decode of the JAX codes to 1e-5. CPU, fp32, tiny configs."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parler_tts_tpu.codec.dac_model import DACModel as JDAC
from parler_tts_tpu.config import DACConfig, DecoderConfig, GenerationConfig, ParlerTTSConfig
from parler_tts_tpu.config import T5Config
from parler_tts_tpu.models.parler import ParlerTTS as JParler
from parler_tts_tpu.runtime.generate import make_generate
from parler_tts_tpu_torch import config as tc
from parler_tts_tpu_torch.codec.dac_model import DACModel
from parler_tts_tpu_torch.convert import load_jax_dac_params, load_jax_params
from parler_tts_tpu_torch.models.parler import ParlerTTS
from parler_tts_tpu_torch.runtime.pipeline import ParlerTTSPipeline
from test_torch_models import host, output_in_unit_range, port_config

PAD, BOS = 88, 89

CFG = ParlerTTSConfig(
    text_encoder=T5Config(
        vocab_size=120, d_model=48, d_kv=12, d_ff=96, num_layers=2, num_heads=4,
        relative_attention_num_buckets=8, relative_attention_max_distance=20,
        dropout_rate=0.0,
    ),
    audio_encoder=DACConfig(
        num_codebooks=4, codebook_size=PAD, codebook_dim=4, latent_dim=64,
        encoder_dim=4, encoder_rates=(2, 4, 4), decoder_dim=96, decoder_rates=(4, 4, 2),
        sampling_rate=16000, frame_rate=500,
    ),
    decoder=DecoderConfig(
        vocab_size=100, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
        ffn_dim=128, num_codebooks=4, max_position_embeddings=128,
        pad_token_id=PAD, bos_token_id=BOS, eos_token_id=PAD, dropout=0.0,
    ),
    vocab_size=256,
    pad_token_id=PAD,
    decoder_start_token_id=BOS,
)

GEN = GenerationConfig(
    max_length=24, min_new_tokens=8, do_sample=False,
    bos_token_id=BOS, pad_token_id=PAD, eos_token_id=PAD,
)


def ids(seed=0, b=2, left_pad=True):
    rng = np.random.default_rng(seed)
    desc = rng.integers(0, 120, size=(b, 9)).astype(np.int32)
    desc_mask = np.ones((b, 9), np.int32)
    desc_mask[1, 6:] = 0
    prompt = rng.integers(0, 256, size=(b, 5)).astype(np.int32)
    prompt_mask = np.ones((b, 5), np.int32)
    if left_pad:
        prompt_mask[0, :2] = 0
    return desc, desc_mask, prompt, prompt_mask


def jax_params(cfg, seed=0):
    model = JParler(cfg, use_flash_decode=True)
    k1, k2 = jax.random.split(jax.random.key(seed))
    params = jax.jit(model.init)(
        k1, jnp.zeros((1, 4), jnp.int32), jnp.ones((1, 4), jnp.int32),
        jnp.zeros((1, 3), jnp.int32), jnp.ones((1, 3), jnp.int32),
        jnp.zeros((1, 2, cfg.decoder.num_codebooks), jnp.int32),
    )["params"]
    dac = JDAC(cfg.audio_encoder)
    # full round-trip init, so the tree holds the encode side too
    hop = cfg.audio_encoder.hop_length
    dac_params = jax.jit(dac.init)(k2, jnp.zeros((1, 2 * hop, 1)))["params"]
    return model, host(params), dac, output_in_unit_range(dac_params)


def port_pipeline(cfg, params, dac_params, gen, **kw):
    pcfg = port_config(cfg)
    model = ParlerTTS(pcfg)
    load_jax_params(model, params)
    dac = DACModel(pcfg.audio_encoder)
    load_jax_dac_params(dac, dac_params)
    return ParlerTTSPipeline(model, dac, tc.GenerationConfig(**dataclasses.asdict(gen)),
                             cache_dtype=torch.float32, device="cpu", **kw)


def assert_same_generation(port_out, jax_out):
    np.testing.assert_array_equal(port_out.delayed_ids.numpy(), np.asarray(jax_out.delayed_ids))
    np.testing.assert_array_equal(port_out.codes.numpy(), np.asarray(jax_out.codes))
    np.testing.assert_array_equal(port_out.lengths.numpy(), np.asarray(jax_out.lengths))
    assert port_out.steps == int(jax_out.steps)


@pytest.fixture(scope="module")
def pair():
    return jax_params(CFG)


@pytest.mark.parametrize("left_pad", [False, True])
def test_generate_codes_matches_jax(pair, left_pad):
    jm, params, _, dac_params = pair
    desc, dm, prompt, pm = ids(left_pad=left_pad)
    want = make_generate(jm, GEN, cache_dtype=jnp.float32)(
        params, desc, dm, prompt, pm, jax.random.key(0))
    pipe = port_pipeline(CFG, params, dac_params, GEN)
    assert_same_generation(pipe.generate_codes(desc, dm, prompt, pm), want)


def test_generate_codes_prompt_cross_attention_mode():
    cfg = dataclasses.replace(CFG, prompt_cross_attention=True)
    jm, params, _, dac_params = jax_params(cfg, seed=1)
    desc, dm, prompt, pm = ids(seed=1)
    want = make_generate(jm, GEN, cache_dtype=jnp.float32)(
        params, desc, dm, prompt, pm, jax.random.key(0))
    pipe = port_pipeline(cfg, params, dac_params, GEN)
    assert_same_generation(pipe.generate_codes(desc, dm, prompt, pm), want)


def test_generate_codes_voice_steering(pair):
    jm, params, _, dac_params = pair
    desc, dm, prompt, pm = ids(seed=2)
    codes = np.random.default_rng(3).integers(0, PAD, (2, 4, 3)).astype(np.int32)
    want = make_generate(jm, GEN, cache_dtype=jnp.float32)(
        params, desc, dm, prompt, pm, jax.random.key(0), jnp.asarray(codes))
    pipe = port_pipeline(CFG, params, dac_params, GEN)
    assert_same_generation(
        pipe.generate_codes(desc, dm, prompt, pm, decoder_prompt_codes=codes), want)


def test_early_exit_matches_jax(pair):
    """Weights tilted towards EOS end generation before max_length; the
    port's periodic host check must recover the exact `steps`."""
    jm, params, _, dac_params = pair
    params = jax.tree.map(np.copy, params)
    dec = params["decoder"]
    dec["decoder"]["layer_norm"]["bias"] = np.full_like(dec["decoder"]["layer_norm"]["bias"], 0.5)
    dec["lm_heads"][:, :, PAD] += 1.0
    gen = dataclasses.replace(GEN, max_length=60, min_new_tokens=6)
    desc, dm, prompt, pm = ids(seed=4)
    want = make_generate(jm, gen, cache_dtype=jnp.float32)(
        params, desc, dm, prompt, pm, jax.random.key(0))
    assert int(want.steps) < gen.max_length
    pipe = port_pipeline(CFG, params, dac_params, gen)
    assert_same_generation(pipe.generate_codes(desc, dm, prompt, pm), want)


def test_generate_waveform_matches_jax(pair):
    jm, params, jdac, dac_params = pair
    desc, dm, prompt, pm = ids(seed=5)
    out = make_generate(jm, GEN, cache_dtype=jnp.float32)(
        params, desc, dm, prompt, pm, jax.random.key(0))
    lengths = np.asarray(out.lengths)
    bucket = min(-(-int(lengths.max()) // 8) * 8, out.codes.shape[-1])
    codes = jnp.clip(out.codes[:, :, :bucket], 0, PAD - 1)
    want = np.asarray(jdac.apply({"params": dac_params}, codes, method="decode"))[:, :, 0]

    pipe = port_pipeline(CFG, params, dac_params, GEN, frame_bucket=8)
    audio, audio_lengths = pipe.generate(desc, prompt, desc_mask=dm, prompt_mask=pm)
    hop = CFG.audio_encoder.hop_length
    np.testing.assert_array_equal(audio_lengths, lengths * hop)
    assert audio.shape == want.shape == (2, bucket * hop)
    np.testing.assert_allclose(audio, want, atol=1e-5, rtol=1e-4)


def test_from_random_on_cpu_is_seeded():
    pcfg = port_config(CFG)
    gen = tc.GenerationConfig(**dataclasses.asdict(GEN))
    desc, dm, prompt, pm = ids(seed=6)
    runs = []
    for _ in range(2):
        pipe = ParlerTTSPipeline.from_random(pcfg, seed=3, generation_config=gen,
                                             device="cpu", frame_bucket=8)
        runs.append(pipe.generate(desc, prompt, desc_mask=dm, prompt_mask=pm))
    (a, la), (b, lb) = runs
    assert a.ndim == 2 and a.shape[0] == 2 and np.isfinite(a).all()
    assert np.abs(a).max() <= 1.0
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(la, lb)


def test_pipeline_without_device_raises_when_cuda_is_absent(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pcfg = port_config(CFG)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ParlerTTSPipeline.from_random(pcfg)
    model, dac = ParlerTTS(pcfg), DACModel(pcfg.audio_encoder)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ParlerTTSPipeline(model, dac)


def test_text_input_needs_ids():
    """Without a tokenizer, text raises and asks for token ids."""
    pipe = ParlerTTSPipeline.from_random(port_config(CFG), device="cpu")
    with pytest.raises(ValueError, match="no tokenizer; pass token ids"):
        pipe.generate("a calm voice", "hello")
