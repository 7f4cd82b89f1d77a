"""Voice steering in the port against the JAX package, on the CPU, fp32:
the DAC encoder and the residual quantizer's encode, `encode_voice_prompt`,
and the codec's encode side through every loader and exporter.

  * At the real DAC size (44.1 kHz, encoder_dim 64, rates 2/4/8/8) on two
    seeded synthetic clips of 0.3 s, one not a multiple of the hop: the
    encoder latents within 1e-4 of the JAX package's (norm-relative) and the
    codes equal to the JAX package's `encode_voice_prompt`, except where the
    port's own encode had a near-tie (`chip_smoke.codes_agree`: the first
    codebook where a frame parts has a best-to-second distance gap below
    1e-5); the count of such frames is printed.
  * On the tiny codec of `test_torch_pipeline.py`: the port's codec tree
    (`tensor_tree`, `dac_to_jax_tree`) equals the JAX tree leaf for leaf, the
    encoder and the in-projections included; the
    port's `convert_dac_params` of the JAX exporter's tensors equals the JAX
    `convert_dac_params` of them: bit for bit without weight norm, within
    1e-6 of each folded kernel's scale with it (both fold in float64).
  * A `dac_params.pkl` written by the port's `save_pretrained` loads into the
    JAX `ParlerTTSPipeline`, which decodes the port's codes to the port's
    waveform (1e-5) and encodes a clip to the port's codes.
  * Codes from `encode_voice_prompt` steer generation: greedy ids equal the
    JAX package's on the same clip; (T,) input, `return_scales` (ones) and a
    bf16 `codec_dtype` pipeline (which encodes with the fp32 codec) give the
    same codes.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import LATENT_REL, codes_agree, encode_gaps, voice_clips
from parler_tts_tpu.codec.convert import convert_dac_params as jax_convert_dac
from parler_tts_tpu.codec.convert import export_dac_params as jax_export_dac
from parler_tts_tpu.codec.dac_model import DACModel as JDAC
from parler_tts_tpu.config import DACConfig
from parler_tts_tpu.models.parler import ParlerTTS as JParler
from parler_tts_tpu.runtime.generate import make_generate
from parler_tts_tpu.runtime.pipeline import ParlerTTSPipeline as JPipeline
from parler_tts_tpu_torch.codec.convert import convert_dac_params
from parler_tts_tpu_torch.codec.dac_model import DACModel
from parler_tts_tpu_torch.convert import dac_to_jax_tree, load_jax_dac_params, tensor_tree
from parler_tts_tpu_torch.models.layers import init_weights
from test_torch_checkpoint import FOLD_REL, FOLDED
from test_torch_models import host, port_config
from test_torch_pipeline import CFG, GEN, ids, jax_params, port_pipeline

REAL_CFG = dataclasses.replace(CFG, audio_encoder=DACConfig())


def port_codec(dac_params, cfg):
    dac = DACModel(port_config(cfg))
    load_jax_dac_params(dac, dac_params)
    return dac


@pytest.fixture(scope="module")
def tiny():
    """The tiny model and codec of `test_torch_pipeline.py`, in both packages."""
    return jax_params(CFG, seed=3)


@pytest.fixture(scope="module")
def real(tiny):
    """The tiny model with the real-size codec, in both packages."""
    params = tiny[1]
    jdac = JDAC(REAL_CFG.audio_encoder)
    # the codec's weights drawn by the port (seeded) and handed to both as
    # numpy: a JAX init would compile the whole real-size codec first
    dac = DACModel(port_config(REAL_CFG.audio_encoder))
    init_weights(dac, torch.Generator().manual_seed(1))
    dac_params = dac_to_jax_tree(dac)
    jpipe = JPipeline(JParler(REAL_CFG, use_flash_decode=True), params, jdac, dac_params, GEN)
    return params, jdac, dac_params, jpipe


def test_real_size_encode_matches_jax(real):
    params, jdac, dac_params, jpipe = real
    ae = REAL_CFG.audio_encoder
    audio = voice_clips(ae.sampling_rate, int(0.3 * ae.sampling_rate))  # 13230 samples: 25.8 hops
    want = np.asarray(jpipe.encode_voice_prompt(audio))
    pipe = port_pipeline(REAL_CFG, params, dac_params, GEN)
    got = pipe.encode_voice_prompt(audio)
    assert got.dtype == torch.int64 and got.shape == want.shape == (2, ae.num_codebooks, 26)
    padded = np.zeros((2, 26 * ae.hop_length, 1), np.float32)
    padded[:, :audio.shape[1], 0] = audio
    want_lat = np.asarray(jdac.apply({"params": dac_params}, jnp.asarray(padded),
                                     method=lambda m, x: m.encoder(x)))
    with torch.inference_mode():
        lat = pipe.dac.encoder(torch.from_numpy(padded))
        gaps = encode_gaps(pipe.dac.quantizer, lat, got)
    rel = float(np.linalg.norm(lat.numpy() - want_lat) / np.linalg.norm(want_lat))
    assert rel <= LATENT_REL, rel
    ok, parted = codes_agree(got, torch.tensor(want).long(), gaps)
    print(f"latents norm-rel {rel:.2e}; frames parted at near-ties: {parted} of {2 * 26}")
    assert ok


def test_codec_trees_and_exports_keep_the_encoder(tiny):
    _, _, _, dac_params = tiny
    ae = CFG.audio_encoder
    dac = port_codec(dac_params, ae)
    tree = dac_to_jax_tree(dac)
    assert "encoder" in tree and "in_proj_kernel" in tree["quantizer"]
    assert jax.tree.structure(tree) == jax.tree.structure(dac_params)
    jax.tree.map(np.testing.assert_array_equal, tree, dac_params)
    assert jax.tree.structure(host(tensor_tree(dac))) == jax.tree.structure(dac_params)
    for weight_norm in (False, True):
        tensors = jax_export_dac(dac_params, ae, weight_norm=weight_norm, v_scale=1.7)
        assert any(k.startswith("model.encoder.") for k in tensors)
        want = jax_convert_dac(tensors, ae)
        got = convert_dac_params({k: torch.tensor(v) for k, v in tensors.items()}, ae)
        flat_got = jax.tree_util.tree_flatten_with_path(host(got))[0]
        flat_want = jax.tree_util.tree_flatten_with_path(want)[0]
        assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
        for (path, g), (_, w) in zip(flat_got, flat_want):
            name = jax.tree_util.keystr(path)
            if weight_norm and path[-1].key in ("kernel",) + FOLDED:
                assert np.abs(g - w).max() <= FOLD_REL * np.abs(w).max(), name
            else:
                np.testing.assert_array_equal(g, w, err_msg=name)


def test_port_written_codec_serves_in_the_jax_package(tmp_path, tiny):
    jm, params, jdac, dac_params = tiny
    pipe = port_pipeline(CFG, params, dac_params, GEN, frame_bucket=8)
    pipe.save_pretrained(str(tmp_path))
    loaded = JPipeline.from_pretrained(str(tmp_path), frame_bucket=8)
    jax.tree.map(np.testing.assert_array_equal, host(loaded.dac_params), host(dac_params))
    out = pipe.generate_codes(*ids(seed=2))
    want, want_len = pipe.decode_codes(out.codes, out.lengths)
    got, got_len = loaded.decode_codes(jnp.asarray(out.codes.numpy()),
                                       jnp.asarray(out.lengths.numpy()))
    np.testing.assert_array_equal(got_len, want_len)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)
    hop = CFG.audio_encoder.hop_length
    audio = voice_clips(CFG.audio_encoder.sampling_rate, 7 * hop + 5, seed=4)
    codes = pipe.encode_voice_prompt(audio)
    with torch.inference_mode():
        lat = pipe.dac.encoder(torch.nn.functional.pad(torch.from_numpy(audio)[:, :, None],
                                                       (0, 0, 0, -audio.shape[1] % hop)))
        gaps = encode_gaps(pipe.dac.quantizer, lat, codes)
    assert codes_agree(codes, torch.tensor(np.asarray(loaded.encode_voice_prompt(audio))),
                       gaps)[0]


def test_voice_steered_generation_matches_jax(tiny):
    jm, params, jdac, dac_params = tiny
    pipe = port_pipeline(CFG, params, dac_params, GEN, frame_bucket=8)
    jpipe = JPipeline(jm, params, jdac, dac_params, GEN, frame_bucket=8)
    hop = CFG.audio_encoder.hop_length
    audio = voice_clips(CFG.audio_encoder.sampling_rate, 3 * hop, seed=5)
    codes = pipe.encode_voice_prompt(audio)
    jcodes = np.asarray(jpipe.encode_voice_prompt(audio))
    np.testing.assert_array_equal(codes.numpy(), jcodes)
    assert codes.shape == (2, CFG.audio_encoder.num_codebooks, 3)
    request = ids(seed=6)
    want = make_generate(jm, GEN, cache_dtype=jnp.float32)(
        params, *request, jax.random.key(0), jnp.asarray(jcodes))
    got = pipe.generate_codes(*request, decoder_prompt_codes=codes)
    np.testing.assert_array_equal(got.delayed_ids.numpy(), np.asarray(want.delayed_ids))
    np.testing.assert_array_equal(got.codes[:, :, :3].numpy(), jcodes)
    # (T,) input, the scales, and a bf16 codec copy that leaves encoding fp32
    one, scales = pipe.encode_voice_prompt(audio[1], return_scales=True)
    assert torch.equal(one, codes[1:]) and torch.equal(scales, torch.ones(1))
    bf16 = port_pipeline(CFG, params, dac_params, GEN, codec_dtype=torch.bfloat16)
    assert bf16.dac_decode.quantizer.codebooks.dtype == torch.bfloat16
    assert torch.equal(bf16.encode_voice_prompt(torch.from_numpy(audio)), codes)
