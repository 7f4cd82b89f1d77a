"""An Encodec-coded Parler-TTS served by the port against the JAX package,
fp32 on the CPU, with `tests/test_torch_pipeline.py`'s tiny decoder over a
small Encodec (16 kHz, ratios 4 x 4, 4 codebooks of 88 entries, the
decoder's pad id):

  * a native checkpoint written by the JAX package's `save_pretrained` loads
    into the port (the codec in `dac_params.pkl`, as for DAC), every
    parameter equal; an HF `config.json` with model_type "encodec" parses to
    the JAX package's config, with the codebook count from
    `target_bandwidths`, given, or taken from the decoder;
  * greedy delayed ids, codes and lengths identical to JAX's `make_generate`
    (fp32 cache), voice-steered by the codes of `encode_voice_prompt`;
  * `decode_codes` within 1e-5 (norm-relative) of the JAX pipeline's, mono,
    and stereo with `audio_scales` (interleaved, samples = frames x hop x 2);
  * `encode_voice_prompt(return_scales=True)`: codes equal, scales within
    1e-6; a normalising codec without `return_scales` raises ValueError in
    both packages.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parler_tts_tpu.codec.encodec_model import EncodecCodecConfig as JEncodecConfig
from parler_tts_tpu.codec.registry import build_codec as jax_build_codec
from parler_tts_tpu.runtime.generate import make_generate
from parler_tts_tpu.runtime.pipeline import ParlerTTSPipeline as JPipeline
from parler_tts_tpu.runtime.pipeline import load_hf_config as jax_load_hf_config
from parler_tts_tpu_torch import config as tc
from parler_tts_tpu_torch.codec.encodec_model import EncodecCodec
from parler_tts_tpu_torch.codec.registry import build_codec, init_codec_params
from parler_tts_tpu_torch.convert import (
    dac_to_jax_tree,
    load_jax_dac_params,
    load_jax_params,
    tensor_tree,
)
from parler_tts_tpu_torch.models.parler import ParlerTTS
from parler_tts_tpu_torch.runtime.checkpoint import load_hf_config
from parler_tts_tpu_torch.runtime.pipeline import ParlerTTSPipeline
from test_torch_models import port_config
from test_torch_pipeline import CFG, GEN, PAD, ids, jax_params

REL = 1e-5


def encodec_cfg(**codec):
    fields = dict(sampling_rate=16000, num_filters=8, hidden_size=16, upsampling_ratios=(4, 4),
                  codebook_size=PAD, codebook_dim=16, num_codebooks=4)
    return dataclasses.replace(CFG, audio_encoder=JEncodecConfig(**dict(fields, **codec)))


def codec_tree(cfg, seed):
    """A codec tree drawn by the port's init (a flax init would compile the
    whole codec), as flax-named numpy arrays."""
    codec = build_codec(port_config(cfg).audio_encoder)
    return dac_to_jax_tree(init_codec_params(codec, torch.Generator().manual_seed(seed)))


def port_pipeline(cfg, params, dac_params):
    pcfg = port_config(cfg)
    model = ParlerTTS(pcfg)
    load_jax_params(model, params)
    codec = build_codec(pcfg.audio_encoder)
    load_jax_dac_params(codec, dac_params)
    return ParlerTTSPipeline(model, codec, tc.GenerationConfig(**dataclasses.asdict(GEN)),
                             cache_dtype=torch.float32, device="cpu")


def norm_rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def clips(b, t, seed=0):
    return (np.random.default_rng(seed).normal(size=(b, t)) * 0.3).astype(np.float32)


def pipelines(cfg, seed):
    """(JAX model, JAX pipeline, port pipeline) sharing a decoder tree (the
    flash-decode JAX model) and a codec tree."""
    jm, params, _, _ = jax_params(CFG, seed=3)
    jm = jm.clone(config=cfg)
    dac_params = codec_tree(cfg, seed)
    jpipe = JPipeline(jm, params, jax_build_codec(cfg.audio_encoder), dac_params, GEN)
    return jm, jpipe, port_pipeline(cfg, params, dac_params)


@pytest.fixture(scope="module")
def mono():
    return pipelines(encodec_cfg(), seed=4)


@pytest.fixture(scope="module")
def stereo():
    return pipelines(encodec_cfg(audio_channels=2, normalize=True), seed=5)


# ------------------------------------------------------------ checkpoints
def test_jax_saved_encodec_checkpoint_loads_into_the_port(tmp_path, mono):
    _, jpipe, _ = mono
    jpipe.save_pretrained(str(tmp_path))
    pipe = ParlerTTSPipeline.from_pretrained(str(tmp_path), device="cpu",
                                             cache_dtype=torch.float32)
    assert isinstance(pipe.dac, EncodecCodec)
    assert pipe.config == port_config(jpipe.config)
    for got, want in ((tensor_tree(pipe.model), jpipe.params),
                      (tensor_tree(pipe.dac), jpipe.dac_params)):
        got = dict(jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, got)))
        want = jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, want))
        assert len(got) == len(want)
        for path, leaf in want:
            np.testing.assert_array_equal(got[path], leaf, err_msg=jax.tree_util.keystr(path))


HF_CODECS = {
    "target_bandwidths": dict(target_bandwidths=[1.5, 3.0, 6.0]),
    "num_codebooks": dict(num_codebooks=2, target_bandwidths=[24.0]),
    "from_decoder": dict(),
}


@pytest.mark.parametrize("name", list(HF_CODECS))
def test_hf_encodec_config_matches_jax(tmp_path, name):
    raw = {
        "text_encoder": dataclasses.asdict(CFG.text_encoder),
        "audio_encoder": dict(model_type="encodec", sampling_rate=24000, audio_channels=2,
                              upsampling_ratios=[8, 5, 4, 2], normalize=True,
                              **HF_CODECS[name]),
        "decoder": dataclasses.asdict(CFG.decoder),
    }
    with open(os.path.join(tmp_path, "config.json"), "w") as f:
        json.dump(raw, f)
    got, want = load_hf_config(str(tmp_path)), jax_load_hf_config(str(tmp_path))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.audio_encoder.num_codebooks == {"target_bandwidths": 8, "num_codebooks": 2,
                                               "from_decoder": 4}[name]


# ---------------------------------------------------------------- serving
def test_voice_steered_greedy_codes_and_audio_match_jax(mono):
    jm, jpipe, pipe = mono
    clip = clips(2, 16 * 5 + 3, seed=1)  # padded to 6 frames
    prompt_codes = pipe.encode_voice_prompt(clip)
    np.testing.assert_array_equal(prompt_codes.numpy(), jpipe.encode_voice_prompt(clip))
    assert prompt_codes.shape == (2, 4, 6)
    desc, dm, prompt, pm = ids(seed=11)
    want = make_generate(jm, GEN, cache_dtype=jnp.float32)(
        jpipe.params, desc, dm, prompt, pm, jax.random.key(0), jnp.asarray(prompt_codes))
    got = pipe.generate_codes(desc, dm, prompt, pm, decoder_prompt_codes=prompt_codes)
    np.testing.assert_array_equal(got.delayed_ids.numpy(), np.asarray(want.delayed_ids))
    np.testing.assert_array_equal(got.codes.numpy(), np.asarray(want.codes))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))
    audio, lengths = pipe.decode_codes(got.codes, got.lengths)
    audio_j, lengths_j = jpipe.decode_codes(want.codes, want.lengths)
    np.testing.assert_array_equal(lengths, lengths_j)
    assert audio.shape == audio_j.shape
    assert norm_rel(audio, audio_j) < REL


def test_stereo_scales_and_decode_match_jax(stereo):
    _, jpipe, pipe = stereo
    clip = clips(2, 16 * 7, seed=2)
    clip[1] *= 5.0
    with pytest.raises(ValueError, match="return_scales"):
        pipe.encode_voice_prompt(clip)
    with pytest.raises(ValueError, match="return_scales"):
        jpipe.encode_voice_prompt(clip)
    codes, scales = pipe.encode_voice_prompt(clip, return_scales=True)
    codes_j, scales_j = jpipe.encode_voice_prompt(clip, return_scales=True)
    np.testing.assert_array_equal(codes.numpy(), codes_j)
    np.testing.assert_allclose(scales.numpy(), scales_j, rtol=1e-6)
    # a (B, T, C) clip goes in as it is
    stereo_clip = np.stack([clip, clip[:, ::-1]], axis=-1).copy()
    np.testing.assert_array_equal(
        pipe.encode_voice_prompt(stereo_clip, return_scales=True)[0].numpy(),
        jpipe.encode_voice_prompt(stereo_clip, return_scales=True)[0])
    lengths = torch.tensor([7, 4])
    audio, n = pipe.decode_codes(codes, lengths, audio_scales=scales)
    audio_j, n_j = jpipe.decode_codes(jnp.asarray(codes_j), jnp.asarray(lengths.numpy()),
                                      audio_scales=scales_j)
    np.testing.assert_array_equal(n, n_j)
    np.testing.assert_array_equal(n, lengths.numpy() * 16 * 2)
    assert audio.shape == audio_j.shape == (2, 7 * 16 * 2)
    assert norm_rel(audio, audio_j) < REL
    unscaled, _ = pipe.decode_codes(codes, lengths)
    np.testing.assert_allclose(audio[1], unscaled[1] * float(scales[1]), rtol=1e-6, atol=1e-7)
