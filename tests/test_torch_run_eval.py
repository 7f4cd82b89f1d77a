"""The trainer's eval steps in the port against the JAX package, on the CPU,
fp32, with `tests/test_torch_run_training.py`'s tiny config and codec:

  * `run_eval`: the loss of 10 features in a batch of 8 and a remainder of
    2, weighted by row count, within 1e-5 (relative) of the JAX package's
    (whose batch is 8 x its per-device batch on the session's 8 virtual
    devices), and equal to the row-weighted mean of its two parts;
  * `run_eval_generation`: greedy delayed ids identical to the JAX
    package's (both pipelines with an fp32 cache), the logged clips'
    lengths equal and their samples within 1e-5 of the JAX clips' norm.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parler_tts_tpu.codec.dac_model import DACModel as JDAC
from parler_tts_tpu.config import GenerationConfig as JGen
from parler_tts_tpu.runtime.generate import make_generate
from parler_tts_tpu.runtime.pipeline import ParlerTTSPipeline as JPipeline
from parler_tts_tpu.training import TrainState as JState
from parler_tts_tpu.training import arguments as ja
from parler_tts_tpu.training import data as jd
from parler_tts_tpu.training import make_optimizer as jax_optimizer
from parler_tts_tpu.training import run_training as jrt
from parler_tts_tpu_torch import config as tc
from parler_tts_tpu_torch.codec.registry import build_codec
from parler_tts_tpu_torch.convert import load_jax_dac_params
from parler_tts_tpu_torch.runtime.pipeline import ParlerTTSPipeline
from parler_tts_tpu_torch.training import arguments as ta
from parler_tts_tpu_torch.training import data as td
from parler_tts_tpu_torch.training import run_training as trt
from test_torch_models import host, output_in_unit_range, port_config
from test_torch_run_training import CFG, DEVICES, features, port_model
from test_torch_training import norm_rel


@pytest.fixture(scope="module")
def trained():
    """JAX params (one JAX model), the JAX and port train states on them,
    and a codec tree of the tiny DAC."""
    from parler_tts_tpu.models.parler import ParlerTTS as JParler

    model = JParler(CFG, use_flash_decode=True)
    k1, k2 = jax.random.split(jax.random.key(5))
    params = host(jax.jit(model.init)(
        k1, np.zeros((1, 4), np.int32), np.ones((1, 4), np.int32),
        np.zeros((1, 3), np.int32), np.ones((1, 3), np.int32), np.zeros((1, 2, 4), np.int32),
    )["params"])
    hop = CFG.audio_encoder.hop_length
    jdac = JDAC(CFG.audio_encoder)
    dac_params = output_in_unit_range(jax.jit(jdac.init)(k2, jnp.zeros((1, 2 * hop, 1)))["params"])
    port = port_model(params)
    state = trt.TrainState.create(port, trt.make_optimizer())
    return model, params, jdac, host(dac_params), state


def test_run_eval_matches_jax(trained):
    model, params, _, _, state = trained
    feats = features(10, seed=9)
    kw = dict(prompt_padding_side="left", token_bucket=8, label_bucket=16)
    jstate = JState.create(params, jax_optimizer())
    want = jrt.run_eval(model, jstate, jd.DataCollatorParlerTTSWithPadding(**kw), feats,
                        ja.TrainingArguments(per_device_eval_batch_size=1, report_to="none"),
                        None, 0, 0)
    args = ta.TrainingArguments(per_device_eval_batch_size=DEVICES, report_to="none")
    coll = td.DataCollatorParlerTTSWithPadding(**kw)
    got = trt.run_eval(state, coll, feats, args, None, 0, 0)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    full = trt.run_eval(state, coll, feats[:8], args, None, 0, 0)
    tail = trt.run_eval(state, coll, feats[8:], args, None, 0, 0)
    np.testing.assert_allclose(got, (8 * full + 2 * tail) / 10, rtol=1e-6)
    assert trt.run_eval(state, coll, [], args, None, 0, 0) is None


def test_run_eval_generation_matches_jax(trained, monkeypatch):
    model, params, jdac, dac_params, state = trained
    feats = features(3, seed=10)  # no texts: no CLAP or WER model is looked up
    margs = dict(max_length=20, do_sample=False)
    targs = dict(compute_clap_similarity_metric=False, compute_noise_level_metric=False,
                 report_to="none")
    dcfg = CFG.decoder
    gen = dict(max_length=20, do_sample=False, bos_token_id=dcfg.bos_token_id,
               pad_token_id=dcfg.pad_token_id, eos_token_id=dcfg.eos_token_id,
               codebook_guard=CFG.audio_encoder.codebook_size)
    # the pipelines each eval generation builds, with an fp32 cache
    jpipe = JPipeline(model, params, jdac, dac_params, JGen(**gen))
    jpipe._generate_fn = make_generate(model, jpipe.generation_config, cache_dtype=jnp.float32)
    codec = build_codec(port_config(CFG).audio_encoder)
    load_jax_dac_params(codec, dac_params)
    pipe = ParlerTTSPipeline(state.model, codec, tc.GenerationConfig(**gen),
                             cache_dtype=torch.float32, device="cpu")
    outs, clips = {}, {}
    for name, p, module in (("jax", jpipe, jrt), ("port", pipe, trt)):
        codes = p.generate_codes
        monkeypatch.setattr(p, "generate_codes",
                            lambda *a, _codes=codes, _n=name, **k: outs.setdefault(
                                _n, _codes(*a, **k)))
        monkeypatch.setattr(module, "log_pred", lambda *a, _n=name: clips.setdefault(_n, a[4]))
    jstate = JState.create(params, jax_optimizer())
    want = jrt.run_eval_generation(model, jstate, jdac, dac_params, feats,
                                   ja.ModelArguments(**margs), ja.TrainingArguments(**targs),
                                   None, 4, 0, max_samples=2, pipe_cache={"pipe": jpipe})
    got = trt.run_eval_generation(state, codec, feats, ta.ModelArguments(**margs),
                                  ta.TrainingArguments(**targs), None, 4, 0, max_samples=2,
                                  pipe_cache={"pipe": pipe})
    assert got == want == {}
    np.testing.assert_array_equal(outs["port"].delayed_ids.numpy(),
                                  np.asarray(outs["jax"].delayed_ids))
    assert len(clips["port"]) == len(clips["jax"]) == 2
    for g, w in zip(clips["port"], clips["jax"]):
        assert g.shape == w.shape and g.size > 0
        assert norm_rel(g, w) < 1e-5
    # without a cached pipeline over its model, the port builds one
    cache = {"pipe": pipe}
    state2 = dataclasses.replace(state, model=port_model(params))
    trt.run_eval_generation(state2, codec, feats, ta.ModelArguments(**margs),
                            ta.TrainingArguments(**targs), None, 4, 0, max_samples=1,
                            pipe_cache=cache)
    assert cache["pipe"] is not pipe and cache["pipe"].model is state2.model
