"""Decoder-only generation in the port against the JAX package, on the CPU
in fp32, at `tests/test_speculative.py`'s tiny config: no text encoder, no
prompt prefix; cross-attention over precomputed encoder states under their
mask, or one zero state it masks out; optional audio-prompt codes.

  * `generate_tokens_decoder_only` gives the JAX function's delayed ids,
    codes, lengths and steps (the port's decode steps run K1's plain
    version, JAX's the dense path);
  * `generate_tokens_decoder_only_speculative` gives JAX's tokens and
    forward counts, and the port's AR tokens;
  * without tensors to place it, the entry point runs on `cuda` unless
    given a device, and raises where there is none.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parler_tts_tpu.runtime.generate import generate_tokens_decoder_only as j_ar
from parler_tts_tpu.runtime.speculative import (
    generate_tokens_decoder_only_speculative as j_spec,
)
from parler_tts_tpu_torch import config as tc
from parler_tts_tpu_torch.runtime.generate import generate_tokens_decoder_only
from parler_tts_tpu_torch.runtime.speculative import generate_tokens_decoder_only_speculative
from test_speculative import CFG, PAD, _gen_cfg
from test_torch_speculative import assert_same, jparams


@pytest.fixture(scope="module")
def setup():
    return jparams(CFG)


def case_inputs(case):
    """(batch, JAX keyword arguments, the port's)."""
    rng = np.random.default_rng(2)
    b = 2 if "B=2" in case else 1
    kw = {}
    if "states" in case:
        kw["encoder_hidden_states"] = rng.normal(size=(b, 5, CFG.decoder.hidden_size)).astype(
            np.float32)
        mask = np.ones((b, 5), np.int32)
        mask[-1, 3:] = 0
        kw["encoder_mask"] = mask
    if "codes" in case:
        kw["decoder_prompt_codes"] = rng.integers(0, PAD, size=(b, 3, 2)).astype(np.int32)
    port_kw = {k: torch.from_numpy(v).to(torch.float32 if v.dtype == np.float32 else torch.int64)
               for k, v in kw.items()}
    return b, {k: jnp.asarray(v) for k, v in kw.items()}, port_kw


CASES = ["no encoder states", "encoder states", "audio-prompt codes",
         "encoder states and codes, B=2"]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("mode", ["ar", "speculative"])
def test_decoder_only_matches_jax(setup, mode, case):
    jm, params, port = setup
    gen = _gen_cfg(do_sample=False, min_new_tokens=3)
    pgen = tc.GenerationConfig(**dataclasses.asdict(gen))
    b, jkw, pkw = case_inputs(case)
    common = dict(cache_dtype=torch.float32, device="cpu")
    ar = generate_tokens_decoder_only(port, pgen, b, **pkw, **common)
    if mode == "ar":
        fn = jax.jit(functools.partial(j_ar, jm, gen, batch_size=b, cache_dtype=jnp.float32))
        assert_same(ar, fn(params, jax.random.key(5), **jkw))
        return
    fn = jax.jit(functools.partial(j_spec, jm, gen, batch_size=b, cache_dtype=jnp.float32,
                                   window=4))
    want, want_stats = fn(params, jax.random.key(5), **jkw)
    got, stats = generate_tokens_decoder_only_speculative(port, pgen, b, window=4, **pkw,
                                                          **common)
    assert_same(got, want)
    assert (stats.forwards, stats.columns) == (int(want_stats.forwards),
                                               int(want_stats.columns))
    np.testing.assert_array_equal(got.delayed_ids.numpy(), ar.delayed_ids.numpy())
    assert stats.forwards < stats.columns


def test_decoder_only_defaults_to_cuda(setup, monkeypatch):
    _, _, port = setup
    pgen = tc.GenerationConfig(**dataclasses.asdict(_gen_cfg(do_sample=False)))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (generate_tokens_decoder_only, generate_tokens_decoder_only_speculative):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn(port, pgen, 1)
