"""The port's bf16 serving path against the JAX package's, on the CPU.

The JAX model computes in bf16 from fp32 parameters and sums the LM heads'
products in fp32 (`preferred_element_type=float32`), returning fp32 logits.
The port's bf16 model holds bf16 parameters (the same values after the JAX
model's cast) and must do the same: fp32 logits summed in fp32 from the bf16
hidden states and heads.

  * On one set of bf16 hidden states, the port's heads must give the JAX
    heads' logits to fp32 accuracy (rtol 1e-5): bf16 x bf16 products are
    exact in fp32, so only the summation order differs. Logits rounded to
    bf16 miss this by up to 2**-9 relative.
  * Over a prefill and four K1 decode steps, the port's bf16 logits must lie
    as close to the JAX package's bf16 logits as half of JAX's own gap
    between its bf16 and its fp32 model on the same inputs (norm-relative):
    both packages round the same values to bf16 at the same points, and
    what separates them is summation order.
  * Greedy bf16 generation must give the JAX package's stream. Where the two
    part, the port's logits of its token and of the JAX token must lie within
    TIE = 2e-4 (the decoder-logit bound, COMPONENTS.md row 5); the JAX token
    is then forced into the port's stream, as in
    `tests/test_torch_fused_decode.py`. The sampler must see fp32 logits,
    not bf16-valued ones.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parler_tts_tpu.models.decoder import DecoderCache as JCache
from parler_tts_tpu.models.decoder import ParlerForCausalLM as JLM
from parler_tts_tpu.models.parler import ParlerTTS as JParler
from parler_tts_tpu.ops.masks import causal_self_attention_bias, padding_cross_attention_bias
from parler_tts_tpu.runtime.generate import make_generate
from parler_tts_tpu_torch import config as tc
from parler_tts_tpu_torch.convert import load_jax_params
from parler_tts_tpu_torch.models.decoder import DecoderCache, ParlerForCausalLM
from parler_tts_tpu_torch.models.parler import ParlerTTS
from parler_tts_tpu_torch.ops import masks as tmasks
from parler_tts_tpu_torch.runtime import generate as tgen
from test_torch_models import dec_config, host, port_config
from test_torch_pipeline import CFG as PIPE_CFG
from test_torch_pipeline import GEN, ids

TIE = 2e-4
BF16 = torch.bfloat16


def norm_rel(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def decoder_logits(seed, dtype):
    """JAX logits (fp32 model, bf16 model) and the port's bf16 logits over a
    prefill and four decode steps, plus one set of bf16 hidden states."""
    cfg = dec_config(4, False)
    b, s_pre, n_steps, s_enc, s_max = 2, 5, 4, 6, 16
    rng = np.random.default_rng(seed)
    ids_ = rng.integers(0, 62, (b, 3, s_pre + n_steps)).astype(np.int32)
    enc = rng.normal(size=(b, s_enc, 64)).astype(np.float32)
    enc_mask = np.ones((b, s_enc), np.int32)
    enc_mask[0, 4:] = 0
    kv_valid = np.ones((b, s_max), bool)
    starts = np.zeros((b,), np.int32)
    init = JLM(cfg).init(jax.random.key(seed), jnp.zeros((b, s_pre, 64)),
                         jnp.broadcast_to(jnp.arange(s_pre), (b, s_pre)),
                         self_attn_bias=None, encoder_hidden_states=jnp.asarray(enc))["params"]
    params = host(init)
    out = {}
    for name, jdt in (("fp32", jnp.float32), ("bf16", jnp.bfloat16)):
        jm = JLM(cfg, dtype=jdt, use_flash_decode=True)
        cache = JCache.zeros(cfg, b, s_max, s_enc, jdt, flat_self=True)
        ck, cv = jm.apply({"params": params}, jnp.asarray(enc), method="precompute_cross_kv")
        cache = cache.replace(cross_k=ck, cross_v=cv)
        steps = []
        for lo, hi in [(0, s_pre)] + [(i, i + 1) for i in range(s_pre, s_pre + n_steps)]:
            pos = jnp.broadcast_to(jnp.arange(lo, hi), (b, hi - lo))
            emb = jm.apply({"params": params}, jnp.asarray(ids_[:, :, lo:hi]), method="embed_ids")
            logits, cache = jm.apply(
                {"params": params}, emb, pos,
                self_attn_bias=causal_self_attention_bias(pos, jnp.asarray(kv_valid)),
                cross_attn_bias=padding_cross_attention_bias(jnp.asarray(enc_mask), hi - lo),
                cache=cache,
                decode_lengths=None if hi - lo > 1 else (jnp.asarray(starts), jnp.int32(hi)))
            steps.append(np.asarray(logits, np.float32))
        out[name] = np.concatenate(steps, axis=2)
    port = ParlerForCausalLM(port_config(cfg), dtype=dtype)
    load_jax_params(port, params)
    cache = DecoderCache.zeros(port_config(cfg), b, s_max, s_enc, dtype)
    got = []
    with torch.inference_mode():
        cache.cross_k, cache.cross_v = port.precompute_cross_kv(torch.from_numpy(enc))
        for lo, hi in [(0, s_pre)] + [(i, i + 1) for i in range(s_pre, s_pre + n_steps)]:
            pos = torch.arange(lo, hi)[None].expand(b, hi - lo)
            logits = port(
                port.embed_ids(torch.from_numpy(ids_[:, :, lo:hi]).long()), pos,
                self_attn_bias=None if hi - lo == 1 else tmasks.causal_self_attention_bias(
                    pos, torch.from_numpy(kv_valid)),
                cross_attn_bias=tmasks.padding_cross_attention_bias(
                    torch.from_numpy(enc_mask), hi - lo),
                cache=cache,
                decode_lengths=(torch.from_numpy(starts), hi) if hi - lo == 1 else None)
            assert logits.dtype == torch.float32
            got.append(logits.numpy())
    hidden = rng.normal(size=(b, 7, 64)).astype(np.float32)
    jm = JLM(cfg, dtype=jnp.bfloat16)
    want_heads = np.asarray(jm.apply({"params": params}, jnp.asarray(hidden, jnp.bfloat16),
                                     method="logits"))
    with torch.inference_mode():
        got_heads = port.logits(torch.from_numpy(hidden).to(dtype)).numpy()
    return out, np.concatenate(got, axis=2), want_heads, got_heads


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bf16_decoder_logits_match_jax(seed):
    jax_logits, got, want_heads, got_heads = decoder_logits(seed, BF16)
    np.testing.assert_allclose(got_heads, want_heads, rtol=1e-5, atol=1e-6)
    jax_gap = norm_rel(jax_logits["bf16"], jax_logits["fp32"])
    assert jax_gap > 1e-3  # the bf16 model really runs in bf16
    assert norm_rel(got, jax_logits["bf16"]) <= 0.5 * jax_gap


@pytest.fixture(scope="module")
def bf16_pair():
    jm = JParler(PIPE_CFG, dtype=jnp.bfloat16, use_flash_decode=True)
    params = host(jm.init(
        jax.random.key(3), jnp.zeros((1, 4), jnp.int32), jnp.ones((1, 4), jnp.int32),
        jnp.zeros((1, 3), jnp.int32), jnp.ones((1, 3), jnp.int32),
        jnp.zeros((1, 2, PIPE_CFG.decoder.num_codebooks), jnp.int32))["params"])
    port = ParlerTTS(port_config(PIPE_CFG), dtype=BF16)
    load_jax_params(port, params)
    return jm, params, port


@pytest.mark.parametrize("seed,left_pad", [(0, False), (1, True), (2, True)])
def test_bf16_greedy_generation_matches_jax(bf16_pair, seed, left_pad, monkeypatch):
    jm, params, port = bf16_pair
    gen = dataclasses.replace(GEN, max_length=40, min_new_tokens=30)
    desc, dm, prompt, pm = ids(seed=seed, left_pad=left_pad)
    want = make_generate(jm, gen, cache_dtype=jnp.bfloat16)(
        params, desc, dm, prompt, pm, jax.random.key(0))
    want_ids = torch.from_numpy(np.array(want.delayed_ids)).long()
    forced = []
    sample = tgen._sample_column

    def follow_jax_at_ties(logits, t, *a, **kw):
        assert logits.dtype == torch.float32
        assert not torch.equal(logits, logits.to(BF16).float()), "bf16-valued logits"
        col, state = sample(logits, t, *a, **kw)
        ref = want_ids[:, :, t]
        if torch.equal(col, ref):
            return col, state
        logits = logits.clone()
        for b, k in torch.nonzero(col != ref).tolist():
            mine, theirs = int(col[b, k]), int(ref[b, k])
            gap = float(logits[b, k, mine] - logits[b, k, theirs])
            assert gap <= TIE, f"column {t} codebook {k}: tokens {mine} vs {theirs}, gap {gap}"
            logits[b, k, theirs] = logits[b, k, mine] + 1.0
            forced.append((t, k, gap))
        return sample(logits, t, *a, **kw)

    monkeypatch.setattr(tgen, "_sample_column", follow_jax_at_ties)
    got = tgen.generate_tokens(port, tc.GenerationConfig(**dataclasses.asdict(gen)),
                               *(torch.from_numpy(x) for x in (desc, dm, prompt, pm)),
                               cache_dtype=BF16)
    np.testing.assert_array_equal(got.delayed_ids.numpy(), np.asarray(want.delayed_ids))
    np.testing.assert_array_equal(got.codes.numpy(), np.asarray(want.codes))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))
    assert got.steps == int(want.steps)
