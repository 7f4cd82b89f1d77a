"""The port's pure ops against the JAX package's: delay pattern, positions,
masks and sampling. Inputs come from numpy with fixed seeds; results must be
exactly equal (RoPE's fp32 cos/sin to 1 ulp, since the two libraries'
transcendental functions may round differently)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parler_tts_tpu.config import GenerationConfig as JGen
from parler_tts_tpu.ops import delay_pattern as jdp
from parler_tts_tpu.ops import masks as jmasks
from parler_tts_tpu.ops import positions as jpos
from parler_tts_tpu.ops import sampling as jsam
from parler_tts_tpu.runtime.generate import _sample_column as j_sample_column
from parler_tts_tpu_torch.config import GenerationConfig
from parler_tts_tpu_torch.ops import delay_pattern as tdp
from parler_tts_tpu_torch.ops import masks as tmasks
from parler_tts_tpu_torch.ops import positions as tpos
from parler_tts_tpu_torch.ops import sampling as tsam
from parler_tts_tpu_torch.runtime.generate import _process_column, _sample_column

BOS, PAD = 1025, 1024


def t(x):
    return torch.from_numpy(np.array(x))


def eq(port, ref):
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))


# ------------------------------------------------------------ delay pattern
@pytest.mark.parametrize("seq_len,max_length", [(1, 20), (4, 20), (3, 12), (1, 5)])
def test_delay_pattern_build_apply_undelay(seq_len, max_length):
    k = 4
    rng = np.random.default_rng(seq_len * 100 + max_length)
    ids = rng.integers(0, 1024, (2, k, seq_len)).astype(np.int64)
    ids[:, :, 0] = BOS
    j_first, j_pat = jdp.build_delay_pattern_mask(jnp.asarray(ids), BOS, PAD, max_length)
    t_first, t_pat = tdp.build_delay_pattern_mask(t(ids), BOS, PAD, max_length)
    eq(t_first, j_first)
    eq(t_pat, j_pat)
    full = rng.integers(0, 1024, (2, k, max_length)).astype(np.int64)
    eq(tdp.apply_delay_pattern_mask(t(full), t_pat),
       jdp.apply_delay_pattern_mask(jnp.asarray(full), j_pat))
    if max_length > k:
        eq(tdp.undelay_pattern(t(full), k), jdp.undelay_pattern(jnp.asarray(full), k))


def test_valid_frame_lengths_and_flatten():
    rng = np.random.default_rng(1)
    codes = rng.integers(0, 1030, (3, 9, 40))
    codes[1] = rng.integers(0, 1024, (9, 40))  # one all-valid row
    eq(tdp.valid_frame_lengths(t(codes), 1024),
       jdp.valid_frame_lengths(jnp.asarray(codes), 1024))
    flat = tdp.flatten_codebooks(t(codes))
    eq(flat, jdp.flatten_codebooks(jnp.asarray(codes)))
    eq(tdp.unflatten_codebooks(flat, 9), codes)


# ------------------------------------------------------------- positions
@pytest.mark.parametrize("dim", [64, 65])
def test_sinusoidal_table_and_embed(dim):
    table_j = jpos.sinusoidal_table(128, dim)
    table_t = tpos.sinusoidal_table(128, dim)
    eq(table_t, table_j)
    pos = np.random.default_rng(dim).integers(0, 128, (2, 7))
    eq(tpos.sinusoidal_embed(table_t, t(pos)), jpos.sinusoidal_embed(table_j, jnp.asarray(pos)))


def test_rope_cos_sin_and_apply():
    rng = np.random.default_rng(2)
    pos = rng.integers(0, 500, (2, 6))
    cos_j, sin_j = jpos.rope_cos_sin(jnp.asarray(pos), 16, 10000.0)
    cos_t, sin_t = tpos.rope_cos_sin(t(pos), 16, 10000.0)
    ulp = dict(rtol=0, atol=np.spacing(np.float32(1.0)))
    np.testing.assert_allclose(cos_t.numpy(), np.asarray(cos_j), **ulp)
    np.testing.assert_allclose(sin_t.numpy(), np.asarray(sin_j), **ulp)
    x = rng.normal(size=(2, 6, 3, 16)).astype(np.float32)
    # same cos/sin into both apply_rope: the rotation itself is exact
    eq(tpos.apply_rope(t(x), t(np.asarray(cos_j)), t(np.asarray(sin_j))),
       jpos.apply_rope(jnp.asarray(x), cos_j, sin_j))
    eq(tpos.rotate_half(t(x)), jpos.rotate_half(jnp.asarray(x)))


# ----------------------------------------------------------------- masks
@pytest.mark.parametrize("window", [None, 3])
def test_causal_self_attention_bias(window):
    rng = np.random.default_rng(3)
    q_pos = np.array([[0, 1, 2, 3], [4, 5, 6, 7]])
    kv_valid = rng.random((2, 10)) > 0.3
    eq(tmasks.causal_self_attention_bias(t(q_pos), t(kv_valid), window),
       jmasks.causal_self_attention_bias(jnp.asarray(q_pos), jnp.asarray(kv_valid), window))


def test_padding_cross_attention_bias():
    mask = np.array([[1, 1, 0, 1], [0, 1, 1, 1]], np.int32)
    eq(tmasks.padding_cross_attention_bias(t(mask), 3),
       jmasks.padding_cross_attention_bias(jnp.asarray(mask), 3))
    assert tmasks.padding_cross_attention_bias(None, 3) is None


# -------------------------------------------------------------- sampling
def eos_state(seed, b=3, k=4):
    rng = np.random.default_rng(seed)
    seen = rng.random((b, k)) > 0.5
    first = rng.integers(0, k, (b,)).astype(np.int32)
    return (jsam.EosState(jnp.asarray(seen), jnp.asarray(first)),
            tsam.EosState(t(seen), t(first)))


def test_eos_state_ops():
    j, p = eos_state(4)
    ja, pa = jsam.advance_eos_state(j, 4), tsam.advance_eos_state(p, 4)
    eq(pa.first_unfinished, ja.first_unfinished)
    logits = np.random.default_rng(5).normal(size=(3, 4, 12)).astype(np.float32)
    eq(tsam.mask_eos_ordering(t(logits), pa, 7), jsam.mask_eos_ordering(jnp.asarray(logits), ja, 7))
    sampled = np.array([[7, 1, 7, 2], [0, 7, 3, 3], [7, 7, 7, 7]])
    eq(tsam.record_sampled(pa, t(sampled), 7).eos_seen,
       jsam.record_sampled(ja, jnp.asarray(sampled), 7).eos_seen)
    init_j, init_t = jsam.init_eos_state(3, 4), tsam.init_eos_state(3, 4)
    eq(init_t.eos_seen, init_j.eos_seen)
    eq(init_t.first_unfinished, init_j.first_unfinished)


@pytest.mark.parametrize("cur", [3, 9])
def test_min_length_suppression(cur):
    logits = np.random.default_rng(6).normal(size=(2, 4, 12)).astype(np.float32)
    eq(tsam.suppress_eos_before_min_length(t(logits), cur, 8, 7),
       jsam.suppress_eos_before_min_length(jnp.asarray(logits), jnp.int32(cur), 8, 7))


@pytest.mark.parametrize("temperature,top_k,top_p", [
    (1.0, 0, 1.0), (0.7, 0, 1.0), (1.0, 5, 1.0), (1.0, 0, 0.8), (1.3, 20, 0.9),
])
def test_warpers(temperature, top_k, top_p):
    logits = np.random.default_rng(7).normal(size=(2, 4, 64)).astype(np.float32) * 3
    x = jnp.asarray(logits)
    if temperature != 1.0:
        x = jsam.apply_temperature(x, temperature)
    want = jsam.apply_top_p(jsam.apply_top_k(x, top_k), top_p)
    got = tsam.process_logits(t(logits), temperature=temperature, top_k=top_k, top_p=top_p)
    eq(got, want)


def test_greedy_sample_tokens():
    logits = np.random.default_rng(8).normal(size=(3, 4, 50)).astype(np.float32)
    eq(tsam.sample_tokens(t(logits), do_sample=False),
       jsam.sample_tokens(jax.random.key(0), jnp.asarray(logits), do_sample=False))


def test_sampled_tokens_follow_the_processed_distribution():
    """Philox and threefry differ, so sampled tokens are checked only for
    staying inside the top-k support the processors leave."""
    logits = np.random.default_rng(9).normal(size=(4, 4, 64)).astype(np.float32)
    g = torch.Generator().manual_seed(0)
    toks = tsam.sample_tokens(t(logits), do_sample=True, top_k=3, generator=g)
    top3 = np.argsort(-logits, axis=-1)[..., :3]
    assert (top3 == toks.numpy()[..., None]).any(-1).all()


GUARD_CASES = [
    # (codebook_guard, min_new_tokens, temperature, top_k, top_p, t)
    (None, 0, 1.0, 0, 1.0, 5),
    (40, 0, 1.0, 0, 1.0, 5),
    (40, 10, 1.0, 0, 1.0, 5),
    (40, 3, 0.8, 7, 0.9, 12),
]


@pytest.mark.parametrize("guard,min_new,temp,top_k,top_p,step", GUARD_CASES)
def test_processed_logits_of_a_sampling_event(guard, min_new, temp, top_k, top_p, step):
    """The port's processors + warpers equal the JAX `_sample_column`'s
    chain (guard -> min-length -> EOS ordering -> temperature/top-k/top-p)."""
    eos, v, k = 48, 60, 4
    logits = np.random.default_rng(10).normal(size=(3, k, v)).astype(np.float32) * 2
    j_state, t_state = eos_state(11)
    gen_j = JGen(codebook_guard=guard, min_new_tokens=min_new, eos_token_id=eos,
                 pad_token_id=eos, bos_token_id=eos + 1)
    x = jnp.asarray(logits)
    if guard is not None:
        ids = jnp.arange(v)
        blocked = (ids >= guard) & (ids != eos)
        x = jnp.where(blocked[None, None, :], jnp.finfo(jnp.float32).min, x)
    if min_new > 0:
        x = jsam.suppress_eos_before_min_length(x, jnp.int32(step), min_new + 1, eos)
    j_adv = jsam.advance_eos_state(j_state, k)
    x = jsam.mask_eos_ordering(x, j_adv, eos)
    if temp != 1.0:
        x = jsam.apply_temperature(x, temp)
    want = jsam.apply_top_p(jsam.apply_top_k(x, top_k), top_p)

    gen_t = GenerationConfig(codebook_guard=guard, min_new_tokens=min_new, eos_token_id=eos,
                             pad_token_id=eos, bos_token_id=eos + 1)
    got, t_adv = _process_column(t(logits), step, t_state, gen_t, k, prompt_cols=1)
    got = tsam.process_logits(got, temperature=temp, top_k=top_k, top_p=top_p)
    eq(got, want)
    eq(t_adv.first_unfinished, j_adv.first_unfinished)
    assert gen_j.codebook_guard == gen_t.codebook_guard


@pytest.mark.parametrize("guard,min_new,temp,top_k,top_p,step", GUARD_CASES)
def test_greedy_sample_column(guard, min_new, temp, top_k, top_p, step):
    """Greedy `_sample_column`: identical stored column and EOS state."""
    eos, v, k, length = 48, 60, 4, 20
    rng = np.random.default_rng(12)
    logits = rng.normal(size=(3, k, v)).astype(np.float32) * 2
    logits[:, :, eos] += 1.5  # make EOS competitive so the ordering rules act
    j_state, t_state = eos_state(13)
    start = np.full((3, k, 1), eos + 1)
    _, pattern = jdp.build_delay_pattern_mask(jnp.asarray(start), eos + 1, eos, length)
    kw = dict(codebook_guard=guard, min_new_tokens=min_new, temperature=temp, top_k=top_k,
              top_p=top_p, do_sample=False, eos_token_id=eos, pad_token_id=eos,
              bos_token_id=eos + 1, max_length=length)
    j_col, j_new = j_sample_column(jnp.asarray(logits), jnp.int32(step), j_state, pattern,
                                   jax.random.key(0), JGen(**kw), k)
    t_col, t_new = _sample_column(t(logits), step, t_state, t(np.asarray(pattern)),
                                  GenerationConfig(**kw), k)
    eq(t_col, j_col)
    eq(t_new.eos_seen, j_new.eos_seen)
    eq(t_new.first_unfinished, j_new.first_unfinished)
