"""Speculative decoding in the port against the JAX package, on the CPU in
fp32, at `tests/test_speculative.py`'s tiny config (the JAX model with
use_flash_decode=True, whose window forward runs the Pallas K1 in interpret
mode, and an fp32 cache on both sides):

  * `speculative_accept` and `history_lookup_window` equal JAX's on the same
    inputs (delta proposals, an empty residual; shared and per-row,
    periodic history, no match, early columns);
  * greedy `generate_tokens_speculative` gives JAX's delayed ids, codes,
    lengths, steps, forwards and columns over windows 3-5, lookup 0/3,
    per-row or shared, voice steering, left-padded batches and a sliding
    window, and the AR loop's tokens;
  * sampled runs give JAX's tokens when `draw_noise` replays JAX's draws
    from the same key-split sequence, and the port's own sampler keeps the
    AR sampler's per-column marginals;
  * forwards run past the end change nothing; a (B,) cache index writes
    each row at its own offset as JAX's `self_attention` does;
  * the pipeline's route and refusals, and speculative `stream` /
    `stream_batch` chunks and tokens equal to the plain ones.
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
from parler_tts_tpu.ops.masks import padding_cross_attention_bias
from parler_tts_tpu.ops.sampling import speculative_accept as j_accept
from parler_tts_tpu.runtime.speculative import history_lookup_window as j_lookup
from parler_tts_tpu.runtime.speculative import make_generate_speculative as j_speculative
from parler_tts_tpu_torch import config as tc
from parler_tts_tpu_torch.convert import load_jax_params
from parler_tts_tpu_torch.models.decoder import DecoderCache, ParlerForCausalLM
from parler_tts_tpu_torch.models.parler import ParlerTTS
from parler_tts_tpu_torch.ops import masks as tmasks
from parler_tts_tpu_torch.ops.sampling import speculative_accept
from parler_tts_tpu_torch.runtime import speculative as tspec
from parler_tts_tpu_torch.runtime.generate import generate_tokens
from parler_tts_tpu_torch.runtime.pipeline import ParlerTTSPipeline
from parler_tts_tpu_torch.runtime.speculative import (
    _finalize_spec_output,
    _init_spec_state,
    _make_spec_step,
    generate_tokens_speculative,
    history_lookup_window,
    make_generate_speculative,
    make_stream_functions_speculative,
)
from test_speculative import CFG, PAD, _gen_cfg, _inputs
from test_torch_models import dec_config, host, port_config, t
from test_torch_pipeline import CFG as PIPE_CFG
from test_torch_pipeline import GEN as PIPE_GEN
from test_torch_pipeline import PAD as PIPE_PAD
from test_torch_pipeline import ids as pipe_ids
from test_torch_pipeline import jax_params as pipe_jax_params
from test_torch_pipeline import port_pipeline


def jparams(cfg, seed=3):
    model = JParler(cfg, use_flash_decode=True)
    params = model.init(
        jax.random.key(seed),
        jnp.zeros((1, 4), jnp.int32), jnp.ones((1, 4), jnp.int32),
        jnp.zeros((1, 3), jnp.int32), jnp.ones((1, 3), jnp.int32),
        jnp.zeros((1, 2, 3), jnp.int32),
    )["params"]
    port = ParlerTTS(port_config(cfg)).eval()
    load_jax_params(port, host(params))
    return model, params, port


@pytest.fixture(scope="module")
def setup():
    return jparams(CFG)


def tgen(gen):
    return tc.GenerationConfig(**dataclasses.asdict(gen))


def torch_ids(*arrays):
    return [None if a is None else torch.from_numpy(np.array(a)).long() for a in arrays]


def assert_same(port_out, jax_out):
    np.testing.assert_array_equal(port_out.delayed_ids.numpy(), np.asarray(jax_out.delayed_ids))
    np.testing.assert_array_equal(port_out.codes.numpy(), np.asarray(jax_out.codes))
    np.testing.assert_array_equal(port_out.lengths.numpy(), np.asarray(jax_out.lengths))
    assert port_out.steps == int(jax_out.steps)


# ---------------------------------------------------------------- units
@pytest.mark.parametrize("case", ["dirichlet", "delta proposal", "empty residual"])
def test_speculative_accept_matches_jax(case):
    n, v = 4096, 8
    rng = np.random.default_rng(["dirichlet", "delta proposal", "empty residual"].index(case))
    p = rng.dirichlet(np.full(v, 0.4), size=n).astype(np.float32)
    q = rng.dirichlet(np.full(v, 0.7), size=n).astype(np.float32)
    if case == "delta proposal":
        q = np.eye(v, dtype=np.float32)[np.argmax(p, axis=-1)]
    elif case == "empty residual":
        q = p.copy()
    cand = np.array([rng.choice(v, p=qi / qi.sum()) for qi in q], np.int64)
    u = rng.random(n).astype(np.float32)
    g = rng.gumbel(size=(n, v)).astype(np.float32)
    want, want_acc = j_accept(jnp.asarray(p), jnp.asarray(q), jnp.asarray(cand, jnp.int32),
                              jnp.asarray(u), jnp.asarray(g))
    got, acc = speculative_accept(t(p), t(q), t(cand), t(u), t(g))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(acc.numpy(), np.asarray(want_acc))
    assert 0 < acc.float().mean() <= 1


def _periodic(b=1, k_cb=3, length=32, period=5):
    base = np.arange(period * k_cb).reshape(period, k_cb) % 11
    hist = np.tile(base, (length // period + 1, 1))[:length].T[None]
    return np.repeat(hist, b, axis=0).astype(np.int32)


@pytest.mark.parametrize("case", ["shared periodic", "per-row periodic", "no match",
                                  "early columns"])
def test_history_lookup_window_matches_jax(case):
    w, g = 4, 2
    if case in ("no match", "early columns"):
        length, k_cb, g = 20, 2, 3
        out = (np.arange(length)[None, None, :] * 10
               + np.arange(k_cb)[None, :, None]).astype(np.int32)
        t_, n_ = (10, 1) if case == "no match" else (1, 1)
        per_row = False
    elif case == "shared periodic":
        out, t_, n_, per_row = _periodic(), 16, 2, False
    else:
        out, t_, n_, per_row = _periodic(b=2), [16, 11], [2, 1], True
    b, k_cb = out.shape[:2]
    t_a, n_a = np.array(t_), np.array(n_)
    cols = np.broadcast_to(t_a, (b,))[:, None] + np.arange(w)[None, :]
    stored = np.stack([out[i][:, cols[i]] for i in range(b)]).transpose(2, 0, 1)   # (W, B, K)
    fallback = np.random.default_rng(0).integers(0, 5, (w, b, k_cb)).astype(np.int32)
    want, found = j_lookup(jnp.asarray(out), jnp.asarray(stored), jnp.asarray(t_a),
                           jnp.asarray(n_a), jnp.asarray(fallback), g_n=g, w=w, k_cb=k_cb,
                           per_row=per_row, return_found=True)
    got, got_found = history_lookup_window(t(out).long(), t(stored).long(), t(t_a), t(n_a),
                                           t(fallback).long(), g_n=g, w=w, return_found=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_found.numpy(), np.asarray(found))
    assert got_found.all() == (case in ("shared periodic", "per-row periodic"))


# ------------------------------------------------------------- greedy
GREEDY_CASES = {
    # name: (window, lookup, per_row, batch, left_pad, voice, min_new_tokens)
    "w3 lookup0 shared": (3, 0, False, 1, 0, False, 4),
    "w4 lookup3 shared left-padded batch": (4, 3, False, 2, 1, False, 4),
    "w5 lookup3 per-row": (5, 3, True, 3, 0, False, 4),
    "w4 lookup0 per-row left-padded, rows finish early": (4, 0, True, 3, 2, False, 0),
    "w4 lookup3 shared voice": (4, 3, False, 1, 2, True, 2),
    "w3 lookup3 per-row voice left-padded": (3, 3, True, 2, 1, True, 2),
}


@pytest.mark.parametrize("name", list(GREEDY_CASES))
def test_greedy_matches_jax(setup, name):
    w, lookup, per_row, b, left_pad, voice, mnt = GREEDY_CASES[name]
    jm, params, port = setup
    gen = _gen_cfg(do_sample=False, min_new_tokens=mnt)
    inputs = _inputs(b=b, seed=len(name), left_pad=left_pad)
    codes = (np.random.default_rng(1).integers(0, PAD, size=(b, 3, 3)).astype(np.int32)
             if voice else None)
    extra = (jnp.asarray(codes),) if voice else ()
    want, want_stats = j_speculative(jm, gen, window=w, cache_dtype=jnp.float32,
                                     per_row=per_row, lookup_ngram=lookup)(
        params, *inputs, jax.random.key(0), *extra)
    got, stats = make_generate_speculative(port, tgen(gen), window=w, cache_dtype=torch.float32,
                                           per_row=per_row, lookup_ngram=lookup)(
        *torch_ids(*inputs), decoder_prompt_codes=torch_ids(codes)[0])
    assert_same(got, want)
    assert (stats.forwards, stats.columns, stats.frozen) == (
        int(want_stats.forwards), int(want_stats.columns), 0)
    ar = generate_tokens(port, tgen(gen), *torch_ids(*inputs),
                         decoder_prompt_codes=torch_ids(codes)[0], cache_dtype=torch.float32)
    np.testing.assert_array_equal(got.delayed_ids.numpy(), ar.delayed_ids.numpy())
    assert stats.forwards < stats.columns


@pytest.mark.parametrize("variant", ["sliding_window", "rope", "prompt_cross_attention"])
def test_greedy_config_variants_match_jax(variant):
    dec_kw, top_kw, gen_kw = {}, {}, {}
    if variant == "rope":
        dec_kw = dict(rope_embeddings=True)
    elif variant == "sliding_window":
        dec_kw = dict(sliding_window=6)
        gen_kw = dict(cache_implementation="sliding_window")
    else:
        top_kw = dict(prompt_cross_attention=True)
    cfg = dataclasses.replace(CFG, decoder=dataclasses.replace(CFG.decoder, **dec_kw), **top_kw)
    jm, params, port = jparams(cfg, seed=4)
    gen = _gen_cfg(do_sample=False, **gen_kw)
    inputs = _inputs(b=2, seed=11, left_pad=1)
    want, want_stats = j_speculative(jm, gen, window=4, cache_dtype=jnp.float32,
                                     per_row=True)(params, *inputs, jax.random.key(1))
    got, stats = generate_tokens_speculative(port, tgen(gen), *torch_ids(*inputs),
                                             cache_dtype=torch.float32, window=4, per_row=True)
    assert_same(got, want)
    assert (stats.forwards, stats.columns) == (int(want_stats.forwards),
                                               int(want_stats.columns))


# ------------------------------------------------------------ sampled
def jax_draws(key):
    """`draw_noise` replaying the JAX path's draws: the first column's
    categorical and the first window split off the key in turn, then per
    forward a 4-way split for the uniforms, residual and proposal Gumbels."""
    st = {"rng": key, "i": 0, "keys": None}

    def draw(generator, kind, shape, device):
        i = st["i"]
        st["i"] += 1
        if i < 2:
            st["rng"], sub = jax.random.split(st["rng"])
        else:
            j = (i - 2) % 3
            if j == 0:
                st["rng"], *st["keys"] = jax.random.split(st["rng"], 4)
            sub = st["keys"][j]
            assert kind == ("uniform" if j == 0 else "gumbel")
        x = (jax.random.uniform(sub, shape) if kind == "uniform"
             else jax.random.gumbel(sub, shape, jnp.float32))
        return torch.from_numpy(np.array(x)).to(device)

    return draw


SAMPLED_CASES = {
    "temperature 1, lookup 3, shared": (dict(do_sample=True), False, 3, 2),
    "temperature 0.7 + guard, per-row": (dict(do_sample=True, temperature=0.7,
                                              codebook_guard=PAD), True, 0, 3),
    "top_k 6, per-row, lookup 3": (dict(do_sample=True, top_k=6), True, 3, 2),
}


@pytest.mark.parametrize("name", list(SAMPLED_CASES))
def test_sampled_matches_jax_with_replayed_draws(setup, name, monkeypatch):
    gen_kw, per_row, lookup, b = SAMPLED_CASES[name]
    jm, params, port = setup
    gen = _gen_cfg(max_length=20, min_new_tokens=2, **gen_kw)
    inputs = _inputs(b=b, seed=7, left_pad=1)
    key = jax.random.key(5)
    want, want_stats = j_speculative(jm, gen, window=4, cache_dtype=jnp.float32,
                                     per_row=per_row, lookup_ngram=lookup)(params, *inputs, key)
    monkeypatch.setattr(tspec, "draw_noise", jax_draws(key))
    got, stats = generate_tokens_speculative(port, tgen(gen), *torch_ids(*inputs),
                                             cache_dtype=torch.float32, window=4,
                                             per_row=per_row, lookup_ngram=lookup)
    assert_same(got, want)
    assert (stats.forwards, stats.columns) == (int(want_stats.forwards),
                                               int(want_stats.columns))


def _marginals(delayed, v):
    b, k, n = delayed.shape
    out = np.zeros((k, n, v))
    for ki in range(k):
        for ti in range(n):
            out[ki, ti] = np.bincount(delayed[:, ki, ti], minlength=v) / b
    return out


@pytest.mark.parametrize("per_row,gen_kw", [
    (False, dict(do_sample=True, temperature=0.7, codebook_guard=PAD)),
    (True, dict(do_sample=True, top_k=6)),
], ids=["shared hoisted", "per-row top-k"])
def test_sampled_distribution_preserved(setup, per_row, gen_kw):
    """The port's speculative sampler against its AR sampler: per-column
    marginals over 768 copies of one request within the AR-vs-AR noise
    (`test_speculative.py::test_sampled_distribution_preserved`'s bound)."""
    _, _, port = setup
    gen = tgen(_gen_cfg(max_length=12, min_new_tokens=3, **gen_kw))
    b, v = 768, CFG.decoder.vocab_size
    inputs = [x.repeat_interleave(b, dim=0) for x in torch_ids(*_inputs(seed=3))]

    def run(fn, seed, **kw):
        return fn(port, gen, *inputs, torch.Generator().manual_seed(seed),
                  cache_dtype=torch.float32, **kw)

    a1 = run(generate_tokens, 11).delayed_ids.numpy()
    a2 = run(generate_tokens, 12).delayed_ids.numpy()
    s1, stats = run(generate_tokens_speculative, 13, window=4, per_row=per_row)
    m_a1, m_a2, m_s = _marginals(a1, v), _marginals(a2, v), _marginals(s1.delayed_ids.numpy(), v)
    tv_noise = 0.5 * np.abs(m_a1 - m_a2).sum(-1)
    tv_spec = 0.5 * np.abs(m_a1 - m_s).sum(-1)
    assert tv_spec.mean() < tv_noise.mean() + 3.0 * np.sqrt(v / (4 * b))
    assert tv_spec.max() < tv_noise.max() + 5 * np.sqrt(v / (4 * b))
    assert stats.columns >= stats.forwards * (b if per_row else 1)


# --------------------------------------------------- state machinery
@pytest.mark.parametrize("per_row", [False, True])
def test_forwards_past_the_end_change_nothing(setup, per_row):
    """What the card's exit poll does: forwards run after the loop's end are
    frozen, so the output, t, the EOS state and the forward count stay."""
    _, _, port = setup
    gen = tgen(_gen_cfg(do_sample=False, min_new_tokens=0))
    inputs = torch_ids(*_inputs(b=3, seed=9))
    with torch.inference_mode():
        state = _init_spec_state(port, gen, *inputs, None, None, torch.float32, 4, per_row)
        step = _make_spec_step(port, gen, 4, per_row=per_row, lookup_ngram=3)
        while tspec._running(state, gen.max_length, per_row):
            step(state)
        out, stats = _finalize_spec_output(state, gen, 3, PAD)
        before = (state.t.clone(), state.eos.eos_seen.clone(), state.cache.index.clone())
        for _ in range(3):
            step(state)
        again, stats_again = _finalize_spec_output(state, gen, 3, PAD)
    np.testing.assert_array_equal(again.delayed_ids.numpy(), out.delayed_ids.numpy())
    assert torch.equal(state.t, before[0]) and torch.equal(state.eos.eos_seen, before[1])
    assert torch.equal(state.cache.index, before[2])
    assert stats_again == stats._replace(frozen=3)


def test_per_row_cache_write_matches_jax():
    """A W=3 window forward with a (B,) cache index through K1 with (B,)
    limits: the logits and every cache row equal the JAX decoder's with a
    (B,) `cache_index` (a vmapped dynamic update)."""
    cfg = dec_config(2, False)
    b, s_max, s_enc, w = 2, 16, 4, 3
    rng = np.random.default_rng(0)
    enc = rng.normal(size=(b, s_enc, 64)).astype(np.float32)
    jm = JLM(cfg, use_flash_decode=True)
    params = jm.init(jax.random.key(1), jnp.zeros((b, 2, 64)),
                     jnp.broadcast_to(jnp.arange(2), (b, 2)), self_attn_bias=None,
                     encoder_hidden_states=jnp.asarray(enc))["params"]
    port = ParlerForCausalLM(port_config(cfg))
    load_jax_params(port, host(params))
    pre_k = rng.normal(size=(cfg.num_hidden_layers, b, s_max, 2 * cfg.head_dim)).astype(
        np.float32)
    jcache = JCache.zeros(cfg, b, s_max, s_enc, jnp.float32, flat_self=True)
    ck, cv = jm.apply({"params": params}, jnp.asarray(enc), method="precompute_cross_kv")
    jcache = jcache.replace(cross_k=ck, cross_v=cv, self_k=jnp.asarray(pre_k, jnp.float32),
                            self_v=jnp.asarray(pre_k[::-1], jnp.float32),
                            index=jnp.asarray([5, 2], jnp.int32))
    tcache = DecoderCache.zeros(port_config(cfg), b, s_max, s_enc, torch.float32)
    tcache.self_k.copy_(t(pre_k).float())
    tcache.self_v.copy_(t(pre_k[::-1].copy()).float())
    with torch.no_grad():
        tcache.cross_k, tcache.cross_v = port.precompute_cross_kv(t(enc))
    tcache.index = torch.tensor([5, 2])
    ids = rng.integers(0, 60, (b, 3, w))
    pos = np.array([[5, 6, 7], [2, 3, 4]])
    starts, limits = np.array([0, 1], np.int32), np.array([6, 3], np.int32)
    emb = jm.apply({"params": params}, jnp.asarray(ids, jnp.int32), method="embed_ids")
    want, jcache = jm.apply({"params": params}, emb, jnp.asarray(pos), self_attn_bias=None,
                            cross_attn_bias=padding_cross_attention_bias(None, w), cache=jcache,
                            decode_lengths=(jnp.asarray(starts), jnp.asarray(limits)))
    with torch.no_grad():
        got = port(port.embed_ids(t(ids).long()), t(pos).long(), self_attn_bias=None,
                   cross_attn_bias=tmasks.padding_cross_attention_bias(None, w), cache=tcache,
                   decode_lengths=(t(starts), t(limits)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(tcache.self_k.numpy(), np.asarray(jcache.self_k), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(tcache.self_v.numpy(), np.asarray(jcache.self_v), atol=1e-5,
                               rtol=1e-5)
    assert tcache.index.tolist() == [8, 5]
    untouched = np.ones((b, s_max), bool)
    untouched[0, 5:8] = untouched[1, 2:5] = False
    np.testing.assert_array_equal(tcache.self_k.numpy()[:, untouched], pre_k[:, untouched])


# ------------------------------------------------------------ pipeline
@pytest.fixture(scope="module")
def pipes():
    jm, params, _, dac_params = pipe_jax_params(PIPE_CFG)
    gen = dataclasses.replace(PIPE_GEN, max_length=40, min_new_tokens=30,
                              codebook_guard=PIPE_PAD)
    plain = port_pipeline(PIPE_CFG, params, dac_params, gen, frame_bucket=8)
    spec = {pr: ParlerTTSPipeline(plain.model, plain.dac, plain.generation_config,
                                  cache_dtype=torch.float32, device="cpu", frame_bucket=8,
                                  speculative_window=4, speculative_per_row=pr)
            for pr in (False, True)}
    return plain, spec


def test_pipeline_route_and_refusals(pipes):
    plain, spec = pipes
    request = pipe_ids(seed=6)
    want = plain.generate_codes(*request)
    for pipe in spec.values():
        got = pipe.generate_codes(*request)
        np.testing.assert_array_equal(got.delayed_ids.numpy(), want.delayed_ids.numpy())
        assert 1 <= pipe.last_spec_stats.forwards < pipe.last_spec_stats.columns
    assert plain.last_spec_stats is None
    kw = dict(cache_dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="requires speculative_window"):
        ParlerTTSPipeline(plain.model, plain.dac, speculative_per_row=True, **kw)
    with pytest.raises(ValueError, match="exclusive"):
        ParlerTTSPipeline(plain.model, plain.dac, speculative_window=4, fused_decode=True, **kw)
    with pytest.raises(ValueError, match="stream_batch"):
        next(spec[True].stream(*request))
    one = ParlerTTSPipeline.from_random(port_config(PIPE_CFG), seed=1, device="cpu",
                                        generation_config=plain.generation_config,
                                        speculative_window=3, speculative_lookup=0)
    assert (one.spec_window, one.spec_per_row, one.spec_lookup) == (3, False, 0)


@pytest.mark.parametrize("play_steps", [40, 7])
def test_spec_stream_matches_plain_stream(pipes, play_steps):
    """Flush i shows the columns below t_start + i * play_steps, so a
    speculative stream's flushes fall where the plain stream's do: the
    chunks are equal, sample for sample."""
    plain, spec = pipes
    request = [x[:1] for x in pipe_ids(seed=10)]
    want = list(plain.stream(*request, play_steps=play_steps))
    got = list(spec[False].stream(*request, play_steps=play_steps))
    assert len(got) == len(want) >= (1 if play_steps == 40 else 3)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_spec_stream_batch_per_row_matches_plain(pipes):
    """Per-row speculation at B=2 (a left-padded row, a right-padded
    description): the same chunks and valid counts as the plain batch."""
    plain, spec = pipes
    request = pipe_ids(seed=12)
    want = list(plain.stream_batch(*request, play_steps=7))
    got = list(spec[True].stream_batch(*request, play_steps=7))
    assert len(got) == len(want) >= 3
    for (a, va), (b, vb) in zip(got, want):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(va, vb)


@pytest.mark.parametrize("per_row", [False, True])
def test_spec_stream_tokens_match_offline(setup, per_row):
    """Chunk by chunk, the finalized columns of each row equal the offline
    speculative tokens, and every unfinished row advances >= n_steps."""
    _, _, port = setup
    gen = tgen(_gen_cfg(do_sample=False, min_new_tokens=2))
    inputs = torch_ids(*_inputs(b=3, seed=9, left_pad=1))
    off, stats = generate_tokens_speculative(port, gen, *inputs, cache_dtype=torch.float32,
                                             window=4, per_row=per_row)
    prefill, step = make_stream_functions_speculative(port, gen, window=4,
                                                      cache_dtype=torch.float32, per_row=per_row)
    state = prefill(*inputs)
    for _ in range(32):
        t_prev = torch.atleast_1d(state.t).clone()
        done_prev = (t_prev >= gen.max_length) | state.eos.eos_seen.all(dim=1)
        if not per_row:
            done_prev = done_prev.all().expand(1)
        if done_prev.all():
            break
        step(state, 5)
        t_now = torch.atleast_1d(state.t)
        done_now = state.eos.eos_seen.all(dim=1) if per_row else state.eos.eos_seen.all()
        ok = (t_now >= (t_prev + 5).clamp(max=gen.max_length)) | done_now
        assert ok[~done_prev].all()
        for i in range(3):
            ti = int(t_now[i if per_row else 0])
            np.testing.assert_array_equal(state.out_ids[i, :, :ti].numpy(),
                                          off.delayed_ids[i, :, :ti].numpy())
    else:
        raise AssertionError("the stream did not finish")
    assert int(state.n_fwd) == stats.forwards
