"""Streaming in the port against the JAX package, on the CPU, fp32, with the
tiny configs of `tests/test_torch_pipeline.py` (after the JAX package's
`tests/test_pipeline.py` streaming tests; its per-row speculative case is
not ported).

  * `make_stream_functions`: greedy stream tokens equal the port's offline
    ones and the JAX stream's (`make_stream_functions` with an fp32 cache),
    with and without a voice prompt; `min_new_tokens` counts from the voice
    prompt's end (doctored weights that always favour EOS); once done, a
    chunk changes nothing, and after an early exit the state equals the JAX
    stream's frozen one (t, ids, EOS state), its cache rows past the freeze
    zero.
  * `stream`: the chunk count and each chunk's sample count equal the JAX
    stream's, and the waveform lies within 1e-5 of it (`test_torch_pipeline`'s
    waveform tolerance, conv_out scaled to the unit range); incremental
    decode equals the full decode when the context covers the utterance, and
    lies within the JAX test's 1e-4 of it with a sliding window.
  * `stream_batch`: two identical rows give the single stream's chunks
    within the JAX test's 1e-3, with and without a voice prompt; each row's
    valid samples sum to the offline lengths.
  * `warmup_stream_async` (success, and a failure re-raised by `join`),
    `ParlerTTSStreamer` (its chunks, a producer error raised on the
    consumer's side) and `pcm_stream` (the bytes of `float_to_pcm16` of the
    stream's chunks, through the native ring buffer).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parler_tts_tpu.runtime.generate import make_stream_functions as jax_stream_functions
from parler_tts_tpu.runtime.pipeline import ParlerTTSPipeline as JPipeline
from parler_tts_tpu_torch.native import float_to_pcm16_plain
from parler_tts_tpu_torch.runtime.generate import make_stream_functions
from parler_tts_tpu_torch.runtime.streamer import ParlerTTSStreamer
from test_torch_pipeline import CFG, GEN, PAD, ids, jax_params, port_pipeline

WAVE_TOL = dict(atol=1e-5, rtol=1e-4)


@pytest.fixture(scope="module")
def pair():
    return jax_params(CFG, seed=0)


@pytest.fixture(scope="module")
def pipes(pair):
    """(the port's pipeline, the JAX pipeline with an fp32-cache stream)."""
    jm, params, jdac, dac_params = pair
    port = port_pipeline(CFG, params, dac_params, GEN, frame_bucket=8)
    jpipe = JPipeline(jm, params, jdac, dac_params, GEN, frame_bucket=8)
    jpipe._stream_fns = jax_stream_functions(jm, GEN, cache_dtype=jnp.float32)
    return port, jpipe


def one(seed):
    """Row 0 of `ids(seed)`: a B=1 request with a left-padded prompt."""
    return [x[:1] for x in ids(seed=seed)]


def voice(seed, b=1, t0=3):
    return np.random.default_rng(seed).integers(0, PAD, size=(b, 4, t0)).astype(np.int32)


def torch_ids(*arrays):
    return [None if a is None else torch.from_numpy(np.asarray(a)).long() for a in arrays]


def run_stream(fns, request, chunk, voice_codes=None):
    prefill_fn, step_fn = fns
    state = prefill_fn(*torch_ids(*request), None,
                       *torch_ids(voice_codes) if voice_codes is not None else ())
    while state.t < GEN.max_length and not bool(state.eos.eos_seen.all()):
        step_fn(state, chunk)
    return state


def run_jax_stream(jm, gen, params, request, chunk, voice_codes=None):
    prefill_fn, step_fn = jax_stream_functions(jm, gen, cache_dtype=jnp.float32)
    extra = (jnp.asarray(voice_codes),) if voice_codes is not None else ()
    state = prefill_fn(params, *(jnp.asarray(x) for x in request), jax.random.key(0), *extra)
    while int(state.t) < gen.max_length and not bool(jnp.all(state.eos.eos_seen)):
        state = step_fn(params, state, chunk)
    return state


@pytest.mark.parametrize("steered", [False, True])
def test_stream_tokens_match_offline_and_jax(pair, pipes, steered):
    jm, params, _, _ = pair
    port, _ = pipes
    request = one(3)
    codes = voice(9) if steered else None
    offline = port.generate_codes(*request, decoder_prompt_codes=codes)
    state = run_stream(make_stream_functions(port.model, port.generation_config, torch.float32),
                       request, 6, voice_codes=codes)
    assert state.prompt_cols == 1 + (codes.shape[-1] if steered else 0)
    np.testing.assert_array_equal(state.out_ids.numpy(), offline.delayed_ids.numpy())
    want = run_jax_stream(jm, GEN, params, request, 6, voice_codes=codes)
    np.testing.assert_array_equal(state.out_ids.numpy(), np.asarray(want.out_ids))
    assert state.t == int(want.t) == offline.steps


def test_stream_min_new_tokens_voice_steering_adversarial(pair):
    """Weights that always favour EOS (final LN scale 0, a one-hot bias, heads
    that put all mass on EOS): codebook 0's first EOS lands at column
    min_new_tokens + s0 offline, in the JAX stream and in the port's stream."""
    jm, params, _, dac_params = pair
    params = jax.tree.map(np.copy, params)
    dec = params["decoder"]
    ln = dec["decoder"]["layer_norm"]
    ln["scale"] = np.zeros_like(ln["scale"])
    ln["bias"] = np.zeros_like(ln["bias"])
    ln["bias"][0] = 1.0
    dec["lm_heads"] = np.zeros_like(dec["lm_heads"])
    dec["lm_heads"][:, 0, GEN.eos_token_id] = 5.0
    request, codes = one(21), voice(22)
    port = port_pipeline(CFG, params, dac_params, GEN)
    offline = port.generate_codes(*request, decoder_prompt_codes=codes)
    s0 = 1 + codes.shape[-1]
    delayed = offline.delayed_ids.numpy()
    eos_cols = np.nonzero(delayed[0, 0] == GEN.eos_token_id)[0]
    assert eos_cols.size and eos_cols[0] == GEN.min_new_tokens + s0
    state = run_stream(make_stream_functions(port.model, port.generation_config, torch.float32),
                       request, 3, voice_codes=codes)
    np.testing.assert_array_equal(state.out_ids.numpy(), delayed)
    want = run_jax_stream(jm, GEN, params, request, 3, voice_codes=codes)
    np.testing.assert_array_equal(state.out_ids.numpy(), np.asarray(want.out_ids))
    assert state.t == int(want.t) == offline.steps < GEN.max_length


def test_stream_state_freezes_as_the_jax_stream(pair):
    """EOS-tilted weights end the stream before max_length in the middle of a
    chunk: the state is the JAX stream's frozen one, its cache rows past the
    freeze are zero, and a later chunk changes nothing."""
    jm, params, _, dac_params = pair
    params = jax.tree.map(np.copy, params)
    dec = params["decoder"]
    dec["decoder"]["layer_norm"]["bias"] = np.full_like(dec["decoder"]["layer_norm"]["bias"], 0.5)
    dec["lm_heads"][:, :, PAD] += 1.0
    gen = dataclasses.replace(GEN, max_length=60, min_new_tokens=6)
    request = one(4)
    port = port_pipeline(CFG, params, dac_params, gen)
    fns = make_stream_functions(port.model, port.generation_config, torch.float32)
    state = fns[0](*torch_ids(*request))
    while state.t < gen.max_length and not bool(state.eos.eos_seen.all()):
        fns[1](state, 7)
    want = run_jax_stream(jm, gen, params, request, 7)
    assert state.t == int(want.t) < gen.max_length
    assert (state.t - (state.prompt_cols + 1)) % 7  # it froze inside a chunk
    np.testing.assert_array_equal(state.out_ids.numpy(), np.asarray(want.out_ids))
    np.testing.assert_array_equal(state.eos.eos_seen.numpy(), np.asarray(want.eos.eos_seen))
    np.testing.assert_array_equal(state.eos.first_unfinished.numpy(),
                                  np.asarray(want.eos.first_unfinished))
    frozen = state.s_p + state.t - 1
    assert state.cache.index == frozen
    assert not state.cache.self_k[:, :, frozen:].any()
    assert not state.cache.self_v[:, :, frozen:].any()
    before = (state.t, state.out_ids.clone(), state.cache.self_k.clone(), state.eos)
    fns[1](state, 7)
    assert state.t == before[0] and state.eos is before[3]
    assert torch.equal(state.out_ids, before[1]) and torch.equal(state.cache.self_k, before[2])


@pytest.mark.parametrize("steered", [False, True])
def test_stream_chunks_match_jax(pipes, steered):
    port, jpipe = pipes
    request = one(3)
    codes = voice(9) if steered else None
    got = list(port.stream(*request, play_steps=6, decoder_prompt_codes=codes))
    want = list(jpipe.stream(*request, play_steps=6, decoder_prompt_codes=codes))
    assert len(got) == len(want) > 1
    assert [c.shape for c in got] == [c.shape for c in want]
    for g, w in zip(got, want):
        assert g.dtype == np.float32
        np.testing.assert_allclose(g, w, **WAVE_TOL)


def test_stream_incremental_matches_full_decode(pair, pipes):
    port, _ = pipes
    request = one(3)
    full = list(port.stream(*request, play_steps=6, incremental=False))
    wide = list(port.stream(*request, play_steps=6, context_frames=1000))
    assert [c.shape for c in wide] == [c.shape for c in full]
    np.testing.assert_array_equal(np.concatenate(wide, axis=1), np.concatenate(full, axis=1))
    # a longer utterance, so the window slides: 40 frames of context cover the
    # codec's receptive field (~31 frames at this geometry)
    _, params, _, dac_params = pair
    gen96 = dataclasses.replace(GEN, max_length=96, min_new_tokens=90, do_sample=True,
                                codebook_guard=PAD)
    pipe96 = port_pipeline(CFG, params, dac_params, gen96, frame_bucket=8)
    full96 = np.concatenate(list(pipe96.stream(*request, play_steps=12, seed=5,
                                               incremental=False)), axis=1)
    inc96 = np.concatenate(list(pipe96.stream(*request, play_steps=12, seed=5,
                                              context_frames=40)), axis=1)
    assert inc96.shape == full96.shape and full96.shape[1] >= 80 * CFG.audio_encoder.hop_length
    np.testing.assert_allclose(inc96, full96, atol=1e-4)


@pytest.mark.parametrize("steered", [False, True])
def test_stream_batch_matches_single_stream(pipes, steered):
    port, _ = pipes
    request = one(6)
    codes = voice(17) if steered else None
    single = list(port.stream(*request, play_steps=6, seed=21, decoder_prompt_codes=codes))
    batch = [np.tile(x, (2, 1)) for x in request]
    batched = list(port.stream_batch(*batch, play_steps=6, seed=21, decoder_prompt_codes=(
        None if codes is None else np.tile(codes, (2, 1, 1)))))
    assert len(batched) == len(single) > 0
    for (chunk, valid), ref in zip(batched, single):
        assert chunk.shape == (2, ref.shape[1])
        np.testing.assert_array_equal(valid[0], valid[1])
        for i in range(2):
            np.testing.assert_allclose(chunk[i], ref[0], atol=1e-3)


def test_stream_batch_per_stream_accounting(pipes):
    port, _ = pipes
    request = ids(seed=6, b=2)
    _, lengths = port.generate(request[0], request[2], desc_mask=request[1],
                               prompt_mask=request[3], seed=21)
    got = np.zeros(2, np.int64)
    for chunk, valid in port.stream_batch(*request, play_steps=6, seed=21):
        assert chunk.shape[0] == 2 and valid.shape == (2,)
        assert (valid >= 0).all() and (valid <= chunk.shape[1]).all()
        got += valid
    np.testing.assert_array_equal(got, np.asarray(lengths, np.int64))
    assert got.sum() > 0


def test_warmup_stream_async_success_and_failure(pipes, monkeypatch):
    port, _ = pipes
    request = one(3)
    thread = port.warmup_stream_async(*request, play_steps=16)
    thread.join(timeout=120)
    assert not thread.is_alive()

    def boom(*a, **kw):
        raise RuntimeError("warmup exploded")
        yield  # pragma: no cover - a generator, as stream() is

    monkeypatch.setattr(port, "stream", boom)
    thread = port.warmup_stream_async(*request, play_steps=16)
    with pytest.raises(RuntimeError, match="stream warmup failed"):
        thread.join(timeout=120)


def test_streamer_iterates_the_stream_and_reraises(pipes, monkeypatch):
    port, _ = pipes
    request = one(5)
    want = list(port.stream(*request, play_steps=6, seed=7))
    got = list(ParlerTTSStreamer(port, play_steps=6, timeout=120).start(*request, seed=7))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w[0])
    with pytest.raises(ValueError, match="batch size 1"):
        ParlerTTSStreamer(port).start(*ids(seed=5, b=2))

    def boom(*a, **kw):
        yield want[0]
        raise RuntimeError("producer exploded")

    monkeypatch.setattr(port, "stream", boom)
    streamer = ParlerTTSStreamer(port, play_steps=6, timeout=120).start(*request)
    with pytest.raises(RuntimeError, match="producer exploded"):
        list(streamer)


def test_streamer_pcm_stream(pipes):
    """PCM through the native ring buffer: the bytes of the stream's chunks."""
    port, _ = pipes
    request = one(5)
    chunks = list(port.stream(*request, play_steps=6, seed=7))
    want = b"".join(float_to_pcm16_plain(c[0]) for c in chunks)
    streamer = ParlerTTSStreamer(port, play_steps=6)
    got = b"".join(streamer.pcm_stream(*request, seed=7, ring_capacity=1000))
    assert got == want and len(got) == 2 * sum(c.shape[1] for c in chunks)
