"""The serving modes a checkpoint or a caller selects, each held against the
JAX package on the same weights, on the CPU (tiny configs of
`tests/test_torch_pipeline.py` and `tests/test_torch_models.py`).

  * Text input: `_encode_text` over a stub tokenizer gives the JAX
    pipeline's ids and masks (padded to a multiple of 16, prompts on the
    left, descriptions on the right); `generate(text)` equals `generate` on
    those ids; no tokenizer raises `ValueError`.
  * `fused_qkv`: `fuse_qkv_params` equals the JAX transform; decoder logits
    within 2e-4 (`COMPONENTS.md` row 5) of the JAX fused model over a
    prefill and K1 decode steps; identical greedy ids; the exclusions raise.
  * `weight_quant="xla"`: decoder logits against the JAX model's
    `QuantDense(impl="xla")`, fp32 within 2e-4 and bf16 within half of
    JAX's own bf16-vs-fp32 gap (norm-relative, the rule of
    `tests/test_torch_models_bf16.py`); identical greedy ids in fp32.
  * `codec_dtype=torch.bfloat16`: fp32 audio within 1e-5 / 1e-4 of the JAX
    codec's decode after `cast_floating` (both compute in fp32 over
    bf16-rounded weights).
  * `cache_implementation="sliding_window"` with a window shorter than the
    span: identical greedy ids on left-padded prompts; in bf16, decoder
    logits over a prefill and four decode steps through the dense bias path
    with the window within half of JAX's own bf16-vs-fp32 gap on its window
    path (norm-relative, the rule of `tests/test_torch_models_bf16.py`).
  * `large_v1_decoder_config()` equals the JAX package's field for field.
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
from parler_tts_tpu.models.parler import fuse_qkv_params as jax_fuse_qkv
from parler_tts_tpu.ops.masks import causal_self_attention_bias, padding_cross_attention_bias
from parler_tts_tpu.runtime.generate import make_generate
from parler_tts_tpu.runtime.pipeline import ParlerTTSPipeline as JPipeline
from parler_tts_tpu.utils.dtypes import cast_floating
from parler_tts_tpu.utils.quantize import quantize_decoder_params as jax_quantize
from parler_tts_tpu_torch.codec.dac_model import DACModel
from parler_tts_tpu_torch.convert import load_jax_dac_params, load_jax_params, tensor_tree
from parler_tts_tpu_torch.models.decoder import DecoderCache, ParlerForCausalLM, QuantDense
from parler_tts_tpu_torch.models.parler import ParlerTTS, fuse_qkv_params
from parler_tts_tpu_torch.ops import masks as tmasks
from parler_tts_tpu_torch.runtime.pipeline import ParlerTTSPipeline
from test_torch_checkpoint import port_gen, reference_port
from test_torch_models import dec_config, host, port_config, t
from test_torch_pipeline import CFG, GEN, PAD, ids, jax_params, port_pipeline

LOGITS_TOL = dict(atol=2e-4, rtol=2e-4)


def stub_tokenizer(texts):
    """bytes mod 120 (the text encoder's vocabulary) as token ids."""
    return {"input_ids": [[b % 120 for b in text.encode()] for text in texts]}


@pytest.fixture(scope="module")
def pair():
    return jax_params(CFG, seed=5)


def assert_same_ids(port_out, jax_out):
    np.testing.assert_array_equal(port_out.delayed_ids.numpy(), np.asarray(jax_out.delayed_ids))
    np.testing.assert_array_equal(port_out.lengths.numpy(), np.asarray(jax_out.lengths))
    assert port_out.steps == int(jax_out.steps)


def norm_rel(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


# ------------------------------------------------------------ text input
TEXTS = {
    "description": ["a calm voice, close to the microphone", "fast"],
    "prompt": ["Hello world.", "A longer sentence than the other one, past sixteen ids."],
}


@pytest.mark.parametrize("field,left_pad", [("description", False), ("prompt", True)])
def test_encode_text_matches_jax(pair, field, left_pad):
    jm, params, jdac, dac_params = pair
    jpipe = JPipeline(jm, params, jdac, dac_params, GEN, tokenizer=stub_tokenizer)
    pipe = port_pipeline(CFG, params, dac_params, GEN, tokenizer=stub_tokenizer)
    want_ids, want_mask = jpipe._encode_text(TEXTS[field], left_pad=left_pad)
    got_ids, got_mask = pipe._encode_text(TEXTS[field], left_pad=left_pad)
    np.testing.assert_array_equal(got_ids, want_ids)
    np.testing.assert_array_equal(got_mask, want_mask)
    assert got_ids.shape[1] % 16 == 0
    pad_side = got_mask[:, 0] if left_pad else got_mask[:, -1]
    assert (pad_side == 0).any()


def test_generate_text_equals_generate_on_its_ids(pair):
    _, params, _, dac_params = pair
    pipe = port_pipeline(CFG, params, dac_params, GEN, tokenizer=stub_tokenizer, frame_bucket=8)
    desc, desc_mask = pipe._encode_text(TEXTS["description"], left_pad=False)
    prompt, prompt_mask = pipe._encode_text(TEXTS["prompt"], left_pad=True)
    want = pipe.generate(desc, prompt, desc_mask=desc_mask, prompt_mask=prompt_mask)
    got = pipe.generate(TEXTS["description"], TEXTS["prompt"])
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    one = pipe.generate(TEXTS["description"][0], TEXTS["prompt"][0])  # a str is one row
    np.testing.assert_array_equal(
        one[0], pipe.generate(TEXTS["description"][:1], TEXTS["prompt"][:1])[0])


def test_text_without_a_tokenizer_raises(pair):
    _, params, _, dac_params = pair
    pipe = port_pipeline(CFG, params, dac_params, GEN)
    with pytest.raises(ValueError, match="no tokenizer"):
        pipe.generate(TEXTS["description"], TEXTS["prompt"])


# ------------------------------------------------- decoder logits, both sides
def decoder_logits(jax_kw, port_kw, params_of=lambda p: p, port_params_of=None,
                   dtype=torch.float32, seed=0):
    """Prefill through the bias path, then three decode steps through K1 of
    the JAX decoder (`JLM(**jax_kw)`) and the port's
    (`ParlerForCausalLM(**port_kw)`) on the same weights; row 0 left-padded.
    Returns (JAX logits, port logits), prefill and steps concatenated."""
    cfg = dec_config(4, rope=False)
    b, s_pre, n_steps, s_enc, s_max = 2, 5, 3, 6, 16
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, 62, (b, 3, s_pre + n_steps)).astype(np.int32)
    enc = rng.normal(size=(b, s_enc, 64)).astype(np.float32)
    enc_mask = np.ones((b, s_enc), np.int32)
    enc_mask[0, 4:] = 0
    kv_valid = np.ones((b, s_max), bool)
    kv_valid[0, :2] = False
    starts = np.array([2, 0], np.int32)
    init = host(JLM(cfg).init(jax.random.key(seed), jnp.zeros((b, s_pre, 64)),
                              jnp.broadcast_to(jnp.arange(s_pre), (b, s_pre)),
                              self_attn_bias=None,
                              encoder_hidden_states=jnp.asarray(enc))["params"])
    jparams = params_of(init)
    jdtype = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jm = JLM(cfg, dtype=jdtype, use_flash_decode=True, **jax_kw)
    port = ParlerForCausalLM(port_config(cfg), dtype=dtype, **port_kw)
    load_jax_params(port, (port_params_of or params_of)(init))

    def japply(*a, **kw):
        return jm.apply({"params": jparams}, *a, **kw)

    jcache = JCache.zeros(cfg, b, s_max, s_enc, jdtype, flat_self=True)
    ck, cv = japply(jnp.asarray(enc), method="precompute_cross_kv")
    jcache = jcache.replace(cross_k=ck, cross_v=cv)
    tcache = DecoderCache.zeros(port_config(cfg), b, s_max, s_enc, dtype)
    want, got = [], []
    with torch.inference_mode():
        tcache.cross_k, tcache.cross_v = port.precompute_cross_kv(t(enc))
        for lo, hi in [(0, s_pre)] + [(i, i + 1) for i in range(s_pre, s_pre + n_steps)]:
            flash = lo > 0
            pos = np.broadcast_to(np.arange(lo, hi), (b, hi - lo))
            emb = japply(jnp.asarray(tokens[:, :, lo:hi]), method="embed_ids")
            logits, jcache = japply(
                emb, jnp.asarray(pos),
                self_attn_bias=causal_self_attention_bias(jnp.asarray(pos),
                                                          jnp.asarray(kv_valid)),
                cross_attn_bias=padding_cross_attention_bias(jnp.asarray(enc_mask), hi - lo),
                cache=jcache,
                decode_lengths=(jnp.asarray(starts), jnp.int32(hi)) if flash else None)
            want.append(np.asarray(logits, np.float32))
            out = port(
                port.embed_ids(t(tokens[:, :, lo:hi]).long()), t(pos).long(),
                self_attn_bias=None if flash else tmasks.causal_self_attention_bias(
                    t(pos).long(), t(kv_valid)),
                cross_attn_bias=tmasks.padding_cross_attention_bias(t(enc_mask), hi - lo),
                cache=tcache, decode_lengths=(t(starts), hi) if flash else None)
            got.append(out.float().numpy())
    return np.concatenate(want, axis=2), np.concatenate(got, axis=2)


# ------------------------------------------------------------ fused_qkv
def test_fuse_qkv_params_matches_jax(pair):
    _, params, _, _ = pair
    want = jax_fuse_qkv(params)
    got = fuse_qkv_params(params)
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, got))[0]
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
    for (path, g), (_, w) in zip(flat_g, flat_w):
        np.testing.assert_array_equal(g, w, err_msg=jax.tree_util.keystr(path))
    layer = got["decoder"]["decoder"]["layers_0"]
    assert "qkv_proj" in layer["self_attn"] and "q_proj" in layer["encoder_attn"]


def test_fused_qkv_decoder_logits_match_jax():
    want, got = decoder_logits(dict(fused_qkv=True), dict(fused_qkv=True),
                               params_of=jax_fuse_qkv, port_params_of=fuse_qkv_params)
    np.testing.assert_allclose(got, want, **LOGITS_TOL)


@pytest.mark.parametrize("left_pad", [False, True])
def test_fused_qkv_greedy_generation_matches_jax(pair, left_pad):
    _, params, _, dac_params = pair
    desc, dm, prompt, pm = ids(seed=11, left_pad=left_pad)
    jm = JParler(CFG, use_flash_decode=True, fused_qkv=True)
    want = make_generate(jm, GEN, cache_dtype=jnp.float32)(
        jax_fuse_qkv(params), desc, dm, prompt, pm, jax.random.key(0))
    pipe = port_pipeline(CFG, params, dac_params, GEN, fused_qkv=True)
    attn = pipe.model.decoder.decoder.layers[0]
    assert hasattr(attn.self_attn, "qkv_proj") and not hasattr(attn.self_attn, "q_proj")
    assert hasattr(attn.encoder_attn, "q_proj") and not hasattr(attn.encoder_attn, "qkv_proj")
    assert_same_ids(pipe.generate_codes(desc, dm, prompt, pm), want)


def test_fused_qkv_leaves_the_callers_model_and_keeps_the_weights(pair):
    _, params, _, dac_params = pair
    model, dac = reference_port(params, dac_params)
    pipe = ParlerTTSPipeline(model, dac, port_gen(GEN), device="cpu", fused_qkv=True)
    assert pipe.model is not model and hasattr(model.decoder.decoder.layers[0].self_attn, "q_proj")
    fused = tensor_tree(pipe.model)
    want = fuse_qkv_params(tensor_tree(model))
    for (path, g), (_, w) in zip(jax.tree_util.tree_flatten_with_path(fused)[0],
                                 jax.tree_util.tree_flatten_with_path(want)[0]):
        assert torch.equal(g, w), jax.tree_util.keystr(path)


def test_fused_qkv_exclusions_raise(pair):
    _, params, _, dac_params = pair
    model, dac = reference_port(params, dac_params)
    with pytest.raises(ValueError, match="exclusive"):
        ParlerTTSPipeline(model, dac, device="cpu", fused_qkv=True, fused_decode=True)
    quant = ParlerTTSPipeline.from_random(port_config(CFG), device="cpu", weight_quant=True)
    with pytest.raises(ValueError, match="weight_quant"):
        ParlerTTSPipeline(quant.model, quant.dac, device="cpu", fused_qkv=True)


# ------------------------------------------------------ weight_quant="xla"
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_weight_quant_xla_decoder_logits_match_jax(dtype):
    quantize = lambda p: host(jax_quantize(p))  # noqa: E731
    want, got = decoder_logits(dict(weight_quant="xla"), dict(weight_quant="xla"),
                               params_of=quantize, dtype=dtype, seed=1)
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, **LOGITS_TOL)
        return
    want32, _ = decoder_logits(dict(weight_quant="xla"), dict(weight_quant="xla"),
                               params_of=quantize, seed=1)
    jax_gap = norm_rel(want, want32)
    assert jax_gap > 1e-3  # the bf16 model really runs in bf16
    assert norm_rel(got, want) <= 0.5 * jax_gap


@pytest.mark.parametrize("left_pad", [False, True])
def test_weight_quant_xla_greedy_generation_matches_jax(pair, left_pad):
    _, params, _, dac_params = pair
    desc, dm, prompt, pm = ids(seed=12, left_pad=left_pad)
    qparams = host(jax_quantize(params))
    jm = JParler(CFG, use_flash_decode=True, weight_quant="xla")
    want = make_generate(jm, GEN, cache_dtype=jnp.float32)(
        qparams, desc, dm, prompt, pm, jax.random.key(0))
    model = ParlerTTS(port_config(CFG), weight_quant="xla")
    load_jax_params(model, qparams)
    dac = DACModel(port_config(CFG.audio_encoder))
    load_jax_dac_params(dac, dac_params)
    fc1 = model.decoder.decoder.layers[0].fc1
    assert isinstance(fc1, QuantDense) and fc1.xla
    pipe = ParlerTTSPipeline(model, dac, port_gen(GEN), cache_dtype=torch.float32, device="cpu")
    assert_same_ids(pipe.generate_codes(desc, dm, prompt, pm), want)


# ------------------------------------------------------------ codec_dtype
def test_codec_dtype_bf16_matches_jax_cast_floating(pair):
    _, params, jdac, dac_params = pair
    codes = np.random.default_rng(3).integers(0, PAD, (2, 4, 16))
    want = np.asarray(jdac.apply({"params": cast_floating(dac_params, jnp.bfloat16)},
                                 jnp.asarray(codes), method="decode"))[:, :, 0]
    fp32 = np.asarray(jdac.apply({"params": dac_params}, jnp.asarray(codes),
                                 method="decode"))[:, :, 0]
    pipe = port_pipeline(CFG, params, dac_params, GEN, frame_bucket=8,
                         codec_dtype=torch.bfloat16)
    assert pipe.dac.decoder.conv_in.weight.dtype == torch.float32
    assert pipe.dac_decode.decoder.conv_in.weight.dtype == torch.bfloat16
    audio, lengths = pipe.decode_codes(torch.from_numpy(codes), torch.tensor([16, 11]))
    assert audio.dtype == np.float32
    np.testing.assert_array_equal(lengths, np.array([16, 11]) * CFG.audio_encoder.hop_length)
    np.testing.assert_allclose(audio, want, atol=1e-5, rtol=1e-4)
    assert np.abs(audio - fp32).max() > 1e-4  # the weights really are bf16-rounded


# ------------------------------------------------------- sliding window
@pytest.mark.parametrize("left_pad", [False, True])
def test_sliding_window_greedy_generation_matches_jax(left_pad):
    window = 6  # the span is 5 prompt slots + 24 columns
    cfg = dataclasses.replace(CFG, decoder=dataclasses.replace(CFG.decoder,
                                                               sliding_window=window))
    gen = dataclasses.replace(GEN, cache_implementation="sliding_window")
    jm, params, _, dac_params = jax_params(cfg, seed=6)
    desc, dm, prompt, pm = ids(seed=13, left_pad=left_pad)
    want = make_generate(jm, gen, cache_dtype=jnp.float32)(
        params, desc, dm, prompt, pm, jax.random.key(0))
    static = make_generate(jm, GEN, cache_dtype=jnp.float32)(
        params, desc, dm, prompt, pm, jax.random.key(0))
    assert not np.array_equal(np.asarray(want.delayed_ids), np.asarray(static.delayed_ids))
    pipe = port_pipeline(cfg, params, dac_params, gen)
    assert_same_ids(pipe.generate_codes(desc, dm, prompt, pm), want)


def window_logits(seed, window):
    """Decoder logits over a prefill of 5 and 4 one-column steps, every step
    through the dense bias path with `window` in the mask (the sliding-window
    route of both packages' generate loops) over a 16-slot flat cache: the
    JAX model in fp32 and in bf16, and the port in bf16."""
    dtype = torch.bfloat16
    cfg = dec_config(4, False)
    b, s_pre, n_steps, s_enc, s_max = 2, 5, 4, 6, 16
    rng = np.random.default_rng(seed)
    ids_ = rng.integers(0, 62, (b, 3, s_pre + n_steps)).astype(np.int32)
    enc = rng.normal(size=(b, s_enc, 64)).astype(np.float32)
    enc_mask = np.ones((b, s_enc), np.int32)
    enc_mask[0, 4:] = 0
    kv_valid = np.ones((b, s_max), bool)
    kv_valid[0, :2] = False  # a left-padded row
    spans = [(0, s_pre)] + [(i, i + 1) for i in range(s_pre, s_pre + n_steps)]
    params = host(JLM(cfg).init(
        jax.random.key(seed), jnp.zeros((b, s_pre, 64)),
        jnp.broadcast_to(jnp.arange(s_pre), (b, s_pre)), self_attn_bias=None,
        encoder_hidden_states=jnp.asarray(enc))["params"])
    out = {}
    for name, jdt in (("fp32", jnp.float32), ("bf16", jnp.bfloat16)):
        jm = JLM(cfg, dtype=jdt, use_flash_decode=True)
        cache = JCache.zeros(cfg, b, s_max, s_enc, jdt, flat_self=True)
        ck, cv = jm.apply({"params": params}, jnp.asarray(enc), method="precompute_cross_kv")
        cache = cache.replace(cross_k=ck, cross_v=cv)
        steps = []
        for lo, hi in spans:
            pos = jnp.broadcast_to(jnp.arange(lo, hi), (b, hi - lo))
            emb = jm.apply({"params": params}, jnp.asarray(ids_[:, :, lo:hi]), method="embed_ids")
            logits, cache = jm.apply(
                {"params": params}, emb, pos,
                self_attn_bias=causal_self_attention_bias(pos, jnp.asarray(kv_valid), window),
                cross_attn_bias=padding_cross_attention_bias(jnp.asarray(enc_mask), hi - lo),
                cache=cache)
            steps.append(np.asarray(logits, np.float32))
        out[name] = np.concatenate(steps, axis=2)
    port = ParlerForCausalLM(port_config(cfg), dtype=dtype)
    load_jax_params(port, params)
    cache = DecoderCache.zeros(port_config(cfg), b, s_max, s_enc, dtype)
    got = []
    with torch.inference_mode():
        cache.cross_k, cache.cross_v = port.precompute_cross_kv(torch.from_numpy(enc))
        for lo, hi in spans:
            pos = torch.arange(lo, hi)[None].expand(b, hi - lo)
            got.append(port(
                port.embed_ids(torch.from_numpy(ids_[:, :, lo:hi]).long()), pos,
                self_attn_bias=tmasks.causal_self_attention_bias(
                    pos, torch.from_numpy(kv_valid), window),
                cross_attn_bias=tmasks.padding_cross_attention_bias(
                    torch.from_numpy(enc_mask), hi - lo),
                cache=cache).float().numpy())
    return out, np.concatenate(got, axis=2)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bf16_sliding_window_logits_match_jax(seed):
    """ROADMAP queue 3, V1: a window of 3 slots (the span reaches 9)."""
    jax_logits, got = window_logits(seed, 3)
    norm_rel = lambda a, b: float(np.linalg.norm(a - b) / np.linalg.norm(b))  # noqa: E731
    jax_gap = norm_rel(jax_logits["bf16"], jax_logits["fp32"])
    assert jax_gap > 1e-3  # the bf16 model really runs in bf16
    gap = norm_rel(got, jax_logits["bf16"])
    print(f"bf16 window logits: port vs JAX {gap:.3e}, JAX bf16 vs fp32 {jax_gap:.3e}")
    assert gap <= 0.5 * jax_gap


def test_large_v1_decoder_config_matches_jax():
    from parler_tts_tpu.config import ParlerTTSConfig as JConfig
    from parler_tts_tpu.config import large_v1_decoder_config as jax_large_v1
    from parler_tts_tpu_torch import config as tc

    got = tc.large_v1_decoder_config()
    assert dataclasses.asdict(got) == dataclasses.asdict(jax_large_v1())
    assert (got.num_hidden_layers, got.hidden_size, got.num_attention_heads, got.ffn_dim) == (
        30, 1536, 24, 6144)
    composite = tc.ParlerTTSConfig(decoder=got)
    assert dataclasses.asdict(composite) == dataclasses.asdict(JConfig(decoder=jax_large_v1()))
    assert tc.large_v1_decoder_config(num_hidden_layers=2).num_hidden_layers == 2


def test_sliding_window_is_refused_by_the_fused_path_and_unknown_caches_raise(pair):
    _, params, _, dac_params = pair
    desc, dm, prompt, pm = ids(seed=14)
    fused = port_pipeline(CFG, params, dac_params,
                          dataclasses.replace(GEN, cache_implementation="sliding_window"),
                          fused_decode=True)
    with pytest.raises(ValueError, match="sliding_window"):
        fused.generate_codes(desc[:1], dm[:1], prompt[:1], pm[:1])
    pipe = port_pipeline(CFG, params, dac_params,
                         dataclasses.replace(GEN, cache_implementation="dynamic"))
    with pytest.raises(ValueError, match="cache_implementation"):
        pipe.generate_codes(desc, dm, prompt, pm)
