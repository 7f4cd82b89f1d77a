"""The int8 serving side of the port against the JAX package, on the CPU:
quantization bit for bit, K2's plain version against the Pallas kernel in
interpret mode, decoder logits of a `weight_quant=True` model, and greedy
generation with int8 weights.

Tolerances: K2 plain vs Pallas, fp32 output atol/rtol 1e-5 (both sum exact
bf16 x int8 products in fp32, in other orders); bf16 output within one bf16
ulp of the Pallas value (the fp32 sums differ in the last bits, which can
move a bf16 rounding by one step). Decoder logits 2e-4 (the port's decoder
parity bound, COMPONENTS.md row 5). Greedy token streams identical.
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
from parler_tts_tpu.ops.pallas.quant_matmul import quant_matmul as pallas_quant_matmul
from parler_tts_tpu.runtime.generate import make_generate
from parler_tts_tpu.utils import quantize as jq
from parler_tts_tpu_torch import config as tc
from parler_tts_tpu_torch.codec.dac_model import DACModel
from parler_tts_tpu_torch.convert import load_jax_dac_params, load_jax_params
from parler_tts_tpu_torch.models.decoder import DecoderCache, ParlerForCausalLM, QuantDense
from parler_tts_tpu_torch.models.parler import ParlerTTS
from parler_tts_tpu_torch.ops import masks as tmasks
from parler_tts_tpu_torch.ops.quant_matmul import (
    MAX_SLICES,
    k2_close,
    k2_grid,
    quant_matmul,
    quant_matmul_plain,
)
from parler_tts_tpu_torch.runtime.pipeline import ParlerTTSPipeline
from parler_tts_tpu_torch.utils import quantize as tq
from test_torch_models import dec_config, host, port_config, t
from test_torch_pipeline import CFG, GEN, assert_same_generation, ids, jax_params


# ------------------------------------------------------------ quantize
def tie_kernel():
    """Column 0 has max 127, so its scale is exactly 1 and w / scale hits
    the .5 ties; round half to even sends 0.5 -> 0, 1.5 -> 2, 2.5 -> 2."""
    w = np.random.default_rng(0).normal(size=(8, 3)).astype(np.float32)
    w[:, 0] = [127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5]
    return w


@pytest.mark.parametrize("kind", ["ties", "normal", "zero_column"])
def test_quantize_kernel_is_bit_exact(kind):
    if kind == "ties":
        w = tie_kernel()
    else:
        w = (np.random.default_rng(1).normal(size=(64, 48)) * 0.05).astype(np.float32)
        if kind == "zero_column":
            w[:, 5] = 0.0  # scale floored at 1e-12
    want = jq.quantize_kernel(w)
    got = tq.quantize_kernel(w)
    w_q, scale = tq.quantize_kernel_torch(torch.from_numpy(w))
    for arrays in (got, {"w_q": w_q.numpy(), "scale": scale.numpy()}):
        assert arrays["w_q"].dtype == np.int8 and arrays["scale"].dtype == np.float32
        np.testing.assert_array_equal(arrays["w_q"], want["w_q"])
        np.testing.assert_array_equal(arrays["scale"].view(np.int32), want["scale"].view(np.int32))
    if kind == "ties":
        np.testing.assert_array_equal(w_q[:, 0].numpy(), [127, 0, 2, 2, 0, -2, -2, 126])


def test_quantize_decoder_params_is_bit_exact():
    _, params, _, _ = jax_params(CFG)
    want = host(jq.quantize_decoder_params(params))
    got = tq.quantize_decoder_params(params)
    flat_want = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_got = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert len(flat_want) == len(flat_got)
    n_quant = 0
    for path, leaf in flat_want:
        other = flat_got[path]
        assert other.dtype == leaf.dtype, path
        np.testing.assert_array_equal(other, leaf)
        n_quant += leaf.dtype == np.int8
    # 2 layers x (self q/k/v/out + cross q/k/v/out + fc1 + fc2); heads stay float
    assert n_quant == 2 * 10
    assert got["decoder"]["lm_heads"].dtype == np.float32


# ----------------------------------------------------------- K2 plain
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", [1, 2, 5, 18])
def test_quant_matmul_plain_matches_pallas(m, dtype):
    rng = np.random.default_rng(m)
    x = (rng.normal(size=(m, 512)) * 0.3).astype(np.float32)
    w_q = rng.integers(-127, 128, size=(512, 256)).astype(np.int8)
    scale = rng.uniform(0.001, 0.01, size=(256,)).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want = np.asarray(pallas_quant_matmul(jnp.asarray(x, jdt), jnp.asarray(w_q),
                                          jnp.asarray(scale), block_n=128, block_k=256,
                                          interpret=True).astype(jnp.float32))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = quant_matmul_plain(tx, t(w_q), t(scale))
    assert got.dtype == tx.dtype and got.shape == (m, 256)
    assert torch.equal(quant_matmul(tx, t(w_q), t(scale)), got)  # the CPU route
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    else:
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
        assert (np.abs(got - want) <= ulp).all()


def test_quant_matmul_rejects_what_the_kernel_does_not_take():
    x = torch.randn(2, 64)
    w = torch.randint(-127, 128, (64, 32), dtype=torch.int8)
    s = torch.rand(32)
    with pytest.raises(TypeError, match="int8"):
        quant_matmul(x, w.float(), s)
    with pytest.raises(ValueError, match="rows"):
        quant_matmul(torch.randn(2, 48), w, s)
    with pytest.raises(ValueError, match="scale"):
        quant_matmul(x, w, s.double())
    with pytest.raises(ValueError, match="scale"):
        quant_matmul(x, w, torch.rand(16))
    with pytest.raises(TypeError, match="dtype"):
        quant_matmul(x.half(), w, s)
    with pytest.raises(ValueError, match="multiples of 16"):
        quant_matmul(torch.randn(2, 40), torch.zeros(40, 32, dtype=torch.int8), s)
    with pytest.raises(ValueError, match="contiguous"):
        quant_matmul(x, torch.zeros(32, 64, dtype=torch.int8).t(), s)
    with pytest.raises(ValueError, match=r"\(M, K\)"):
        quant_matmul(x[None], w, s)


@pytest.mark.parametrize("m,k,n,want", [
    (2, 1024, 1024, (8, 128)), (2, 1024, 4096, (2, 512)), (2, 4096, 1024, (8, 512)),
    (1, 1024, 1024, (8, 128)), (18, 1024, 1024, (2, 512)), (32, 1024, 1024, (2, 512)),
    (2, 1024, 1040, (4, 256)), (2, 64, 32, (1, 64)), (5, 512, 256, (8, 64)),
    (32, 4096, 4096, (1, 4096)),
])
def test_k2_grid_fills_the_card_in_one_cluster(m, k, n, want):
    """The slices of a 64-column strip are one cluster (a power of two up to
    8): about one block per SM (mini-v1's 1024 x 1024 at M=2: 16 strips x 8
    slices of 128 rows), every slice a multiple of 16 rows, K covered."""
    slices, slice_ = k2_grid(m, k, n)
    assert (slices, slice_) == want
    assert slices & (slices - 1) == 0 and 1 <= slices <= MAX_SLICES
    assert slice_ % 16 == 0 and slices * slice_ >= k > (slices - 1) * slice_ - slice_


@pytest.mark.parametrize("m,k,n", [(2, 1024, 1024), (2, 4096, 1024), (18, 1024, 4096),
                                   (2, 1024, 1040)])
def test_a_dropped_k_slice_fails_k2_close(m, k, n):
    """`k2_close`, the kernel's check, sees one slice of the cluster left
    out: the plain version with that slice's rows of x zeroed."""
    g = torch.Generator().manual_seed(m + k + n)
    x = torch.randn(m, k, generator=g) * 0.3
    w = torch.randint(-127, 128, (k, n), generator=g, dtype=torch.int8)
    s = torch.rand(n, generator=g) * 0.009 + 1e-3
    want = quant_matmul_plain(x, w, s)
    assert k2_close(want, want)
    slices, slice_ = k2_grid(m, k, n)
    for rank in (0, slices - 1):
        dropped = x.clone()
        dropped[:, rank * slice_:(rank + 1) * slice_] = 0.0
        assert not k2_close(quant_matmul_plain(dropped, w, s), want)


def test_weight_quant_xla_is_not_ported():
    """weight_quant="xla" builds int8 QuantDense layers on the plain-matmul
    route (tests/test_torch_serving_modes.py holds it against the JAX
    package); a value other than False, True or "xla" still raises."""
    model = ParlerTTS(port_config(CFG), weight_quant="xla")
    fc1 = model.decoder.decoder.layers[0].fc1
    assert isinstance(fc1, QuantDense) and fc1.xla and fc1.w_q.dtype == torch.int8
    with pytest.raises(ValueError, match="weight_quant"):
        ParlerTTS(port_config(CFG), weight_quant="int4")


def test_from_random_weight_quant_holds_the_quantized_float_weights():
    """From one seed, the int8 model's weights are the quantization of the
    float model's: QuantDense draws what Dense draws, then quantizes."""
    pcfg = port_config(CFG)
    a = ParlerTTSPipeline.from_random(pcfg, seed=4, device="cpu")
    b = ParlerTTSPipeline.from_random(pcfg, seed=4, device="cpu", weight_quant=True)
    dense, quant = a.model.decoder.decoder.layers[1].fc1, b.model.decoder.decoder.layers[1].fc1
    assert isinstance(quant, QuantDense)
    w_q, scale = tq.quantize_kernel_torch(dense.kernel)
    assert torch.equal(quant.w_q, w_q) and torch.equal(quant.scale, scale)
    assert torch.equal(a.model.decoder.lm_heads, b.model.decoder.lm_heads)


# -------------------------------------------------------- int8 decoder
@pytest.mark.parametrize("n_kv", [4, 1], ids=["mha", "mqa"])
def test_weight_quant_decoder_logits_match_jax(n_kv):
    """Prefill, then decode steps through K1, with every projection over K2
    (the JAX model runs its Pallas K2 and K1 in interpret mode)."""
    cfg = dec_config(n_kv, rope=False)
    b, s_pre, n_steps, s_enc, s_max = 2, 5, 3, 6, 16
    rng = np.random.default_rng(n_kv)
    tokens = rng.integers(0, 62, (b, 3, s_pre + n_steps)).astype(np.int32)
    enc = rng.normal(size=(b, s_enc, 64)).astype(np.float32)
    enc_mask = np.ones((b, s_enc), np.int32)
    enc_mask[0, 4:] = 0
    kv_valid = np.ones((b, s_max), bool)
    kv_valid[0, :2] = False
    starts = np.array([2, 0], np.int32)

    init = JLM(cfg).init(jax.random.key(5), jnp.zeros((b, s_pre, 64)),
                         jnp.broadcast_to(jnp.arange(s_pre), (b, s_pre)),
                         self_attn_bias=None, encoder_hidden_states=jnp.asarray(enc))
    qparams = host(jq.quantize_decoder_params(init["params"]))
    jm = JLM(cfg, use_flash_decode=True, weight_quant=True)
    port = ParlerForCausalLM(port_config(cfg), weight_quant=True)
    load_jax_params(port, qparams)
    assert port.decoder.layers[0].fc2.w_q.dtype == torch.int8

    def japply(*a, **kw):
        return jm.apply({"params": qparams}, *a, **kw)

    jcache = JCache.zeros(cfg, b, s_max, s_enc, jnp.float32, flat_self=True)
    ck, cv = japply(jnp.asarray(enc), method="precompute_cross_kv")
    jcache = jcache.replace(cross_k=ck, cross_v=cv)
    tcache = DecoderCache.zeros(port_config(cfg), b, s_max, s_enc, torch.float32)
    with torch.no_grad():
        tcache.cross_k, tcache.cross_v = port.precompute_cross_kv(t(enc))
    np.testing.assert_allclose(tcache.cross_k.numpy(), np.asarray(ck), atol=1e-5, rtol=1e-5)

    for lo, hi in [(0, s_pre)] + [(i, i + 1) for i in range(s_pre, s_pre + n_steps)]:
        flash = lo > 0
        pos = np.broadcast_to(np.arange(lo, hi), (b, hi - lo))
        emb = japply(jnp.asarray(tokens[:, :, lo:hi]), method="embed_ids")
        want, jcache = japply(
            emb, jnp.asarray(pos),
            self_attn_bias=causal_self_attention_bias(jnp.asarray(pos), jnp.asarray(kv_valid)),
            cross_attn_bias=padding_cross_attention_bias(jnp.asarray(enc_mask), hi - lo),
            cache=jcache, decode_lengths=(jnp.asarray(starts), jnp.int32(hi)) if flash else None)
        with torch.no_grad():
            got = port(
                port.embed_ids(t(tokens[:, :, lo:hi]).long()), t(pos).long(),
                self_attn_bias=None if flash else tmasks.causal_self_attention_bias(
                    t(pos).long(), t(kv_valid)),
                cross_attn_bias=tmasks.padding_cross_attention_bias(t(enc_mask), hi - lo),
                cache=tcache, decode_lengths=(t(starts), hi) if flash else None)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=2e-4)


def test_convert_checks_leaf_dtypes():
    cfg = dec_config(4, rope=False)
    init = JLM(cfg).init(jax.random.key(0), jnp.zeros((1, 2, 64)), jnp.zeros((1, 2), jnp.int32),
                         self_attn_bias=None, encoder_hidden_states=jnp.zeros((1, 3, 64)))
    qparams = host(jq.quantize_decoder_params(init["params"]))
    bad = jax.tree.map(np.copy, qparams)
    leaf = bad["decoder"]["layers_0"]["fc1"]
    leaf["w_q"] = leaf["w_q"].astype(np.float32)
    with pytest.raises(TypeError, match="w_q"):
        load_jax_params(ParlerForCausalLM(port_config(cfg), weight_quant=True), bad)
    with pytest.raises(KeyError):  # a float tree has no w_q / scale leaves
        load_jax_params(ParlerForCausalLM(port_config(cfg), weight_quant=True),
                        host(init["params"]))


# ------------------------------------------------------- int8 generate
@pytest.fixture(scope="module")
def quant_pair():
    _, params, _, dac_params = jax_params(CFG)
    return host(jq.quantize_decoder_params(params)), dac_params


def quant_port_pipeline(cfg, qparams, dac_params, gen):
    pcfg = port_config(cfg)
    model = ParlerTTS(pcfg, weight_quant=True)
    load_jax_params(model, qparams)
    dac = DACModel(pcfg.audio_encoder)
    load_jax_dac_params(dac, dac_params)
    return ParlerTTSPipeline(model, dac, tc.GenerationConfig(**dataclasses.asdict(gen)),
                             cache_dtype=torch.float32, device="cpu")


@pytest.mark.parametrize("mode", ["prefix", "prefix_left_padded", "prompt_cross_attention"])
def test_weight_quant_greedy_generation_matches_jax(quant_pair, mode):
    cfg = CFG
    qparams, dac_params = quant_pair
    if mode == "prompt_cross_attention":
        cfg = dataclasses.replace(CFG, prompt_cross_attention=True)
        _, params, _, dac_params = jax_params(cfg, seed=1)
        qparams = host(jq.quantize_decoder_params(params))
    desc, dm, prompt, pm = ids(seed=7, left_pad=mode == "prefix_left_padded")
    jm = JParler(cfg, use_flash_decode=True, weight_quant=True)
    want = make_generate(jm, GEN, cache_dtype=jnp.float32)(
        qparams, desc, dm, prompt, pm, jax.random.key(0))
    pipe = quant_port_pipeline(cfg, qparams, dac_params, GEN)
    assert_same_generation(pipe.generate_codes(desc, dm, prompt, pm), want)
