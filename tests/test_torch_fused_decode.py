"""The fused B=1 decode step of the port (kernel K3) against the JAX package,
on the CPU: `prepare_fused_params` field by field, `fused_decode_layers_plain`
against the Pallas kernel in interpret mode at the Pallas kernel's tiling and
at the CUDA kernel's, the limits that hold the CUDA kernel to its plain
version, bounds given as () int32 tensors against the same bounds as ints
(bit for bit), and greedy generation through `generate_tokens_fused`
against `make_generate_fused`, with n_rows kept on the device.

Errors are norm-relative, ||got - want|| / ||want||, over the bf16 hidden
state and the new k and v rows: a bf16 rounding that moves by one step in a
few places reads as about 1e-3, while a dropped cache row or layer moves
every element.
  * Plain vs Pallas, block_s=64 at either tiling: at most 1.73e-3 measured;
    bound PALLAS_TOL = 2e-3.
  * The tiling gap, plain at block_s=64 against block_s=S: at most 1.35e-3
    measured; bound TILING_GAP = 1.4e-3. It is as large as what a dropped
    cache row does, so the CUDA kernel is held to its plain version at its
    own tiling (tiling="cuda", 32-row chunks), slice by slice, by
    `fused_close` within `fused_limits`, both set from the noise between the
    plain version summing in fp32 and in float64: at least 4 x K3_FLOOR =
    1.95e-3 (the noise reads 0 at this size).
  * Negative checks: dropping the first or the last cache row at n_rows 21,
    64 and 127 (1.4 to 7.4 x the limit at worst measured) or one layer's fc2
    (36 x) must fail those limits.

Greedy streams are compared token for token. Both packages round to bf16 at
the Pallas kernel's points, but from fp32 values summed in other orders (XLA
contracts a*b + c into one FMA and has its own exp, tanh and reductions), so
about one bf16 element in a thousand lands one step apart and the logits
move by ~1e-4. Where the port's greedy token differs from the JAX package's,
the port's logits of the two tokens must lie within TIE = 2e-4 (the
decoder-logit bound, COMPONENTS.md row 5); the JAX token is then forced into
the port's stream and the comparison goes on to the end. On the JAX
package's seed 0 this happens once, at column 7 of codebook 3 (logits
0.70981 and 0.70973); the other cases agree with nothing forced.
"""

import dataclasses
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parler_tts_tpu.models.decoder import ParlerForCausalLM as JLM
from parler_tts_tpu.models.parler import ParlerTTS as JParler
from parler_tts_tpu.ops.pallas.fused_decode_step import fused_decode_layers as pallas_fused
from parler_tts_tpu.ops.pallas.fused_decode_step import prepare_fused_params as jax_prepare
from parler_tts_tpu.runtime.generate import make_generate_fused
from parler_tts_tpu_torch import config as tc
from parler_tts_tpu_torch.convert import load_jax_params
from parler_tts_tpu_torch.models.decoder import ParlerForCausalLM
from parler_tts_tpu_torch.models.layers import init_weights
from parler_tts_tpu_torch.models.parler import ParlerTTS
from parler_tts_tpu_torch.ops.fused_decode_step import (
    CUDA_CHUNK,
    K3_FLOOR,
    K3_NOISE_FACTOR,
    fused_close,
    fused_decode_layers,
    fused_decode_layers_plain,
    fused_gaps,
    fused_limits,
    prepare_fused_params,
)
from parler_tts_tpu_torch.runtime import generate as tgen
from parler_tts_tpu_torch.runtime.generate import generate_tokens_fused
from parler_tts_tpu_torch.runtime.pipeline import ParlerTTSPipeline
from test_fused_decode_step import CFG as STEP_CFG
from test_fused_generate import CFG as GEN_CFG
from test_fused_generate import GEN
from test_torch_models import host, port_config
from test_torch_pipeline import CFG as PIPE_CFG
from test_torch_pipeline import ids

TIE = 2e-4
PALLAS_TOL = 2e-3
TILING_GAP = 1.4e-3
S_CACHE, S_ENC = 128, 16
CASES = [(start, n_rows) for start in (0, 3) for n_rows in (1, 21, 64, 65, 127)]


def rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def rel3(got, want):
    return max(rel(g.float().numpy(), w.float().numpy() if isinstance(w, torch.Tensor)
                   else np.asarray(w.astype(jnp.float32))) for g, w in zip(got, want))


@pytest.fixture(scope="module")
def step_setup():
    jm = JLM(STEP_CFG)

    def init_all(m):
        m.embed_ids(jnp.zeros((1, STEP_CFG.num_codebooks, 2), jnp.int32))
        return m(jnp.zeros((1, 2, STEP_CFG.hidden_size)), jnp.zeros((1, 2), jnp.int32),
                 self_attn_bias=None,
                 encoder_hidden_states=jnp.zeros((1, 4, STEP_CFG.hidden_size)))

    params = host(jm.init(jax.random.key(1), method=init_all)["params"])
    port = ParlerForCausalLM(port_config(STEP_CFG))
    load_jax_params(port, params)
    rng = np.random.default_rng(0)
    n_layers, d = STEP_CFG.num_hidden_layers, STEP_CFG.hidden_size
    arrays = dict(
        x=rng.normal(size=(1, d)), cache_k=rng.normal(size=(n_layers, S_CACHE, d)) * 0.5,
        cache_v=rng.normal(size=(n_layers, S_CACHE, d)) * 0.5,
        cross_k=rng.normal(size=(n_layers, S_ENC, d)) * 0.5,
        cross_v=rng.normal(size=(n_layers, S_ENC, d)) * 0.5,
    )
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    bias = np.zeros((1, S_ENC), np.float32)
    bias[0, 12:] = np.finfo(np.float32).min  # 4 masked encoder positions
    return params, port, arrays, bias


def port_args(port, arrays, bias, start, n_rows, fp=None):
    bf = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in arrays.items()}
    fp = fp if fp is not None else prepare_fused_params(port.decoder)
    return (port_config(STEP_CFG), fp, bf["x"], bf["cache_k"], bf["cache_v"], bf["cross_k"],
            bf["cross_v"], torch.from_numpy(bias), start, n_rows)


def test_prepare_fused_params_matches_jax(step_setup):
    params, port, _, _ = step_setup
    want = jax_prepare(params["decoder"], STEP_CFG)
    got = prepare_fused_params(port.decoder)
    transposed = {"w_attn", "wfc1", "wfc2"}  # stored output-major
    for name in got.__dataclass_fields__:
        value = getattr(got, name)
        if name in transposed:
            value = value.transpose(1, 2)
        ref = np.asarray(getattr(want, name))
        assert value.dtype == (torch.int8 if name in transposed else torch.float32), name
        np.testing.assert_array_equal(value.numpy(), ref, err_msg=name)
    # the JAX package's one-hot head matrices serve the TPU's layout only
    assert set(want._fields) - set(got.__dataclass_fields__) == {"head_sum", "head_expand"}


def pallas_step(params, arrays, bias, start, n_rows):
    bf = {k: jnp.asarray(v, jnp.bfloat16) for k, v in arrays.items()}
    return pallas_fused(STEP_CFG, jax_prepare(params["decoder"], STEP_CFG), bf["x"],
                        bf["cache_k"], bf["cache_v"], bf["cross_k"], bf["cross_v"],
                        jnp.asarray(bias), jnp.int32(start), jnp.int32(n_rows),
                        block_s=64, interpret=True)


@pytest.mark.parametrize("n_rows", [1, 21, 64, 65, 127])
@pytest.mark.parametrize("start", [0, 3])
def test_plain_matches_pallas(step_setup, start, n_rows):
    params, port, arrays, bias = step_setup
    want = pallas_step(params, arrays, bias, start, n_rows)
    args = port_args(port, arrays, bias, start, n_rows)
    got = fused_decode_layers_plain(*args, block_s=64)
    assert [tuple(g.shape) for g in got] == [(1, 256), (3, 1, 256), (3, 1, 256)]
    assert all(g.dtype == torch.bfloat16 for g in got)
    assert rel3(got, want) <= PALLAS_TOL
    # the CPU route of the wrapper is the plain version
    for g, w in zip(fused_decode_layers(*args), got):
        assert torch.equal(g, w)


@pytest.mark.parametrize("n_rows", [1, 21, 64, 65, 127])
@pytest.mark.parametrize("start", [0, 3])
def test_plain_at_the_cuda_tiling_matches_pallas(step_setup, start, n_rows):
    params, port, arrays, bias = step_setup
    want = pallas_step(params, arrays, bias, start, n_rows)
    got = fused_decode_layers_plain(*port_args(port, arrays, bias, start, n_rows),
                                    block_s=CUDA_CHUNK, tiling="cuda")
    assert all(g.dtype == torch.bfloat16 for g in got)
    assert rel3(got, want) <= PALLAS_TOL


def test_cuda_chunk_is_the_kernels():
    src = (Path(__file__).resolve().parent.parent / "parler_tts_tpu_torch" / "csrc"
           / "fused_decode_step.cu").read_text()
    assert int(re.search(r"constexpr int kChunk = (\d+);", src).group(1)) == CUDA_CHUNK


@pytest.mark.parametrize("start,n_rows", CASES + [(3, 4), (0, 32), (0, 33), (5, 4)])
def test_tensor_bounds_match_int_bounds(step_setup, start, n_rows):
    _, port, arrays, bias = step_setup
    args = port_args(port, arrays, bias, start, n_rows)
    i32 = lambda v: torch.tensor(v, dtype=torch.int32)  # noqa: E731
    for kw in ({}, dict(block_s=CUDA_CHUNK, tiling="cuda")):
        want = fused_decode_layers_plain(*args, **kw)
        for bounds in ((i32(start), i32(n_rows)), (start, i32(n_rows)), (i32(start), n_rows)):
            got = fused_decode_layers_plain(*args[:8], *bounds, **kw)
            assert all(torch.equal(g, w) for g, w in zip(got, want)), (kw, bounds)
    got = fused_decode_layers(*args[:8], i32(start), i32(n_rows))
    assert all(torch.equal(g, w) for g, w in zip(got, fused_decode_layers_plain(*args)))


def test_tensor_bounds_are_clamped_as_the_kernel_clamps(step_setup):
    _, port, arrays, bias = step_setup
    args = port_args(port, arrays, bias, 0, S_CACHE)
    i32 = lambda v: torch.tensor(v, dtype=torch.int32)  # noqa: E731
    want = fused_decode_layers_plain(*args)
    got = fused_decode_layers_plain(*args[:8], i32(-2), i32(S_CACHE + 5))
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    for bad in (torch.tensor(3), torch.tensor([3], dtype=torch.int32)):
        with pytest.raises(TypeError, match="int32"):
            fused_decode_layers(*args[:8], 0, bad)


def test_fused_gaps_and_limits():
    hidden, k = torch.ones(1, 8, dtype=torch.bfloat16), torch.ones(3, 1, 8, dtype=torch.bfloat16)
    out = (hidden, k, k)
    assert torch.equal(fused_gaps(out, out), torch.zeros(4))
    moved = k.clone()
    moved[1, 0, 0] = 2.0  # layer 1's k: norm 4 of 16 entries of 1, one moved by 1
    assert torch.allclose(fused_gaps((hidden, moved, k), out), torch.tensor([0, 0.25, 0, 0]))
    # every case: 4 x the largest noise at this slice or an earlier one; the
    # median at slice 1: 4 x the median noise there; both at least 4 x K3_FLOOR
    noise = torch.tensor([[0.0, 1e-2, 0.0, 0.0], [0.0, 0.0, 3e-2, 0.0], [0.0, 0.0, 0.0, 0.0]])
    per_case, median = fused_limits(noise)
    assert torch.allclose(per_case, K3_NOISE_FACTOR * torch.tensor([K3_FLOOR, 1e-2, 3e-2, 3e-2]))
    assert median == K3_NOISE_FACTOR * K3_FLOOR
    limits = (per_case, median)
    assert fused_close(torch.zeros(3, 4), limits)
    one_case_off = torch.zeros(3, 4)
    one_case_off[0, 1] = 5e-2  # beyond the limit of every case at slice 1
    assert not fused_close(one_case_off, limits)
    typical_off = torch.zeros(3, 4)
    typical_off[:2, 1] = 3e-3  # within every case's limit, not the median's
    assert (typical_off <= per_case).all() and not fused_close(typical_off, limits)
    with pytest.raises(ValueError, match="tiling"):
        fused_decode_layers_plain(*[None] * 10, tiling="xla")


def test_tiling_gap_and_negative_checks(step_setup):
    _, port, arrays, bias = step_setup
    fp = prepare_fused_params(port.decoder)
    gaps, want, noise = [], {}, []
    for start, n_rows in CASES:
        args = port_args(port, arrays, bias, start, n_rows, fp)
        gaps.append(rel3(fused_decode_layers_plain(*args, block_s=64),
                         fused_decode_layers_plain(*args, block_s=S_CACHE)))
        want[(start, n_rows)] = fused_decode_layers_plain(*args, block_s=CUDA_CHUNK,
                                                          tiling="cuda")
        plain64 = fused_decode_layers_plain(*args, block_s=CUDA_CHUNK, tiling="cuda",
                                            dtype=torch.float64)
        noise.append(fused_gaps(plain64, want[(start, n_rows)]))
    assert 0 < max(gaps) <= TILING_GAP, gaps
    limits = fused_limits(torch.stack(noise))
    assert torch.allclose(limits[0], torch.full((4,), K3_NOISE_FACTOR * K3_FLOOR))
    assert limits[1] == K3_NOISE_FACTOR * K3_FLOOR

    def fails(start, n_rows, params=fp, ref=(0, 21)):
        out = fused_decode_layers_plain(*port_args(port, arrays, bias, start, n_rows, params),
                                        block_s=CUDA_CHUNK, tiling="cuda")
        return not fused_close(fused_gaps(out, want[ref]), limits)

    for n_rows in (21, 64, 127):
        assert fails(1, n_rows, ref=(0, n_rows)), f"row 0 dropped at n_rows={n_rows}"
        assert fails(0, n_rows - 1, ref=(0, n_rows)), f"row {n_rows - 1} dropped"
    no_fc2 = dataclasses.replace(fp, sfc2=fp.sfc2.clone())
    no_fc2.sfc2[1] = 0.0
    assert fails(0, 21, no_fc2)


def test_fused_step_rejects_what_it_does_not_serve(step_setup):
    _, port, arrays, bias = step_setup
    args = port_args(port, arrays, bias, 0, 21)
    with pytest.raises(ValueError, match="n_rows"):
        fused_decode_layers(*args[:9], S_CACHE + 1)
    with pytest.raises(ValueError, match="x_emb"):
        fused_decode_layers(args[0], args[1], args[2][:, :128], *args[3:])
    gqa = port_config(dataclasses.replace(STEP_CFG, num_key_value_heads=2))
    with pytest.raises(ValueError, match="MHA"):
        prepare_fused_params(ParlerForCausalLM(gqa).decoder)
    rope = port_config(dataclasses.replace(STEP_CFG, rope_embeddings=True))
    with pytest.raises(ValueError, match="RoPE"):
        fused_decode_layers(rope, *args[1:])


# -------------------------------------------------------- fused generate
@pytest.fixture(scope="module")
def gen_setup():
    jm = JParler(GEN_CFG)
    params = jm.init(
        jax.random.key(1),
        jnp.zeros((1, 4), jnp.int32), jnp.ones((1, 4), jnp.int32),
        jnp.zeros((1, 3), jnp.int32), jnp.ones((1, 3), jnp.int32),
        jnp.zeros((1, 2, 4), jnp.int32),
    )["params"]
    port = ParlerTTS(port_config(GEN_CFG))
    load_jax_params(port, host(params))
    fn = make_generate_fused(jm, GEN, block_s=64, interpret=True)
    return fn, params, jax_prepare(params["decoder"]["decoder"], GEN_CFG.decoder), port


def fused_inputs(seed, left_pad=False):
    r = np.random.default_rng(seed)
    desc, prompt = r.integers(0, 120, size=(1, 9)), r.integers(0, 256, size=(1, 5))
    prompt_mask = np.ones((1, 5), np.int64)
    if left_pad:
        prompt_mask[0, :2] = 0
    return desc, np.ones((1, 9), np.int64), prompt, prompt_mask


@pytest.mark.parametrize("case", ["seed0", "seed3", "voice", "left_padded"])
def test_generate_tokens_fused_matches_jax(gen_setup, case, monkeypatch):
    fn, params, jfused, port = gen_setup
    seed = {"seed0": 0, "seed3": 3, "voice": 9, "left_padded": 5}[case]
    desc, dm, prompt, pm = fused_inputs(seed, left_pad=case == "left_padded")
    voice = None
    if case == "voice":
        voice = np.random.default_rng(1).integers(0, 88, size=(1, 4, 3))
    want = fn(params, jfused, jnp.asarray(desc), jnp.asarray(dm), jnp.asarray(prompt),
              jnp.asarray(pm), jax.random.key(0),
              None if voice is None else jnp.asarray(voice))
    want_ids = torch.from_numpy(np.array(want.delayed_ids)).long()
    tensors = [torch.from_numpy(x) for x in (desc, dm, prompt, pm)]
    forced = []
    sample = tgen._sample_column

    def follow_jax_at_ties(logits, t, *a, **kw):
        """The port's greedy column, with the JAX token forced wherever the
        two differ and the port's logits of the two lie within TIE."""
        col, state = sample(logits, t, *a, **kw)
        ref = want_ids[:, :, t]
        if torch.equal(col, ref):
            return col, state
        logits = logits.float().clone()
        for b, k in torch.nonzero(col != ref).tolist():
            mine, theirs = int(col[b, k]), int(ref[b, k])
            gap = float(logits[b, k, mine] - logits[b, k, theirs])
            assert gap <= TIE, f"column {t} codebook {k}: tokens {mine} vs {theirs}, gap {gap}"
            logits[b, k, theirs] = logits[b, k, mine] + 1.0
            forced.append((t, k, mine, theirs))
        return sample(logits, t, *a, **kw)

    monkeypatch.setattr(tgen, "_sample_column", follow_jax_at_ties)
    got = generate_tokens_fused(
        port, tc.GenerationConfig(**dataclasses.asdict(GEN)),
        prepare_fused_params(port.decoder.decoder), *tensors,
        decoder_prompt_codes=None if voice is None else torch.from_numpy(voice))
    np.testing.assert_array_equal(got.delayed_ids.numpy(), np.asarray(want.delayed_ids))
    np.testing.assert_array_equal(got.codes.numpy(), np.asarray(want.codes))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))
    assert got.steps == int(want.steps)
    assert [f[:2] for f in forced] == ([(7, 3)] if case == "seed0" else []), forced
    if voice is not None:
        np.testing.assert_array_equal(got.codes[:, :, :3].numpy(), voice)


def test_fused_step_keeps_its_bounds_on_the_device(gen_setup, monkeypatch):
    *_, port = gen_setup
    seen = []
    real = tgen.fused_decode_layers

    def spy(*args):
        start, n_rows = args[-2:]
        assert isinstance(start, torch.Tensor) and isinstance(n_rows, torch.Tensor)
        seen.append((int(start), int(n_rows)))
        return real(*args)

    monkeypatch.setattr(tgen, "fused_decode_layers", spy)
    desc, dm, prompt, pm = (torch.from_numpy(x) for x in fused_inputs(5, left_pad=True))
    out = generate_tokens_fused(port, tc.GenerationConfig(**dataclasses.asdict(GEN)),
                                prepare_fused_params(port.decoder.decoder), desc, dm, prompt, pm)
    s_p = 0 if GEN_CFG.prompt_cross_attention else prompt.shape[1]
    start = 0 if GEN_CFG.prompt_cross_attention else 2  # two left-padded prompt slots
    # one call per decode step, n_rows from the prefill's length (s_p + 1) up
    assert seen == [(start, s_p + 1 + i) for i in range(out.steps - 2)]


def test_generate_tokens_fused_needs_batch_one(gen_setup):
    *_, port = gen_setup
    desc, dm, prompt, pm = (torch.from_numpy(np.repeat(x, 2, axis=0))
                            for x in fused_inputs(0))
    with pytest.raises(ValueError, match="B=1"):
        generate_tokens_fused(port, tc.GenerationConfig(**dataclasses.asdict(GEN)),
                              prepare_fused_params(port.decoder.decoder), desc, dm, prompt, pm)


# -------------------------------------------------------- pipeline routing
def test_pipeline_fused_decode_routes_by_batch(monkeypatch):
    pcfg = port_config(PIPE_CFG)
    gen = tc.GenerationConfig(max_length=16, min_new_tokens=4, do_sample=False,
                              bos_token_id=89, pad_token_id=88, eos_token_id=88)
    plain = ParlerTTSPipeline.from_random(pcfg, seed=2, generation_config=gen, device="cpu")
    fused = ParlerTTSPipeline(plain.model, plain.dac, gen, device="cpu", fused_decode=True)
    calls = []
    real = tgen._fused_step

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(tgen, "_fused_step", spy)
    desc, dm, prompt, pm = ids(seed=3, b=2)
    a = plain.generate_codes(desc, dm, prompt, pm)
    b = fused.generate_codes(desc, dm, prompt, pm)
    assert not calls  # B=2: the eager loop, token for token the plain pipeline's
    assert torch.equal(a.delayed_ids, b.delayed_ids) and a.steps == b.steps
    out = fused.generate_codes(desc[:1], dm[:1], prompt[:1], pm[:1])
    assert calls == [1] and out.delayed_ids.shape[0] == 1


def test_fused_decode_with_weight_quant_raises():
    pcfg = port_config(PIPE_CFG)
    pipe = ParlerTTSPipeline.from_random(pcfg, seed=0, device="cpu", weight_quant=True)
    with pytest.raises(ValueError, match="exclusive"):
        ParlerTTSPipeline(pipe.model, pipe.dac, device="cpu", fused_decode=True)


def test_prepare_fused_params_needs_float_weights():
    model = ParlerTTS(port_config(PIPE_CFG), weight_quant=True)
    init_weights(model, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="float weights"):
        prepare_fused_params(model.decoder.decoder)
