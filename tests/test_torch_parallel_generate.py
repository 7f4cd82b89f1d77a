"""Generation over a mesh of gloo ranks (`tests/torch_dist_worker.py`)
against the JAX package on the CPU, fp32, on the tiny config of
`tests/test_torch_pipeline.py` (4 heads: TP=2 and TP=4 divide).

  * greedy `make_generate(mesh=)` at TP=2 and TP=4 (B=1), DP=2 (B=2) and
    DP2 x TP2 (B=4): every rank returns the global delayed ids, equal to
    the rows of JAX's single-device `make_generate` over the same tree (one
    B=4 request, whose rows each case takes; a row's tokens do not depend
    on the others' under greedy decoding);
  * sampled DP=2: the single-process port run at the same seed, since every
    rank draws the global batch's noise and keeps its rows;
  * speculative decoding at TP=2 (window 4): B=1, and per-row at B=3,
    equal to JAX's AR loop with fewer forwards than columns, as
    `tests/test_sharded_generation.py` holds in JAX.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parler_tts_tpu.models.parler import ParlerTTS as JParler
from parler_tts_tpu.runtime.generate import make_generate as jax_generate
from parler_tts_tpu_torch import config as tc
from parler_tts_tpu_torch.convert import load_jax_params
from parler_tts_tpu_torch.models.parler import ParlerTTS
from parler_tts_tpu_torch.runtime.generate import make_generate
from test_torch_models import host, port_config
from test_torch_pipeline import CFG, GEN
from torch_dist_worker import launch

B = 4
TGEN = tc.GenerationConfig(**dataclasses.asdict(GEN))
SAMPLED = dataclasses.replace(TGEN, do_sample=True, temperature=0.8, top_k=20)


def request(b=B, seed=0):
    rng = np.random.default_rng(seed)
    desc = rng.integers(0, 120, size=(b, 9)).astype(np.int32)
    desc_mask = np.ones((b, 9), np.int32)
    desc_mask[1, 6:] = 0
    prompt = rng.integers(0, 256, size=(b, 5)).astype(np.int32)
    prompt_mask = np.ones((b, 5), np.int32)
    prompt_mask[0, :2] = 0
    prompt_mask[2, :1] = 0
    return desc, desc_mask, prompt, prompt_mask


def rows(req, b):
    return tuple(x[:b] for x in req)


CASES2 = [
    dict(name="tp2", mesh=(1, 2), b=1),
    dict(name="dp2", mesh=(2, 1), b=2),
    dict(name="dp2 sampled", mesh=(2, 1), b=2, gen=SAMPLED, seed=11),
    dict(name="tp2 speculative", mesh=(1, 2), b=1, window=4),
    dict(name="tp2 speculative per-row", mesh=(1, 2), b=3, window=4, per_row=True),
]
CASES4 = [
    dict(name="tp4", mesh=(1, 4), b=1),
    dict(name="dp2 x tp2", mesh=(2, 2), b=4),
]


def jax_model():
    """The JAX model (flash-decode, as `tests/test_torch_pipeline.py`'s) and
    its parameters from seed 0; no codec."""
    model = JParler(CFG, use_flash_decode=True)
    params = jax.jit(model.init)(
        jax.random.key(0), jnp.zeros((1, 4), jnp.int32), jnp.ones((1, 4), jnp.int32),
        jnp.zeros((1, 3), jnp.int32), jnp.ones((1, 3), jnp.int32),
        jnp.zeros((1, 2, CFG.decoder.num_codebooks), jnp.int32))["params"]
    return model, host(params)


@pytest.fixture(scope="module")
def runs():
    model, params = jax_model()
    req = request()
    want = np.asarray(jax_generate(model, GEN, cache_dtype=jnp.float32)(
        params, *req, jax.random.key(0)).delayed_ids)
    got = {}
    for world, cases in ((2, CASES2), (4, CASES4)):
        payload = {"cfg": port_config(CFG), "params": params, "cases": [
            dict(c, gen=c.get("gen", TGEN), inputs=rows(req, c["b"])) for c in cases]}
        for rank, res in enumerate(launch(world, "generate", payload)):
            for name, out in res.items():
                got.setdefault(name, []).append(out)
    return params, req, want, got


@pytest.mark.parametrize("case", [c for c in CASES2 + CASES4 if "seed" not in c],
                         ids=lambda c: c["name"])
def test_greedy_over_a_mesh_equals_jax(runs, case):
    _, _, want, got = runs
    outs = got[case["name"]]
    assert len(outs) == case["mesh"][0] * case["mesh"][1]
    for out in outs:  # every rank holds the global result
        np.testing.assert_array_equal(out["delayed"], want[:case["b"]])
        assert out["steps"] == GEN.max_length
    if case.get("window"):
        for out in outs:
            forwards, columns, _ = out["stats"]
            assert 0 < forwards < columns


def test_sampled_data_parallel_equals_one_process(runs):
    params, req, _, got = runs
    case = CASES2[2]
    model = ParlerTTS(port_config(CFG))
    load_jax_params(model, params)
    want = make_generate(model, SAMPLED, torch.float32)(
        *(torch.from_numpy(x) for x in rows(req, case["b"])),
        generator=torch.Generator().manual_seed(case["seed"])).delayed_ids.numpy()
    greedy = got["dp2"][0]["delayed"]
    assert not np.array_equal(want, greedy)  # the draw shows
    for out in got[case["name"]]:
        np.testing.assert_array_equal(out["delayed"], want)
