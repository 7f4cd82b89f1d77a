"""The train step over a mesh of gloo ranks (`tests/torch_dist_worker.py`)
against the JAX package's single-device `make_train_step` on the global
batch, on the CPU, fp32, on `tests/test_torch_training.py`'s tiny config at
dropout 0, over 3 steps (lr 1e-3, warmup 2, as the JAX package's own mesh
test `tests/test_training_step.py::test_sharded_train_step_matches_single_device`):
DP=2, TP=2, FSDP=2 and DP2 x TP2, and DP=2 with `microbatch_steps=2` and
`loss_chunk_size=5`. Each step's loss within rtol 2e-4, `grad_norm` within
rtol 2e-3, `num_items` exact, and every parameter after the third step
within 3e-5 of JAX's: the tolerances of that JAX test. Every rank reports
the global metrics and gathers the full parameters.

At dropout 0.1 (decoder, its MLP activation and the text encoder) a DP=2
step whose layers are rematerialised (the recompute in the backward draws
the masks again) and a TP=2 step are held to the single-process port step
at the same seed, to the same tolerances: each rank draws the masks of the
global batch and keeps its rows, and under TP its columns.

FSDP holds 1/2 of each large leaf at rest: the shapes the ranks report.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parler_tts_tpu.models.parler import ParlerTTS as JParler
from parler_tts_tpu.training import Batch as JBatch
from parler_tts_tpu.training import TrainState as JState
from parler_tts_tpu.training import make_optimizer as jax_optimizer
from parler_tts_tpu.training import make_train_step as jax_train_step
from parler_tts_tpu_torch.convert import to_jax_tree
from parler_tts_tpu_torch.parallel import fsdp_params_shardings
from parler_tts_tpu_torch.training import Batch, TrainState, make_optimizer, make_train_step
from test_torch_models import host, port_config
from test_torch_training import CFG, batch_np, flat, port_model
from torch_dist_worker import launch

OPT = dict(learning_rate=1e-3, warmup_steps=2)
BATCHES = [batch_np(seed=20 + i) for i in range(3)]
DROPOUT = dataclasses.replace(
    CFG, decoder=dataclasses.replace(CFG.decoder, dropout=0.1, activation_dropout=0.1),
    text_encoder=dataclasses.replace(CFG.text_encoder, dropout_rate=0.1))

CASES2 = [
    dict(name="dp2", mesh=(2, 1)),
    dict(name="tp2", mesh=(1, 2)),
    dict(name="fsdp2", mesh=(2, 1), fsdp=True),
    dict(name="dp2 microbatch 2 chunk 5", mesh=(2, 1), micro=2, chunk=5),
    dict(name="dp2 dropout", mesh=(2, 1), cfg=port_config(DROPOUT),
         model_kw=dict(remat_layers=True)),
    dict(name="tp2 dropout", mesh=(1, 2), cfg=port_config(DROPOUT)),
]
CASES4 = [dict(name="dp2 x tp2", mesh=(2, 2))]


def jax_init():
    """The JAX model and its parameters from seed 0 (a jitted init)."""
    model = JParler(CFG)
    params = jax.jit(model.init)(
        jax.random.key(0), jnp.zeros((1, 4), jnp.int32), jnp.ones((1, 4), jnp.int32),
        jnp.zeros((1, 3), jnp.int32), jnp.ones((1, 3), jnp.int32),
        jnp.zeros((1, 2, CFG.decoder.num_codebooks), jnp.int32))["params"]
    return model, params


def jax_steps(params):
    jm = JParler(CFG)
    tx = jax_optimizer(**OPT)
    state = JState.create(jax.tree.map(jnp.array, params), tx)
    step = jax_train_step(jm, tx)
    metrics = []
    for i, arrays in enumerate(BATCHES):
        state, m = step(state, JBatch(*map(jnp.asarray, arrays)), jax.random.key(i))
        metrics.append({k: np.asarray(v) for k, v in m.items()})
    return metrics, flat(host(state.params))


_DROPOUT_REFERENCE = {}


def dropout_reference(params):
    """The single-process port's 3 steps at dropout 0.1, computed once."""
    if not _DROPOUT_REFERENCE:
        _DROPOUT_REFERENCE["steps"] = port_steps(params, DROPOUT)
    return _DROPOUT_REFERENCE["steps"]


def port_steps(params, cfg, **kw):
    model = port_model(params, cfg, **kw)
    tx = make_optimizer(**OPT)
    state = TrainState.create(model, tx)
    step = make_train_step(model, tx)
    metrics = []
    for i, arrays in enumerate(BATCHES):
        state, m = step(state, Batch(*map(torch.from_numpy, arrays)), i)
        metrics.append({k: v.detach().numpy() for k, v in m.items()})
    return metrics, flat(to_jax_tree(model.named_parameters()))


@pytest.fixture(scope="module")
def runs():
    _, params = jax_init()
    params = host(params)
    got = {}
    for world, cases in ((2, CASES2), (4, CASES4)):
        payload = {"cfg": port_config(CFG), "params": params, "opt": OPT, "batches": BATCHES,
                   "cases": cases}
        for res in launch(world, "train", payload):
            for name, out in res.items():
                got.setdefault(name, []).append(out)
    return params, jax_steps(params), got


def assert_matches(outs, want_metrics, want_params):
    for out in outs:
        assert len(out["metrics"]) == len(want_metrics)
        for m, w in zip(out["metrics"], want_metrics):
            np.testing.assert_allclose(m["loss"], w["loss"], rtol=2e-4)
            np.testing.assert_allclose(m["grad_norm"], w["grad_norm"], rtol=2e-3)
            assert int(m["num_items"]) == int(w["num_items"])
        got = flat(out["params"])
        assert got.keys() == want_params.keys()
        for name, w in want_params.items():
            np.testing.assert_allclose(got[name], w, rtol=0, atol=3e-5, err_msg=name)


@pytest.mark.parametrize("case", [c for c in CASES2 + CASES4 if "cfg" not in c],
                         ids=lambda c: c["name"])
def test_train_steps_over_a_mesh_equal_jax(runs, case):
    _, (want_metrics, want_params), got = runs
    outs = got[case["name"]]
    assert len(outs) == case["mesh"][0] * case["mesh"][1]
    assert_matches(outs, want_metrics, want_params)
    assert any(float(m["grad_norm"]) > 0 for m in outs[0]["metrics"])


@pytest.mark.parametrize("name", ["dp2 dropout", "tp2 dropout"])
def test_dropout_steps_over_a_mesh_equal_one_process(runs, name):
    params, (_, plain_params), got = runs
    # one reference for both: remat recomputes the same values
    # (tests/test_torch_training.py::test_remat_equals_no_remat_with_dropout)
    want_metrics, want_params = dropout_reference(params)
    # dropout moves the parameters far past the tolerance off the dropout-free ones
    assert max(np.abs(want_params[n] - w).max() for n, w in plain_params.items()) > 1e-3
    assert_matches(got[name], want_metrics, want_params)


def test_fsdp_holds_shards_at_rest(runs):
    params, _, got = runs
    full = {n: tuple(p.shape) for n, p in port_model(params).named_parameters()}
    plan = fsdp_params_shardings(full, {"data": 2, "seq": 1, "model": 1})
    halved = 0
    for out in got["fsdp2"]:
        for n, shape in out["shapes"].items():
            want = tuple(s // 2 if axis == "data" else s for s, axis in zip(full[n], plan[n]))
            assert shape == want, n
            halved += shape != full[n]
    assert halved > 0
