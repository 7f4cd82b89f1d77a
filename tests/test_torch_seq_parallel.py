"""Sequence parallelism (the mesh's `seq` axis) over gloo ranks
(`tests/torch_dist_worker.py`) against the JAX package, on the CPU, fp32.

Train steps, on `tests/test_torch_training.py`'s tiny config (that of
`tests/test_training_step.py` at dropout 0) over 3 steps (lr 1e-3, warmup
2): each rank is fed its `data` share of the rows and its `seq` share of the
label columns, and every case is held to the JAX package's own
sequence-parallel step, `make_train_step(mesh=make_mesh(n_data=2, n_seq=2,
n_model=2))` on the session's 8 virtual CPU devices, at that JAX test's
tolerances (`tests/test_training_step.py::test_sequence_parallel_train_step_matches_single_device`):
each step's loss within rtol 2e-4 and `grad_norm` within rtol 2e-3,
`num_items` exact, every parameter after the third step within 2 x lr x
steps. The cases: seq=2 on each of the three attention routes (dense bias,
the chunked scan with 4-row chunks, K4's plain version), data=2 x seq=2,
seq=2 x model=2, 2 x 2 x 2, and `microbatch_steps=2` and FSDP once each.

At dropout 0.1 (decoder, its MLP activation and the text encoder), and at
seq=2 with LayerDrop 0.5 and with `prompt_cross_attention` (no prompt rows
on the decoder side) besides, the same meshes are held to the
single-process port step at the same seed, at the
tolerances of `tests/test_torch_parallel_train.py` (parameters within
3e-5): a rank draws the masks of the global batch and sequence and keeps
its rows and time rows, and remat's recompute draws them again.

The shift across a rank boundary: seq rank 1's first decoder input column
is rank 0's last label column, and changing that column alone changes rank
1's loss. A label length the axis does not divide is refused, as JAX
refuses it.

Generation over a mesh with a `seq` axis: ranks that differ only in `seq`
run the same rows, and the greedy tokens equal JAX's `make_generate(mesh=)`
and `make_generate_speculative(mesh=)` over meshes with a seq axis.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from parler_tts_tpu.models.parler import ParlerTTS as JParler
from parler_tts_tpu.parallel import make_mesh as jax_mesh
from parler_tts_tpu.parallel import shard_params as jax_shard_params
from parler_tts_tpu.runtime.generate import make_generate as jax_generate
from parler_tts_tpu.runtime.speculative import make_generate_speculative as jax_speculative
from parler_tts_tpu.training import Batch as JBatch
from parler_tts_tpu.training import TrainState as JState
from parler_tts_tpu.training import make_optimizer as jax_optimizer
from parler_tts_tpu.training import make_train_step as jax_train_step
from parler_tts_tpu.training import shard_train_state as jax_shard_train_state
from parler_tts_tpu_torch.parallel import local_seq_slice
from parler_tts_tpu_torch.parallel.collectives import Shard
from test_torch_models import host, port_config
from test_torch_parallel_generate import TGEN, jax_model, request, rows
from test_torch_parallel_train import BATCHES, DROPOUT, OPT, jax_init, port_steps
from test_torch_pipeline import CFG as GEN_CFG
from test_torch_pipeline import GEN
from test_torch_training import CFG, flat
from torch_dist_worker import launch

LR, STEPS = OPT["learning_rate"], len(BATCHES)
DROP = port_config(DROPOUT)
# LayerDrop at 0.5: each step drops some layers, drawn alike on every seq rank
LAYERDROP = dataclasses.replace(DROPOUT, decoder=dataclasses.replace(DROPOUT.decoder,
                                                                      layerdrop=0.5))
# the prompt in the cross-attention's keys: every seq rank holds frames only
PROMPT_CROSS = dataclasses.replace(DROPOUT, prompt_cross_attention=True)

# (n_data, n_model, n_seq), as `make_mesh` takes them
CASES = {
    2: [dict(name="sp2 dense", mesh=(1, 1, 2)),
        dict(name="sp2 chunked", mesh=(1, 1, 2), model_kw=dict(use_chunked_attention=4)),
        dict(name="sp2 pallas", mesh=(1, 1, 2), model_kw=dict(use_chunked_attention="pallas")),
        dict(name="sp2 microbatch 2 chunk 5", mesh=(1, 1, 2), micro=2, chunk=5),
        dict(name="sp2 dropout", mesh=(1, 1, 2), cfg=DROP,
             model_kw=dict(use_chunked_attention="pallas", remat_layers=True)),
        dict(name="sp2 layerdrop", mesh=(1, 1, 2), cfg=port_config(LAYERDROP),
             model_kw=dict(remat_layers=True)),
        dict(name="sp2 prompt cross-attention", mesh=(1, 1, 2), cfg=port_config(PROMPT_CROSS),
             model_kw=dict(use_chunked_attention="pallas"))],
    4: [dict(name="dp2 x sp2", mesh=(2, 1, 2), model_kw=dict(use_chunked_attention="pallas")),
        dict(name="sp2 x tp2", mesh=(1, 2, 2), model_kw=dict(use_chunked_attention=4)),
        dict(name="dp2 x sp2 fsdp", mesh=(2, 1, 2), fsdp=True),
        dict(name="dp2 x sp2 dropout", mesh=(2, 1, 2), cfg=DROP,
             model_kw=dict(use_chunked_attention=4, remat_layers=True)),
        dict(name="sp2 x tp2 dropout", mesh=(1, 2, 2), cfg=DROP)],
    8: [dict(name="dp2 x sp2 x tp2", mesh=(2, 2, 2), model_kw=dict(use_chunked_attention="pallas")),
        dict(name="dp2 x sp2 x tp2 dropout", mesh=(2, 2, 2), cfg=DROP,
             model_kw=dict(use_chunked_attention="pallas", remat_layers=True))],
}
# generation over meshes with a seq axis, in the world-4 launch: (port mesh, B,
# window, the JAX mesh (n_data, n_seq, n_model))
GEN_CASES = [dict(name="gen dp2 x sp2", mesh=(2, 1, 2), b=2, jax=(2, 2, 1)),
             dict(name="gen sp2 x tp2 speculative", mesh=(1, 2, 2), b=1, window=4,
                  jax=(1, 2, 2))]


def jax_seq_steps(params):
    """JAX's sequence-parallel step on the 2 x 2 x 2 CPU mesh, 3 steps."""
    jm = JParler(CFG)
    tx = jax_optimizer(**OPT)
    mesh = jax_mesh(n_data=2, n_seq=2, n_model=2)
    state = jax_shard_train_state(JState.create(jax.tree.map(jnp.array, params), tx), mesh)
    step = jax_train_step(jm, tx, mesh=mesh)
    metrics = []
    for i, arrays in enumerate(BATCHES):
        state, m = step(state, JBatch(*map(jnp.asarray, arrays)), jax.random.key(i))
        metrics.append({k: np.asarray(v) for k, v in m.items()})
    return metrics, flat(host(state.params))


def jax_seq_generation(req):
    """JAX's greedy tokens over each generation case's mesh with a seq axis."""
    model, params = jax_model()
    want = {}
    for case in GEN_CASES:
        n_data, n_seq, n_model = case["jax"]
        mesh = jax_mesh(n_data=n_data, n_seq=n_seq, n_model=n_model,
                        devices=jax.devices()[:n_data * n_seq * n_model])
        inputs = rows(req, case["b"])
        if case.get("window"):
            fn = jax_speculative(model, GEN, window=case["window"], cache_dtype=jnp.float32,
                                 mesh=mesh)
            out = fn(jax_shard_params(params, mesh), *inputs, jax.random.key(0))[0]
        else:
            out = jax_generate(model, GEN, cache_dtype=jnp.float32, mesh=mesh)(
                jax_shard_params(params, mesh), *inputs, jax.random.key(0))
        want[case["name"]] = np.asarray(out.delayed_ids)
    return params, want


def boundary_batches():
    """BATCHES[0] and a copy whose label column T/2 - 1 (seq rank 0's last)
    differs in every row and codebook."""
    arrays = list(BATCHES[0])
    labels = arrays[-1].copy()
    col = labels.shape[1] // 2 - 1
    labels[:, col] = (np.maximum(labels[:, col], 0) + 7) % 80
    return [BATCHES[0], tuple(arrays[:-1]) + (labels,)]


@pytest.fixture(scope="module")
def runs():
    _, params = jax_init()
    params = host(params)
    gen_params, gen_want = jax_seq_generation(request())
    base = {"cfg": port_config(CFG), "params": params, "opt": OPT, "batches": BATCHES}
    got = {}
    for world, cases in CASES.items():
        tasks = [("train", dict(base, cases=cases))]
        if world == 2:
            tasks.append(("seq_shift", dict(base, world=2, batches=boundary_batches())))
        if world == 4:
            tasks.append(("generate", {"cfg": port_config(GEN_CFG), "params": gen_params,
                                       "cases": [dict(c, gen=TGEN, inputs=rows(request(), c["b"]))
                                                 for c in GEN_CASES]}))
        for res in launch(world, "many", {"tasks": tasks}):
            for name, out in res.items():
                got.setdefault(name, []).append(out)
    return params, jax_seq_steps(params), got, gen_want


def assert_steps(outs, want_metrics, want_params, atol):
    for out in outs:
        assert len(out["metrics"]) == len(want_metrics)
        for m, w in zip(out["metrics"], want_metrics):
            np.testing.assert_allclose(m["loss"], w["loss"], rtol=2e-4)
            np.testing.assert_allclose(m["grad_norm"], w["grad_norm"], rtol=2e-3)
            assert int(m["num_items"]) == int(w["num_items"])
        got = flat(out["params"])
        assert got.keys() == want_params.keys()
        for name, w in want_params.items():
            np.testing.assert_allclose(got[name], w, rtol=0, atol=atol, err_msg=name)


def ranks(mesh):
    return mesh[0] * mesh[1] * mesh[2]


@pytest.mark.parametrize("case", [c for cs in CASES.values() for c in cs if "cfg" not in c],
                         ids=lambda c: c["name"])
def test_seq_parallel_steps_equal_jax(runs, case):
    _, (want_metrics, want_params), got, _ = runs
    outs = got[case["name"]]
    assert len(outs) == ranks(case["mesh"])
    assert_steps(outs, want_metrics, want_params, atol=2 * LR * STEPS)
    assert any(float(m["grad_norm"]) > 0 for m in outs[0]["metrics"])


@pytest.fixture(scope="module")
def one_process(runs):
    """The single-process port's 3 steps at dropout 0.1 (also with LayerDrop,
    and with the prompt in the cross-attention), and its parameters after 3
    steps at dropout 0."""
    params = runs[0]
    return ({port_config(c): port_steps(params, c) for c in (DROPOUT, LAYERDROP, PROMPT_CROSS)},
            port_steps(params, CFG)[1])


@pytest.mark.parametrize("case", [c for cs in CASES.values() for c in cs if "cfg" in c],
                         ids=lambda c: c["name"])
def test_seq_parallel_dropout_steps_equal_one_process(runs, one_process, case):
    got = runs[2]
    steps, plain_params = one_process
    want_metrics, want_params = steps[case["cfg"]]
    # dropout moves the parameters far past the tolerance off the dropout-free ones
    assert max(np.abs(want_params[n] - w).max() for n, w in plain_params.items()) > 1e-3
    assert len(got[case["name"]]) == ranks(case["mesh"])
    assert_steps(got[case["name"]], want_metrics, want_params, atol=3e-5)


def test_the_shift_crosses_the_rank_boundary(runs):
    """Seq rank 1's first decoder input column is rank 0's last label
    column (rank 0's is the start token); changing that column alone, which
    rank 1's labels do not hold, changes rank 1's own loss."""
    *_, got, _ = runs
    (r0, r1), batches = got["seq shift"], boundary_batches()
    half = batches[0][-1].shape[1] // 2
    for i, labels in enumerate(b[-1] for b in batches):
        np.testing.assert_array_equal(r1[i]["dec_ids"][:, :, 0],
                                      np.where(labels[:, half - 1] == -100, CFG.pad_token_id,
                                               labels[:, half - 1]))
        np.testing.assert_array_equal(r0[i]["dec_ids"][:, :, 0],
                                      np.full_like(r0[i]["dec_ids"][:, :, 0],
                                                   CFG.decoder_start_token_id))
    np.testing.assert_array_equal(batches[0][-1][:, half:], batches[1][-1][:, half:])
    assert r1[0]["loss"] != r1[1]["loss"]
    assert r1[0]["items"] == r1[1]["items"] > 0


@pytest.mark.parametrize("case", GEN_CASES, ids=lambda c: c["name"])
def test_generation_over_a_seq_axis_equals_jax(runs, case):
    *_, got, want = runs
    outs = got[case["name"]]
    assert len(outs) == ranks(case["mesh"])
    for out in outs:  # every rank, seq ranks included, holds the global result
        np.testing.assert_array_equal(out["delayed"], want[case["name"]])
        assert out["steps"] == GEN.max_length
        if case.get("window"):
            forwards, columns, _ = out["stats"]
            assert 0 < forwards < columns


@pytest.mark.parametrize("length,n_seq,ok", [(12, 2, True), (13, 2, False), (12, 4, True),
                                             (10, 4, False)])
def test_a_label_length_the_seq_axis_does_not_divide_is_refused(length, n_seq, ok):
    """As JAX's `P("data", "seq")` input sharding refuses it ("should be
    divisible by 2, but it is equal to 13"); the shares are contiguous and
    cover the sequence in rank order."""
    shares = []
    for r in range(n_seq):
        mesh = type("M", (), {"seq": Shard(None, n_seq, r)})()
        if not ok:
            with pytest.raises(ValueError, match=f"{length} label columns not divisible"):
                local_seq_slice(length, mesh)
            return
        shares.append(local_seq_slice(length, mesh))
    assert [s.start for s in shares] == list(range(0, length, length // n_seq))
    assert shares[-1].stop == length

