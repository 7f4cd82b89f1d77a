"""The port's training slice against the JAX package, fp32 on the CPU, on the
tiny config of `tests/test_training_step.py` with dropout 0 (the JAX train
step always runs `deterministic=False`, and threefry and Philox cannot give
the same masks): the training-path masks and label shift (exact), the
losses (1e-5), teacher-forced logits through the three attention routes
(2e-4, COMPONENTS.md row 5), and `make_train_step` (loss, every gradient
leaf and `grad_norm` with the frozen text encoder's gradients in it, params
after two steps). The rest holds the port to itself: the frozen encoder,
micro-batching, remat with dropout on, dropout and LayerDrop by their
statistics.

Gradients: each leaf within 1e-4 of the JAX leaf's norm
(||g_port - g_jax|| / ||g_jax||). Params after two steps at lr 1e-3 (with
warmup 1, step 1 runs at lr 0 and changes nothing): AdamW's step is m / sqrt(v),
about +-lr for every entry whatever its gradient's size, so an entry whose
gradient is fp32 rounding noise has an update of noise sign. Entries whose
gradient is at least 1e-2 of the leaf's largest in both steps are held to
1e-3 x lr; every entry is held to 2.5 x lr, the most two updates of
m / sqrt(v) <= 1.1 can differ by.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from parler_tts_tpu.models.parler import ParlerTTS as JParler
from parler_tts_tpu.ops import losses as jl
from parler_tts_tpu.ops.masks import dense_self_attention_bias as jax_dense_bias
from parler_tts_tpu.training import Batch as JBatch
from parler_tts_tpu.training import TrainState as JState
from parler_tts_tpu.training import make_optimizer as jax_optimizer
from parler_tts_tpu.training import make_train_step as jax_train_step
from parler_tts_tpu_torch.convert import load_jax_params, to_jax_tree
from parler_tts_tpu_torch.models.layers import bernoulli, dropout, fold_in
from parler_tts_tpu_torch.models.parler import ParlerTTS
from parler_tts_tpu_torch.ops import losses as tl
from parler_tts_tpu_torch.ops.masks import dense_self_attention_bias
from parler_tts_tpu_torch.training import Batch, TrainState, make_optimizer, make_train_step
from test_torch_models import host, port_config
from test_training_step import PAD, BOS, tiny_config

LR = 1e-3
GRAD_TOL = 1e-4


def no_dropout(cfg, **decoder):
    return dataclasses.replace(
        cfg, decoder=dataclasses.replace(cfg.decoder, dropout=0.0, **decoder))


CFG = no_dropout(tiny_config())


def batch_np(b=4, s_desc=9, s_p=5, t=12, k=4, seed=0):
    """Description right-padded and prompt left-padded in row 1, a -100 tail."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, PAD, size=(b, t, k)).astype(np.int32)
    labels[:, -2:, :] = -100
    labels[0, -4:, :] = -100
    desc_mask = np.ones((b, s_desc), np.int32)
    desc_mask[1, -3:] = 0
    prompt_mask = np.ones((b, s_p), np.int32)
    prompt_mask[1, :2] = 0
    return (rng.integers(0, 120, size=(b, s_desc)).astype(np.int32), desc_mask,
            rng.integers(0, 256, size=(b, s_p)).astype(np.int32), prompt_mask, labels)


def jax_init(cfg=CFG, seed=0, **kw):
    model = JParler(cfg, **kw)
    params = model.init(
        jax.random.key(seed),
        jnp.zeros((1, 4), jnp.int32), jnp.ones((1, 4), jnp.int32),
        jnp.zeros((1, 3), jnp.int32), jnp.ones((1, 3), jnp.int32),
        jnp.zeros((1, 2, cfg.decoder.num_codebooks), jnp.int32),
    )["params"]
    return model, params


def port_model(params, cfg=CFG, **kw):
    model = ParlerTTS(port_config(cfg), **kw)
    load_jax_params(model, host(params))
    return model


def flat(tree, prefix=""):
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(flat(value, f"{prefix}{key}/"))
        else:
            out[prefix + key] = np.asarray(value)
    return out


def norm_rel(got, want):
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


# ----------------------------------------------------------- exact pieces
def test_dense_self_attention_bias_is_exact():
    mask = np.ones((3, 11), np.int32)
    mask[1, :4] = 0
    mask[2, 7:] = 0
    got = dense_self_attention_bias(torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_dense_bias(jnp.asarray(mask))))


def test_shift_tokens_right_is_exact():
    labels = batch_np()[-1]
    got = tl.shift_tokens_right(torch.from_numpy(labels), PAD, BOS).numpy()
    np.testing.assert_array_equal(got, np.asarray(jl.shift_tokens_right(jnp.asarray(labels),
                                                                        PAD, BOS)))


# ----------------------------------------------------------------- losses
@pytest.mark.parametrize("weights", [None, (1.0, 2.0, 0.5, 1.5)])
def test_losses_match_jax(weights):
    rng = np.random.default_rng(1)
    b, k, t, v, d = 3, 4, 13, 100, 16
    labels = batch_np(b=b, t=t)[-1]
    labels[0, 3, 1] = BOS
    dec_ids = rng.integers(0, 100, size=(b, k, t)).astype(np.int32)
    dec_ids[1, 2, 5:] = PAD  # inputs at EOS are dropped
    hidden = rng.normal(size=(b, t, d)).astype(np.float32)
    heads = (rng.normal(size=(k, d, v)) * 0.3).astype(np.float32)
    logits = np.einsum("btd,kdv->bktv", hidden, heads)
    kw = dict(bos_token_id=BOS, eos_token_id=PAD, codebook_weights=weights)
    tt = [torch.from_numpy(x) for x in (logits, labels, dec_ids)]
    jj = [jnp.asarray(x) for x in (logits, labels, dec_ids)]
    for got, want in zip(tl.per_codebook_cross_entropy(*tt, **kw),
                         jl.per_codebook_cross_entropy(*jj, **kw)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    for got, want in zip(tl.mean_loss_reference_style(*tt, **kw),
                         jl.mean_loss_reference_style(*jj, **kw)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    chunked = tl.chunked_per_codebook_cross_entropy(
        torch.from_numpy(hidden), torch.from_numpy(heads), *tt[1:], chunk_size=5, **kw)
    want = jl.chunked_per_codebook_cross_entropy(
        jnp.asarray(hidden), jnp.asarray(heads), *jj[1:], chunk_size=5, **kw)
    for got, w in zip(chunked, want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


def test_chunked_loss_gradient_matches_unchunked():
    rng = np.random.default_rng(2)
    hidden = torch.from_numpy(rng.normal(size=(2, 11, 16)).astype(np.float32))
    heads = torch.from_numpy((rng.normal(size=(4, 16, 100)) * 0.3).astype(np.float32))
    labels = torch.from_numpy(batch_np(b=2, t=11)[-1])
    dec_ids = tl.shift_tokens_right(labels, PAD, BOS)
    kw = dict(bos_token_id=BOS, eos_token_id=PAD)
    grads = []
    for chunked in (False, True):
        h, w = hidden.clone().requires_grad_(True), heads.clone().requires_grad_(True)
        if chunked:
            loss = tl.chunked_per_codebook_cross_entropy(h, w, labels, dec_ids, chunk_size=4,
                                                         **kw)[0]
        else:
            loss = tl.per_codebook_cross_entropy(torch.einsum("btd,kdv->bktv", h, w), labels,
                                                 dec_ids, **kw)[0]
        loss.backward()
        grads.append((h.grad, w.grad))
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=1e-5)


# ------------------------------------------------------ teacher-forced logits
@pytest.mark.parametrize("route", [False, True, 6, "pallas"],
                         ids=["dense", "chunked", "chunked6", "k4"])
def test_teacher_forced_logits_match_jax(route):
    jm, params = jax_init(seed=1, use_chunked_attention=route)
    arrays = batch_np(seed=3)
    want, want_ids = jm.apply({"params": params}, *map(jnp.asarray, arrays))
    port = port_model(params, use_chunked_attention=route)
    with torch.no_grad():
        got, got_ids = port(*map(torch.from_numpy, arrays))
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want_ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=2e-4)
    with torch.no_grad():
        hidden, _ = port(*map(torch.from_numpy, arrays), return_hidden=True)
    np.testing.assert_allclose(port.decoder.logits(hidden).numpy(), got.numpy(), atol=1e-6)


@pytest.mark.parametrize("route", [False, "pallas"], ids=["dense", "k4"])
def test_bf16_compute_with_fp32_params_matches_jax(route):
    """The recipe's dtype: fp32 parameters (loaded as they are) under bf16
    compute. The teacher-forced logits lie as close to the JAX package's
    bf16 model as half of JAX's own bf16-vs-fp32 gap, as in
    `test_torch_models_bf16.py`."""
    jm32, params = jax_init(seed=15, use_chunked_attention=route)
    jm16 = JParler(CFG, dtype=jnp.bfloat16, use_chunked_attention=route)
    arrays = batch_np(seed=16)
    want32 = np.asarray(jm32.apply({"params": params}, *map(jnp.asarray, arrays))[0])
    want16 = np.asarray(jm16.apply({"params": params}, *map(jnp.asarray, arrays))[0])
    port = port_model(params, dtype=torch.bfloat16, param_dtype=torch.float32,
                      use_chunked_attention=route)
    assert all(p.dtype == torch.float32 for p in port.parameters())
    got_params = flat(to_jax_tree(port.named_parameters()))
    for name, p0 in flat(host(params)).items():
        np.testing.assert_array_equal(got_params[name], p0, err_msg=name)
    with torch.no_grad():
        got = port(*map(torch.from_numpy, arrays))[0]
    assert got.dtype == torch.float32
    jax_gap = norm_rel(want16, want32)
    assert jax_gap > 1e-3
    assert norm_rel(got.numpy(), want16) <= 0.5 * jax_gap


def test_forward_rejects_too_long_and_missing_key():
    port = ParlerTTS(port_config(CFG))
    arrays = [torch.from_numpy(x) for x in batch_np(t=124)]
    with pytest.raises(ValueError, match="max_position_embeddings"):
        port(*arrays)
    with pytest.raises(ValueError, match="dropout_key"):
        port(*arrays[:4], arrays[4][:, :4], deterministic=False)


# --------------------------------------------------------------- train step
def jax_loss_fn(model, cfg=CFG):
    dcfg = cfg.decoder

    def loss(params, batch, rng):
        logits, dec_ids = model.apply({"params": params}, *batch, deterministic=False,
                                      rngs={"dropout": rng})
        sum_loss, n, _, _ = jl.per_codebook_cross_entropy(
            logits, batch.labels, dec_ids, bos_token_id=dcfg.bos_token_id,
            eos_token_id=dcfg.eos_token_id, codebook_weights=dcfg.codebook_weights)
        return sum_loss / dcfg.num_codebooks / jnp.maximum(n, 1.0)

    return jax.jit(jax.grad(loss))


def port_grads(model):
    return flat(to_jax_tree((n, p.grad) for n, p in model.named_parameters()))


def two_steps_match_jax(seed, batches, route=False, **opt):
    """Two `make_train_step` steps of the port beside the JAX package's, one
    batch each: loss, metrics and every gradient leaf at each step, then the
    params after both (the rule of the module docstring). Returns the
    trained gradient norms of the two steps."""
    jm, params = jax_init(seed=seed, use_chunked_attention=route)
    before = flat(host(params))  # the JAX step donates its state
    jtx = jax_optimizer(learning_rate=LR, **opt)
    jstate = JState.create(params, jtx)
    jstep = jax_train_step(jm, jtx)
    jgrad = jax_loss_fn(jm)
    port = port_model(params, use_chunked_attention=route)
    tx = make_optimizer(learning_rate=LR, **opt)
    state = TrainState.create(port, tx)
    step = make_train_step(port, tx)
    frozen = {n: p.detach().clone() for n, p in port.named_parameters()
              if n.startswith("text_encoder.")}

    grads, trained_norms = [], []
    for i, arrays in enumerate(batches):
        jbatch = JBatch(*map(jnp.asarray, arrays))
        want_grads = flat(host(jgrad(jstate.params, jbatch, jax.random.key(0))))
        jstate, jm_metrics = jstep(jstate, jbatch, jax.random.key(0))
        state, metrics = step(state, Batch(*map(torch.from_numpy, arrays)), 100 + i)
        got_grads = port_grads(port)
        assert got_grads.keys() == want_grads.keys()
        for name, want in want_grads.items():
            assert norm_rel(got_grads[name], want) <= GRAD_TOL, name
        # the text encoder's gradients are in the metric, and are not zero
        assert np.linalg.norm(got_grads["text_encoder/block_0/attention/q/kernel"]) > 0
        np.testing.assert_allclose(float(metrics["loss"]), float(jm_metrics["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(metrics["grad_norm"]), float(jm_metrics["grad_norm"]),
                                   rtol=1e-5)
        assert int(metrics["num_items"]) == int(jm_metrics["num_items"])
        np.testing.assert_allclose(metrics["per_codebook_loss"].numpy(),
                                   np.asarray(jm_metrics["per_codebook_loss"]), rtol=1e-5)
        grads.append(want_grads)
        trained_norms.append(np.sqrt(sum(np.sum(g.astype(np.float64) ** 2)
                                         for n, g in want_grads.items()
                                         if not n.startswith("text_encoder/"))))
        if i == 0 and opt.get("warmup_steps"):  # lr 0 at step 1: nothing moves
            after_one = flat(to_jax_tree(port.named_parameters()))
            for name, p0 in before.items():
                np.testing.assert_array_equal(after_one[name], p0, err_msg=name)
    assert state.step == 2 and state.opt_state.count == 2
    for name, p in port.named_parameters():
        if name in frozen:
            assert torch.equal(p.detach(), frozen[name]), name
    got = flat(to_jax_tree(port.named_parameters()))
    want = flat(host(jstate.params))
    moved = held = total = 0
    for name, w in want.items():
        diff = np.abs(got[name] - w)
        assert diff.max() <= 2.5 * LR, name
        g1, g2 = np.abs(grads[0][name]), np.abs(grads[1][name])
        sure = (g1 >= 1e-2 * g1.max()) & (g2 >= 1e-2 * g2.max())
        if not name.startswith("text_encoder/"):
            assert diff[sure].max(initial=0.0) <= 1e-3 * LR, name
            moved += int((got[name] != before[name]).sum())
            held, total = held + int(sure.sum()), total + sure.size
    assert held > 0.3 * total and moved > 0.9 * total, (held, moved, total)
    return trained_norms


@pytest.mark.parametrize("route", [False, "pallas"], ids=["dense", "k4"])
def test_train_step_matches_jax(route):
    two_steps_match_jax(2, [batch_np(seed=3), batch_np(seed=4)], route, warmup_steps=1)


def test_step_one_at_warmup_changes_nothing():
    _, params = jax_init(seed=5)
    port = port_model(params)
    tx = make_optimizer(learning_rate=LR, warmup_steps=4, schedule="cosine", total_steps=9)
    state = TrainState.create(port, tx)
    before = {n: p.detach().clone() for n, p in port.named_parameters()}
    state, metrics = make_train_step(port, tx)(state, Batch(*map(torch.from_numpy, batch_np())),
                                               0)
    assert np.isfinite(float(metrics["loss"]))
    for name, p in port.named_parameters():
        assert torch.equal(p.detach(), before[name]), name


@pytest.mark.parametrize("schedule", ["constant_with_warmup", "cosine", "linear"])
def test_schedules_match_optax(schedule):
    sch = optax.schedules
    warm = sch.linear_schedule(0.0, 2e-3, 3)
    want = {
        "constant_with_warmup": sch.join_schedules([warm, sch.constant_schedule(2e-3)], [3]),
        "cosine": sch.warmup_cosine_decay_schedule(0.0, 2e-3, 3, 10),
        "linear": sch.join_schedules([warm, sch.linear_schedule(2e-3, 0.0, 7)], [3]),
    }[schedule]
    tx = make_optimizer(learning_rate=2e-3, schedule=schedule, warmup_steps=3, total_steps=10)
    for count in range(13):
        np.testing.assert_allclose(tx.learning_rate(count), float(want(count)), rtol=1e-6,
                                   atol=1e-12)


def test_clipped_step_matches_jax():
    """max_grad_norm below the trained gradients' norm in both of two steps,
    whose batches differ in size, so the two clip factors differ: the second
    update m / sqrt(v) mixes the steps' clipped gradients in their ratio, and
    a port that left the clip out would move the params by about lr there."""
    norms = two_steps_match_jax(6, [batch_np(b=4, seed=7), batch_np(b=2, seed=8)],
                                warmup_steps=0, max_grad_norm=0.01, weight_decay=0.5)
    assert min(norms) > 0.01 and abs(norms[0] / norms[1] - 1) > 0.1, norms


def test_optimizer_update_matches_optax():
    """The optimizer alone, on gradients drawn from a seed, against the JAX
    package's optax chain: two updates at lr 1 (updates of order 1, so fp32
    rounding of the params stays near 1e-7), both clipped, the text
    encoder's gradients large in the first and tiny in the second. A clip
    over the whole tree, torch's max_norm / (norm + 1e-6) form or no clip
    each fail these limits."""
    rng = np.random.default_rng(17)
    _, params = jax_init(seed=18)
    tree = host(params)
    jtx = jax_optimizer(learning_rate=1.0, warmup_steps=0, max_grad_norm=1e-4, weight_decay=0.5)
    jopt = jtx.init(params)
    port = port_model(params)
    tx = make_optimizer(learning_rate=1.0, warmup_steps=0, max_grad_norm=1e-4, weight_decay=0.5)
    state = TrainState.create(port, tx)
    jparams = params
    for trained_scale, encoder_scale in ((1e-3, 3e-2), (6e-3, 1e-7)):
        leaves = flat(tree)
        draw = {name: rng.normal(size=x.shape).astype(np.float32) for name, x in leaves.items()}
        size = sum(x.size for n, x in draw.items() if not n.startswith("text_encoder/"))
        grads = {}
        for name, g in draw.items():
            scale = encoder_scale if name.startswith("text_encoder/") else trained_scale
            node = grads
            *path, leaf = name.split("/")
            for key in path:
                node = node.setdefault(key, {})
            node[leaf] = g * np.float32(scale / size ** 0.5)
        updates, jopt = jtx.update(jax.tree.map(jnp.asarray, grads), jopt, jparams)
        jparams = optax.apply_updates(jparams, updates)
        holder = port_model(grads)
        tx.update(port, dict(holder.named_parameters()), state.opt_state)
        got, want = flat(to_jax_tree(port.named_parameters())), flat(host(jparams))
        for name, w in want.items():
            np.testing.assert_allclose(got[name], w, atol=2e-6, rtol=1e-6, err_msg=name)


def test_chunked_loss_train_step_matches_unchunked():
    _, params = jax_init(seed=8)
    arrays = batch_np(seed=9)
    results = []
    for chunk in (None, 5):
        port = port_model(params)
        tx = make_optimizer(learning_rate=LR, warmup_steps=0)
        state = TrainState.create(port, tx)
        _, met = make_train_step(port, tx, loss_chunk_size=chunk)(
            state, Batch(*map(torch.from_numpy, arrays)), 0)
        results.append((met, port_grads(port)))
    (m1, g1), (m2, g2) = results
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]), rtol=1e-5)
    for name in g1:
        assert norm_rel(g2[name], g1[name]) <= 1e-5, name


def test_microbatch_equals_full_batch():
    _, params = jax_init(seed=10)
    arrays = batch_np(b=4, seed=11)
    results = []
    for g in (None, 2):
        port = port_model(params)
        tx = make_optimizer(learning_rate=LR, warmup_steps=0)
        state = TrainState.create(port, tx)
        _, met = make_train_step(port, tx, microbatch_steps=g)(
            state, Batch(*map(torch.from_numpy, arrays)), 0)
        results.append((met, port_grads(port), flat(to_jax_tree(port.named_parameters()))))
    (m1, g1, p1), (m2, g2, p2) = results
    for key in ("loss", "grad_norm", "per_codebook_loss"):
        np.testing.assert_allclose(np.asarray(m1[key]), np.asarray(m2[key]), rtol=1e-5)
    assert int(m1["num_items"]) == int(m2["num_items"])
    for name in g1:
        assert norm_rel(g2[name], g1[name]) <= 1e-5, name
        np.testing.assert_allclose(p2[name], p1[name], atol=2e-6)
    port = port_model(params)
    with pytest.raises(ValueError, match="not divisible"):
        tx = make_optimizer()
        make_train_step(port, tx, microbatch_steps=3)(
            TrainState.create(port, tx), Batch(*map(torch.from_numpy, arrays)), 0)


# ------------------------------------------------------ dropout and remat
@pytest.mark.parametrize("route", [False, "pallas"], ids=["dense", "k4"])
def test_remat_equals_no_remat_with_dropout(route):
    cfg = dataclasses.replace(
        tiny_config(),
        decoder=dataclasses.replace(tiny_config().decoder, dropout=0.2, activation_dropout=0.1,
                                    layerdrop=0.3),
        text_encoder=dataclasses.replace(tiny_config().text_encoder, dropout_rate=0.1))
    _, params = jax_init(cfg, seed=12)
    arrays = batch_np(seed=13)
    results = []
    for remat in (False, True):
        port = port_model(params, cfg, use_chunked_attention=route, remat_layers=remat)
        tx = make_optimizer(learning_rate=LR, warmup_steps=0)
        state = TrainState.create(port, tx)
        _, met = make_train_step(port, tx)(state, Batch(*map(torch.from_numpy, arrays)), 77)
        results.append((float(met["loss"]), port_grads(port)))
    (l1, g1), (l2, g2) = results
    assert l1 == l2
    for name in g1:
        np.testing.assert_allclose(g2[name], g1[name], atol=1e-7, rtol=1e-6, err_msg=name)
    # the dropout did draw: another seed gives another loss
    port = port_model(params, cfg, use_chunked_attention=route)
    with torch.no_grad():
        a = port(*map(torch.from_numpy, arrays), deterministic=False, dropout_key=1)[0]
        b = port(*map(torch.from_numpy, arrays), deterministic=False, dropout_key=2)[0]
        c = port(*map(torch.from_numpy, arrays), deterministic=False, dropout_key=1)[0]
    assert torch.equal(a, c) and not torch.equal(a, b)


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_statistics(rate):
    x = torch.ones(200_000) * 3.0
    y = dropout(x, rate, 11)
    kept = y != 0
    n = x.numel()
    assert abs((~kept).float().mean().item() - rate) < 5 * (rate * (1 - rate) / n) ** 0.5
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 3.0 / (1 - rate)))
    assert torch.equal(dropout(x, rate, 11), y)          # same key, same mask
    assert not torch.equal(dropout(x, rate, 12), y)      # another key, another mask
    assert dropout(x, rate, None) is x and dropout(x, 0.0, 11) is x
    assert not dropout(x, 1.0, 11).any()


def test_layerdrop_statistics():
    p, n = 0.3, 4000
    drops = torch.stack([bernoulli(p, fold_in(5, "layerdrop", i), "cpu") for i in range(n)])
    assert abs(drops.float().mean().item() - p) < 5 * (p * (1 - p) / n) ** 0.5
    assert fold_in(None, 1) is None and fold_in(5, 1) == fold_in(5, 1) != fold_in(5, 2)


def test_layerdrop_is_a_select():
    """With LayerDrop 1 every layer keeps its input: the decoder returns the
    final norm of the embeddings (plus positions)."""
    cfg = dataclasses.replace(CFG, decoder=dataclasses.replace(CFG.decoder, layerdrop=1.0))
    _, params = jax_init(cfg, seed=14)
    port = port_model(params, cfg)
    dec = port.decoder.decoder
    x = torch.randn(2, 7, 64)
    pos = torch.arange(7)[None].expand(2, 7)
    with torch.no_grad():
        got = dec(x, pos, self_attn_bias=None, cross_attn_bias=None, dropout_key=3)
        want = dec.layer_norm(x + dec.positions[pos])
    torch.testing.assert_close(got, want)


# ------------------------------------------------- item 21b: dots and mu_dtype
def test_remat_dots_gradients_match_jax_and_full_remat():
    """remat_policy="dots" (the matrix products' outputs kept, the rest
    recomputed) on the chunked route: every gradient leaf within 1e-4 of the
    JAX package's "dots" gradients, and of the port's full remat to 1e-6."""
    jm, params = jax_init(seed=21, use_chunked_attention=True, remat_layers=True,
                          remat_policy="dots")
    arrays = batch_np(seed=22)
    want = flat(host(jax_loss_fn(jm)(params, JBatch(*map(jnp.asarray, arrays)),
                                     jax.random.key(0))))
    got = {}
    for policy in (None, "dots"):
        port = port_model(params, use_chunked_attention=True, remat_layers=True,
                          remat_policy=policy)
        tx = make_optimizer(learning_rate=0.0, warmup_steps=0)
        make_train_step(port, tx)(TrainState.create(port, tx),
                                  Batch(*map(torch.from_numpy, arrays)), 0)
        got[policy] = port_grads(port)
    assert got["dots"].keys() == want.keys()
    for name, w in want.items():
        assert norm_rel(got["dots"][name], w) <= GRAD_TOL, name
        assert norm_rel(got["dots"][name], got[None][name]) <= 1e-6, name


@pytest.mark.parametrize("route", [True, "pallas"], ids=["chunked", "k4"])
def test_remat_dots_keeps_the_matrix_products(route):
    """What the policy sees: a forward and backward under full remat runs
    each decoder layer's non-batched products (`aten.mm`) that the backward
    needs once more than under "dots", which keeps them; the batched products are recomputed
    under both. A policy that kept nothing, or that never saw the
    projections (`F.linear` on 3-D inputs reaches `aten.mm` through a
    view), would fail the first count."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops[func] = self.ops.get(func, 0) + 1
            return func(*args, **(kwargs or {}))

    _, params = jax_init(seed=23)
    arrays = batch_np(seed=24)
    counts = {}
    for policy in (None, "dots"):
        port = port_model(params, use_chunked_attention=route, remat_layers=True,
                          remat_policy=policy)
        port.requires_grad_(True)
        with Count() as mode:
            logits, _ = port(*map(torch.from_numpy, arrays))
            logits.sum().backward()
        counts[policy] = mode.ops
    mm = torch.ops.aten.mm.default
    layers = CFG.decoder.num_hidden_layers
    # q, k, v, out, cross q, cross out and fc1 are recomputed under full
    # remat; fc2's output is not, as nothing in the backward reads it (the
    # recompute stops once it has what the backward needs)
    assert counts[None][mm] - counts["dots"][mm] == 7 * layers, (counts[None][mm],
                                                                counts["dots"][mm])
    bmm = torch.ops.aten.bmm.default
    assert counts[None].get(bmm, 0) == counts["dots"].get(bmm, 0)


def test_mu_dtype_bfloat16_matches_optax():
    """make_optimizer(mu_dtype=torch.bfloat16) against optax's
    `adamw(mu_dtype=jnp.bfloat16)` over 3 updates of gradients drawn from a
    seed (lr 1e-2, warmup 0, the trained leaves clipped in step 2): the
    first moments stay bf16 and equal optax's bit for bit but at rounding
    ties (at most 1e-3 of a leaf's entries, each within one bf16 unit in
    the last place), the second moments within 1e-6, the params within 1e-6
    (relative) + 1e-5 x lr but at those ties (at most 1e-3 of the entries,
    each within 1e-2 x lr: a first moment one bf16 unit off moves its
    entry's update by up to 2^-8 of m / sqrt(v) x lr a step). Rounding b1 x mu with an fp32 b1, or keeping mu in
    fp32 and rounding only the stored copy, fails these."""
    rng = np.random.default_rng(25)
    _, params = jax_init(seed=26)
    kw = dict(learning_rate=1e-2, warmup_steps=0, max_grad_norm=0.5, weight_decay=0.1)
    jtx = jax_optimizer(mu_dtype=jnp.bfloat16, **kw)
    jopt = jtx.init(params)
    port = port_model(params)
    tx = make_optimizer(mu_dtype=torch.bfloat16, **kw)
    state = TrainState.create(port, tx)
    assert all(m.dtype == torch.bfloat16 for m in state.opt_state.mu.values())
    assert all(v.dtype == torch.float32 for v in state.opt_state.nu.values())
    jparams = params
    for scale in (0.05, 3.0, 0.2):
        grads = jax.tree.map(lambda x: (rng.normal(size=x.shape) * scale / x.size ** 0.5)
                             .astype(np.float32), host(params))
        updates, jopt = jtx.update(jax.tree.map(jnp.asarray, grads), jopt, jparams)
        jparams = optax.apply_updates(jparams, updates)
        tx.update(port, dict(port_model(grads).named_parameters()), state.opt_state)
    adam = jopt.inner_states["train"].inner_state[1][0]
    for moment, got_state in (("mu", state.opt_state.mu), ("nu", state.opt_state.nu)):
        want = flat(host(getattr(adam, moment)))
        got = flat(to_jax_tree(got_state.items()))
        for name, g in got.items():
            w = want[name].astype(np.float32)
            if moment == "mu":
                assert getattr(adam, moment)["decoder"]["lm_heads"].dtype == jnp.bfloat16
                # the clip factors differ in fp32's last place (norms summed
                # in another order), which can tip a bf16 rounding tie
                off = g != w
                assert off.mean() <= 1e-3, name
                np.testing.assert_allclose(g[off], w[off], rtol=2.0 ** -7, err_msg=name)
            else:
                np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-12, err_msg=name)
    got, want = flat(to_jax_tree(port.named_parameters())), flat(host(jparams))
    for name, w in want.items():
        diff, lr = np.abs(got[name] - w), kw["learning_rate"]
        assert diff.max() <= 1e-2 * lr, name
        assert (diff > 1e-6 * np.abs(w) + 1e-5 * lr).mean() <= 1e-3, name
